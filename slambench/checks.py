"""How a run's `correct` is decided: what the window produced, judged
against the plain reference (slambench/reference/) and the configuration's
guarantees, each number beside its limit.

Numbers, each the widest over the samples the window kept (harness.Capture):
- sp_logp_gap: |log of the score the program gave a keypoint - log of the
  reference's detector probability at that pixel| (both floored at the
  score threshold), over the valid keypoints of sampled frames, and the log
  of the reference's peak over the threshold at a keypoint the program
  marked invalid.
- sp_desc_gap: |program descriptor - the reference's descriptor sampled at
  the program's keypoint| (L2, unit descriptors).
- lg_gap: for each match i -> j the program's LightGlue made, how far the
  reference's log-assignment at (i, j) lies below the reference's best in
  row i (nats), on the same keypoints and descriptors.
- nn_gap: for each row of a sampled B2 reduce, how far the reference's
  distance at the program's argmin lies above the reference's least
  distance, or the program's best distance from the reference's there,
  whichever is larger (squared L2 of unit descriptors), on the same inputs.
Guarantees the configuration states: tracked_share (frames of the window
logged OK), loops_in_window (>= loops_min, where that is above 0), ate_cm
(window frames' camera centres against the ground truth, Sim3-aligned for a
monocular configuration, SE3 for a metric one). A traffic's "guarantees"
(loops_min, loops_max) take the place of the configuration's loop count
(harness.route_guarantees); loops_max adds loops_total_max, the loops closed
since the run's system started, warm-up frames included (<= loops_max): a
route that never revisits must close no loop at all.

Judges a configuration names: each name in its "checks" is a module
slambench/judges/<name>.py whose judge(cfg, scene, cap, trees, dev,
outcome, control) returns (numbers, control readings), each {number:
value}, the second empty unless control. Each number is held <= the
configuration's limits[number]; a number without a limit there fails the
run (KeyError), with no default.

A number with no sample to read is None, and fails.
"""
from __future__ import annotations

import importlib
import math

import torch

from slambench.reference import matching as ref_nn
from slambench.reference.lightglue import LightGlueRef, extract_matches, normalize_keypoints
from slambench.reference.superpoint import SuperPointRef, extract, sample_descriptors
from slambench.reference.trajectory import ate


def _max(vals):
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def sp_readings(out: dict, prob: torch.Tensor, dc: torch.Tensor, nms: torch.Tensor,
                threshold: float) -> dict:
    """One frame's SuperPoint numbers: out holds keypoints [K,2], scores,
    descriptors, valid of the side judged; prob, dc the reference's dense
    outputs, nms its score map after NMS; threshold the detector's score
    threshold."""
    v = out["valid"].bool()
    k = out["keypoints"][v].float()
    if not len(k):
        return {"sp_logp_gap": math.inf, "sp_desc_gap": math.inf}
    x, y = k[:, 0].long(), k[:, 1].long()

    def log_p(p):
        return torch.log(torch.clamp(p.float(), min=threshold))

    score_gap = (log_p(out["scores"][v]) - log_p(prob[y, x])).abs().max().item()
    kx = out["keypoints"][~v].long()
    if len(kx):   # a keypoint marked invalid where the reference has a peak over the threshold
        over = (log_p(nms[kx[:, 1], kx[:, 0]]) - math.log(threshold)).max().item()
        score_gap = max(score_gap, over)
    desc_gap = torch.linalg.norm(out["descriptors"][v].float() - sample_descriptors(dc, k),
                                 dim=-1).max().item()
    return {"sp_logp_gap": score_gap, "sp_desc_gap": desc_gap}


def lg_gap(la: torch.Tensor, matches: torch.Tensor, v1: torch.Tensor):
    """The widest gap, over the rows a matcher matched, between the
    reference log-assignment's best in the row and its value at the match."""
    n1 = la.shape[2] - 1
    s = torch.where(v1[:, None, :], la[:, :-1, :n1], -math.inf)
    m = matches.long()
    sel = m >= 0
    if not sel.any():
        return 0.0
    at = torch.gather(s, 2, m.clamp(min=0)[..., None])[..., 0]
    return (s.max(dim=2).values - at)[sel].max().item()


def nn_gap(d: torch.Tensor, best: torch.Tensor, idx: torch.Tensor, valid1: torch.Tensor):
    """The widest of the argmin's excess over the least distance and the
    reported best distance's error, over the rows of one reduce."""
    if not valid1.any():
        return 0.0
    at = torch.gather(d, 1, idx.long()[:, None])[:, 0]
    gap = at - d.min(dim=1).values
    err = (best.float() - at).abs()
    return max(gap.max().item(), err.max().item())


def judge(cfg: dict, scene, cap, trees: dict, dev, outcome: dict,
          control: bool = False) -> dict:
    """{"checks": {name: value, limit, op, ok}, "control": readings of the
    lower-precision control on the same samples (with control=True)}. cfg:
    the configuration as the cell runs it (harness.Cell.config)."""
    lim, g = cfg["limits"], cfg["guarantees"]
    checks, ctl = {}, {}

    def add(name, value, limit, op):
        ok = value is not None and math.isfinite(value) and (
            value <= limit if op == "<=" else value >= limit)
        checks[name] = {"value": value, "limit": limit, "op": op, "ok": bool(ok)}

    states = outcome["states_ok"]
    add("tracked_share", sum(states) / max(len(states), 1), g["tracked_min"], ">=")
    if g.get("loops_min", 0) > 0:
        add("loops_in_window", outcome["n_loops"], g["loops_min"], ">=")
    if "loops_max" in g:
        add("loops_total_max", outcome["loops_total"], g["loops_max"], "<=")
    if len(outcome["est"]) >= 3:
        ate_m, _ = ate(outcome["est"], outcome["gt"], with_scale=g["ate_alignment"] == "sim3")
        ate_cm = ate_m * 100.0
    else:
        ate_cm = None
    add("ate_cm", ate_cm, g["ate_cm_max"], "<=")

    low = cfg["control"]["precision"]
    sp_cfg, lg_cfg = cfg["superpoint"], cfg["lightglue"]
    kw = dict(max_keypoints=sp_cfg["max_keypoints"], nms_radius=sp_cfg["nms_radius"],
              score_threshold=sp_cfg["score_threshold"])
    with torch.no_grad():
        sp = SuperPointRef(trees["superpoint"], dev)
        sp_c = SuperPointRef(trees["superpoint"], dev, low) if control else None
        reads, reads_c = [], []
        for s in cap.samples["superpoint"]:
            prob, dc = sp.dense(s["image"])
            nms = extract(prob, dc, **kw)["nms"]
            thr = sp_cfg["score_threshold"]
            reads.append(sp_readings(s, prob, dc, nms, thr))
            if control:
                reads_c.append(sp_readings(extract(*sp_c.dense(s["image"]), **kw), prob, dc, nms,
                                           thr))
        for k in ("sp_logp_gap", "sp_desc_gap"):
            add(k, _max(r[k] for r in reads), lim[k], "<=")
            if control:
                ctl[k] = _max(r[k] for r in reads_c)
        del sp, sp_c

        hw = tuple(scene.image_hw)
        lg = LightGlueRef(trees["lightglue"], lg_cfg["layers"], dev, heads=lg_cfg["heads"])
        lg_c = (LightGlueRef(trees["lightglue"], lg_cfg["layers"], dev, heads=lg_cfg["heads"],
                             precision=low) if control else None)
        gaps, gaps_c = [], []
        for s in cap.samples["lightglue"]:
            k0, d0, v0, k1, d1, v1 = s["args"]
            inp = (normalize_keypoints(k0, hw), d0, v0.bool(), normalize_keypoints(k1, hw), d1,
                   v1.bool())
            la = lg.log_assignment(*inp)
            thr = lg_cfg["threshold"]
            gaps.append(lg_gap(la, s["matches"], v1.bool()))
            if control:
                m_c = extract_matches(lg_c.log_assignment(*inp), v0.bool(), v1.bool(), thr)
                gaps_c.append(lg_gap(la, m_c, v1.bool()))
        add("lg_gap", _max(gaps), lim["lg_gap"], "<=")
        if control:
            ctl["lg_gap"] = _max(gaps_c)
        del lg, lg_c

        gaps, gaps_c = [], []
        for s in cap.samples["nn"]:
            d = ref_nn.distances(s["desc0"].float(), s["desc1"].float(), s["valid1"].bool())
            gaps.append(nn_gap(d, s["best"], s["idx"], s["valid1"].bool()))
            if control:
                best_c, idx_c = ref_nn.reduce(s["desc0"], s["desc1"], s["valid1"].bool(), low)
                gaps_c.append(nn_gap(d, best_c, idx_c, s["valid1"].bool()))
            del d
        add("nn_gap", _max(gaps), lim["nn_gap"], "<=")
        if control:
            ctl["nn_gap"] = _max(gaps_c)

    for name in cfg.get("checks", []):
        numbers, readings_c = importlib.import_module(f"slambench.judges.{name}").judge(
            cfg, scene, cap, trees, dev, outcome, control)
        for k, v in numbers.items():
            if k in checks:
                raise ValueError(f"slambench: judge {name!r} reports {k!r}, which another "
                                 f"check reports")
            if k not in lim:
                raise KeyError(f"slambench: judge {name!r} reports {k!r}, for which the "
                               f"configuration {cfg['name']!r} gives no limit")
            add(k, v, lim[k], "<=")
        if control:
            ctl.update(readings_c)

    return {"checks": checks, "control": ctl}
