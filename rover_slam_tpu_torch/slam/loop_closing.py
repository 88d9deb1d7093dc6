"""Loop closing: place recognition -> Sim3 verification -> graph correction,
and the cross-map merge.

Counterpart of rover_slam_tpu/slam/loop_closing.py. The device programs are
plain functions on tensors; the decision logic (gates, temporal consistency,
the freshest-ready-first queues) is host code on small packs that ride to the
host as non-blocking copies (`HostCopy`) and are read once they have landed.

Where the JAX package branches on a device value with `lax.cond`, the port
either branches on a value the host already holds (the candidate ids) or
computes both sides and selects with `torch.where` (a seed's success), so a
branch costs no host sync. The RANSAC draws come from a torch.Generator
seeded like the JAX package's PRNGKey; the parity tests hand in the JAX
package's own draws (`samples`). With `use_4dof` (set by the inertial
system) loop corrections run the 4-DoF pose graph. With `bf` (set by the
stereo systems) the welding and global BAs carry the stereo residual rows.
With a mesh the post-loop global BA runs landmark-sharded over it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry import cameras, lie
from ..map import keyframe_database as kdb
from ..map import maintenance
from ..map import map_state as ms
from ..ops import association as assoc
from ..ops import scatterless
from ..optim import pose_graph, sim3_solver
from ..utils import profiling
from .host_copy import HostCopy
from .tracking import _local_ba_body


@dataclass
class LoopConfig:
    """The JAX package's LoopConfig, same fields and defaults (its comments
    give the measurements behind each)."""
    cam_kind: int = cameras.PINHOLE
    n_candidates: int = 4
    min_bow_matches: int = 20
    min_sim3_inliers: int = 8
    seed_chi2_px: float = 36.0
    min_sim3_proj: int = 40
    guided_radius: float = 16.0
    sim3_gn_iters: int = 8
    learned_verify_matches: bool = False
    min_recent_kfs_gap: int = 10
    min_recent_time_s: float = 3.0
    min_covis_weight: int = 30
    connected_min_weight: int = 15
    min_score_ratio: float = 1.0
    min_abs_score: float = 0.0
    pose_graph_iters: int = 15
    fix_scale: bool = False
    run_gba: bool = True
    gba_iters: int = 10
    gba_chunk_iters: int = 1
    verify_top: int = 2
    post_fire_ban_kfs: int = 10
    consistency_needed: int = 2
    min_proj_verify: int = 25
    max_hyp_misses: int = 1
    strong_fire_proj: int = 80
    welding_ba_iters: int = 8
    welding_window: int = 6
    merge_pose_graph_iters: int = 12
    merge_rounds: int = 2


def _row(arr: torch.Tensor, i):
    """arr[i] for a host int or a 0-dim device index (index_select: a 0-dim
    CUDA index in [] would be read on the host)."""
    if isinstance(i, torch.Tensor):
        return arr.index_select(0, i.reshape(1).long())[0]
    return arr[i]


def _idx(i, dev) -> torch.Tensor:
    return torch.as_tensor(i, device=dev).reshape(1).long()


def _covis_row(state: ms.MapState, kf) -> torch.Tensor:
    """[K] int32 shared-landmark counts of keyframe kf, self zeroed."""
    obs = ms.observation_matrix(state)
    row = obs @ _row(obs, kf)
    return row.index_fill(0, _idx(kf, row.device), 0.0).to(torch.int32)


def _group_landmarks(state: ms.MapState, kf) -> torch.Tensor:
    """[L] active landmarks anchored in kf or a keyframe covisible with it."""
    group = (_covis_row(state, kf) > 0).index_fill(0, _idx(kf, state.device), True)
    anchor = state.lm_anchor_kf.long().clamp(0, state.K - 1)
    return state.lm_active & group[anchor]


def _detect_and_add_kernel(state: ms.MapState, db: kdb.KeyFrameDB, kf_id: int, n_best: int,
                           gap: int, recent_s: float = 3.0, connected_w: int = 15):
    """Per-keyframe place recognition: BoW transform, covisibility row,
    candidate gating, database insert. Returns (db, pack) with pack = [ids
    (n_best), scores (n_best), minscore] (minscore: the worst similarity of
    the query to its covisible neighbours, the retrieval floor)."""
    desc = state.kf_desc[kf_id].float()
    query_tf = kdb.bow_transform(db.vocab, desc, state.kf_kpt_valid[kf_id])
    W_row = _covis_row(state, kf_id)
    same_map = state.kf_map_id == state.kf_map_id[kf_id]
    recent = ((torch.arange(state.K, device=state.device) >= kf_id - gap)
              | (torch.abs(state.kf_time - state.kf_time[kf_id]) < recent_s))
    connected = (W_row >= connected_w) | (recent & same_map)
    ids, scores = kdb.detect_candidates(db, query_tf, kf_id, connected, n_best=n_best)
    covis_sims = kdb.bow_similarity(query_tf, db.tf)
    neigh = (W_row > 0) & db.active
    minscore = torch.min(torch.where(neigh, covis_sims, torch.inf))
    minscore = torch.where(torch.isfinite(minscore), minscore, 0.0)
    db2 = kdb.db_set(db, kf_id, query_tf)
    return db2, torch.cat([ids.float(), scores, minscore[None]])


def _pair_inputs(state: ms.MapState, kf_q: int, kf_c: int, ext_matches=None):
    """Full keypoint sets of two keyframes matched by mutual NN (kernel B2),
    unioned with learned matches when given: per pair the 3D points in each
    camera, both observations and which side carries a landmark.
    Returns (Xc, Xq, ok, uv_c, uv_q, has_c, has_q)."""
    L = state.L
    dq, dc = state.kf_desc[kf_q].float(), state.kf_desc[kf_c].float()
    vq, vc = state.kf_kpt_valid[kf_q], state.kf_kpt_valid[kf_c]
    matches, _ = assoc.mutual_nn_match(dq, vq, dc, vc)
    N = dq.shape[0]
    if ext_matches is not None:
        mc0 = ext_matches.long().clamp(0, N - 1)
        ext_ok = (ext_matches >= 0) & vq & vc[mc0]
        matches = torch.cat([matches, torch.where(ext_ok, ext_matches, -1).to(matches.dtype)])
    qi = torch.arange(matches.shape[0], device=state.device) % N
    m = matches.long().clamp(0, N - 1)
    ok = matches >= 0
    lq, lc = state.kf_landmark_idx[kf_q], state.kf_landmark_idx[kf_c]
    has_q = (vq & (lq >= 0))[qi] & ok
    has_c = (vc & (lc >= 0))[m] & ok
    Xq = lie.se3_apply(state.kf_R_cw[kf_q], state.kf_t_cw[kf_q],
                       state.lm_pos[lq[qi].long().clamp(0, L - 1)])
    Xc = lie.se3_apply(state.kf_R_cw[kf_c], state.kf_t_cw[kf_c],
                       state.lm_pos[lc[m].long().clamp(0, L - 1)])
    return Xc, Xq, ok, state.kf_kpts[kf_c][m], state.kf_kpts[kf_q][qi], has_c, has_q


def _sim3_between_kfs_body(state: ms.MapState, kf_q: int, kf_c: int, cam_params, generator,
                           cam_kind: int, fix_scale: bool, ext_matches=None,
                           chi2_px: float = 36.0, min_inliers: int = 8, samples=None):
    """Seed Sim3 S_qc (candidate camera -> query camera) of two keyframes by
    RANSAC over their full-set matches. Returns (Sim3Result, n_match)."""
    Xc, Xq, ok, uv_c, uv_q, has_c, has_q = _pair_inputs(state, kf_q, kf_c, ext_matches)
    res = sim3_solver.sim3_ransac(Xc, Xq, ok, uv_c, uv_q, cam_params, generator,
                                  fix_scale=fix_scale, cam_kind=cam_kind, chi2_px=chi2_px,
                                  min_inliers=min_inliers, has1=has_c, has2=has_q,
                                  samples=samples)
    return res, torch.sum(ok, dtype=torch.int32)


def _guided_refine_body(state: ms.MapState, kf_q, kf_c, s0, R0, t0, cam_params,
                        cam_kind: int, fix_scale: bool, radius: float = 16.0,
                        gn_iters: int = 8, chi2_px: float = 9.21):
    """Guided projection expansion + Sim3 GN refit, two rounds (the second
    at half radius): candidate-region landmarks projected into the query
    through the current Sim3, query-region ones into the candidate through
    its inverse, and duplicated landmark pairs as 3D-3D terms. kf_c may be a
    0-dim device index. Returns (s, R, t, n_inliers)."""
    L = state.L
    cand_lm = _group_landmarks(state, kf_c)
    query_lm = _group_landmarks(state, kf_q)
    Xc_all = lie.se3_apply(_row(state.kf_R_cw, kf_c), _row(state.kf_t_cw, kf_c), state.lm_pos)
    Xq_all = lie.se3_apply(_row(state.kf_R_cw, kf_q), _row(state.kf_t_cw, kf_q), state.lm_pos)
    dq, dc = _row(state.kf_desc, kf_q).float(), _row(state.kf_desc, kf_c).float()
    uv_q, uv_c = _row(state.kf_kpts, kf_q), _row(state.kf_kpts, kf_c)
    vq, vc = _row(state.kf_kpt_valid, kf_q), _row(state.kf_kpt_valid, kf_c)
    lm_desc = state.lm_desc.float()
    lm_q_kpt = _row(state.kf_landmark_idx, kf_q)
    slq = lm_q_kpt.long().clamp(0, L - 1)
    X_dst3 = Xq_all[slq]
    s, R, t = s0, R0, t0
    n_inl = None
    for r in (radius, radius * 0.5):
        Xq_pred = s * (Xc_all @ R.T) + t
        uv = cameras.project(cam_kind, cam_params, Xq_pred)
        kpt_lm, _ = assoc.projection_match(uv, lm_desc, cand_lm & (Xq_pred[:, 2] > 0.1),
                                           uv_q, dq, vq, radius=r)
        sl = kpt_lm.long().clamp(0, L - 1)
        si = 1.0 / torch.clamp(s, min=1e-9)
        Xc_pred = si * (Xq_all @ R) - si * (R.T @ t)
        uvb = cameras.project(cam_kind, cam_params, Xc_pred)
        kpt_lm_b, _ = assoc.projection_match(uvb, lm_desc, query_lm & (Xc_pred[:, 2] > 0.1),
                                             uv_c, dc, vc, radius=r)
        slb = kpt_lm_b.long().clamp(0, L - 1)
        pair3 = (kpt_lm >= 0) & (lm_q_kpt >= 0) & (sl != slq)
        w3 = pair3.float() * cam_params[0] / torch.clamp(X_dst3[:, 2], min=0.2)
        s, R, t, n_inl = sim3_solver.sim3_gn_refine(
            Xc_all[sl], uv_q, kpt_lm >= 0, s, R, t, cam_params, cam_kind=cam_kind,
            iters=gn_iters, fix_scale=fix_scale, chi2_px=chi2_px,
            X_bwd=Xq_all[slb], uv_bwd=uv_c, w_bwd=kpt_lm_b >= 0,
            X_src3=Xc_all[sl], X_dst3=X_dst3, w_3d=w3)
    return s, R, t, n_inl


def _sim3_candidates_kernel(state: ms.MapState, kf_q: int, cand_ids, cam_params, generator,
                            cam_kind: int, fix_scale: bool, ext_matches=None,
                            seed_chi2: float = 36.0, min_seed: int = 8,
                            guided_radius: float = 16.0, gn_iters: int = 8, samples=None):
    """Sim3 verification of the candidate keyframes cand_ids (host ints, -1
    padded): a seed RANSAC per candidate, then one guided refit of the
    best-seeded one. Returns (pack, s, R, t): pack = [ids, n_match, seed_ok,
    seed_inliers (B each), best_j, n_proj] on the device, (s, R, t) the
    guided Sim3; (1, I, 0) and zeros where no candidate seeded."""
    dev = state.device
    cand_ids = np.asarray(cand_ids, np.int64)
    B = cand_ids.shape[0]
    ids_t = torch.as_tensor(cand_ids, dtype=torch.int32, device=dev)
    one, eye, zero3 = (torch.ones((), device=dev), torch.eye(3, device=dev),
                       torch.zeros(3, device=dev))
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    if not (cand_ids >= 0).any():
        zb = torch.zeros((B,), dtype=torch.int32, device=dev)
        return torch.cat([ids_t, zb, zb, zb, zi[None], zi[None]]), one, eye, zero3
    seeds = []
    for b, c in enumerate(cand_ids):
        cc = int(np.clip(c, 0, state.K - 1))
        res, n_match = _sim3_between_kfs_body(
            state, kf_q, cc, cam_params, generator, cam_kind, fix_scale,
            None if ext_matches is None else ext_matches[b], chi2_px=seed_chi2,
            min_inliers=min_seed, samples=None if samples is None else samples[b])
        seeds.append((n_match, res.success & bool(c >= 0), res.n_inliers, res.s, res.R, res.t))
    nm, okk, ninl, s_all, R_all, t_all = (torch.stack(x) for x in zip(*seeds))
    best_j = torch.argmax(torch.where(okk, ninl, -1))
    kf_c = _row(ids_t.clamp(0, state.K - 1), best_j)
    s_g, R_g, t_g, n_proj = _guided_refine_body(
        state, kf_q, kf_c, _row(s_all, best_j), _row(R_all, best_j), _row(t_all, best_j),
        cam_params, cam_kind, fix_scale, radius=guided_radius, gn_iters=gn_iters)
    any_ok = okk.any()
    s_g, R_g, t_g = (torch.where(any_ok, a, b) for a, b in ((s_g, one), (R_g, eye), (t_g, zero3)))
    n_proj = torch.where(any_ok, n_proj, zi)
    pack = torch.cat([ids_t, nm, okk.to(torch.int32), ninl.to(torch.int32),
                      best_j.to(torch.int32)[None], n_proj.to(torch.int32)[None]])
    return pack, s_g, R_g, t_g


def _sim3_pair_guided(state: ms.MapState, kf_q: int, kf_c: int, cam_params, generator,
                      cam_kind: int, fix_scale: bool, ext_matches=None, seed_chi2: float = 36.0,
                      min_seed: int = 8, guided_radius: float = 16.0, gn_iters: int = 8,
                      samples=None):
    """Full verification of one pair: seed RANSAC, guided expansion, GN
    refit (the fire-time re-solve). The refit runs always and is selected
    where the seed succeeded. Returns (seed_ok, n_seed, s, R, t, n_proj)."""
    res, _ = _sim3_between_kfs_body(state, kf_q, kf_c, cam_params, generator, cam_kind,
                                    fix_scale, ext_matches, chi2_px=seed_chi2,
                                    min_inliers=min_seed, samples=samples)
    s, R, t, n_proj = _guided_refine_body(state, kf_q, kf_c, res.s, res.R, res.t, cam_params,
                                          cam_kind, fix_scale, radius=guided_radius,
                                          gn_iters=gn_iters)
    ok = res.success
    return (ok, res.n_inliers, torch.where(ok, s, res.s), torch.where(ok, R, res.R),
            torch.where(ok, t, res.t), torch.where(ok, n_proj, torch.zeros_like(n_proj)))


def _essential_edges(state: ms.MapState, W, min_covis_weight, kc: int = 8, lc: int = 4):
    """Essential-graph edges with a fixed cap per node: the top-kc
    covisibility neighbours (weight >= min_covis_weight), the spanning-tree
    parent and up to lc loop/merge edges. Ties in the top-k go to the lower
    index, as lax.top_k breaks them. Returns (e_i, e_j, valid, strong,
    w_cov); strong marks tree and loop edges."""
    K = state.K
    dev = state.device
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    wts, nbr = scatterless.top_k(W, kc)
    lw, lj = scatterless.top_k(state.kf_loop_edges.to(torch.int32), lc)
    e_i = torch.cat([ar.repeat_interleave(kc), ar, ar.repeat_interleave(lc)])
    e_j = torch.cat([nbr.reshape(-1).to(torch.int32),
                     state.kf_parent.clamp(0, K - 1).to(torch.int32),
                     lj.reshape(-1).to(torch.int32)])
    act = state.kf_active
    valid = (torch.cat([wts.reshape(-1) >= min_covis_weight, state.kf_parent >= 0,
                        lw.reshape(-1) > 0])
             & act[e_i.long()] & act[e_j.long()] & (e_i != e_j))
    strong = torch.cat([torch.zeros(K * kc, dtype=torch.bool, device=dev),
                        torch.ones(K + K * lc, dtype=torch.bool, device=dev)])
    w_cov = torch.cat([wts.reshape(-1).float(), torch.zeros(K + K * lc, device=dev)])
    return e_i, e_j, valid, strong, w_cov


def _relative_measurements(R, t, e_i, e_j):
    """Relative Sim3 of every edge at scale 1 from the poses (R, t)."""
    ones = torch.ones(e_i.shape[0], device=R.device)
    i, j = e_i.long(), e_j.long()
    return pose_graph.relative_sim3(ones, R[i], t[i], ones, R[j], t[j])


def _optimize_graph(state: ms.MapState, prob: pose_graph.PoseGraphProblem, iters: int,
                    mode: str):
    """The pose graph, then landmarks through their anchor's correction and
    SE3 poses back. Returns (kf_R, kf_t, lm_pos, costs), poses of every
    active keyframe replaced."""
    K = state.K
    ones = torch.ones(K, device=state.device)
    if mode == "4dof":
        R_new, t_new, costs = pose_graph.optimize_pose_graph_4dof(prob, iters=iters)
        s_new = ones
    else:
        s_new, R_new, t_new, costs = pose_graph.optimize_essential_graph(
            prob, iters=iters, fix_scale=(mode == "se3"))
    anchor = state.lm_anchor_kf.clamp(0, K - 1)
    lm_new = pose_graph.correct_landmarks(state.lm_pos, anchor, ones, state.kf_R_cw,
                                          state.kf_t_cw, s_new, R_new, t_new, state.lm_active)
    R_se3, t_se3 = pose_graph.sim3_to_se3(s_new, R_new, t_new)
    act = state.kf_active
    return (torch.where(act[:, None, None], R_se3, state.kf_R_cw),
            torch.where(act[:, None], t_se3, state.kf_t_cw), lm_new, costs)


def _set_loop_edge(edges: torch.Tensor, a: int, b: int) -> torch.Tensor:
    edges = edges.clone()
    edges[a, b] = True
    edges[b, a] = True
    return edges


def _correct_loop_kernel(state: ms.MapState, kf_q: int, kf_c: int, s_qc, R_qc, t_qc,
                         min_covis_weight: int, iters: int, mode: str = "sim3"):
    """Essential-graph correction after an accepted loop. S_qc maps the
    candidate camera into the query camera. mode "sim3" (mono), "se3"
    (scales locked) or "4dof" (inertial: yaw and translation). Returns (state,
    cost_history)."""
    K = state.K
    dev = state.device
    W = ms.covisibility(state)
    e_i, e_j, valid, strong, w_cov = _essential_edges(state, W, min_covis_weight)
    e_i = torch.cat([e_i, torch.tensor([kf_q], dtype=torch.int32, device=dev)])
    e_j = torch.cat([e_j, torch.tensor([kf_c], dtype=torch.int32, device=dev)])
    valid = torch.cat([valid, torch.ones(1, dtype=torch.bool, device=dev)])
    strong = torch.cat([strong, torch.ones(1, dtype=torch.bool, device=dev)])
    w_cov = torch.cat([w_cov, torch.zeros(1, device=dev)])
    is_new = torch.zeros(e_i.shape[0], dtype=torch.bool, device=dev)
    is_new[-1] = True
    s_m, R_m, t_m = _relative_measurements(state.kf_R_cw, state.kf_t_cw, e_i, e_j)
    s_m = torch.where(is_new, s_qc, s_m)
    R_m = torch.where(is_new[:, None, None], R_qc[None], R_m)
    t_m = torch.where(is_new[:, None], t_qc[None], t_m)
    e_weight = torch.where(strong | is_new, 10.0, torch.clamp(w_cov / 100.0, max=1.0))
    ar = torch.arange(K, device=dev)
    prob = pose_graph.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=state.kf_R_cw, t=state.kf_t_cw,
        opt_mask=state.kf_active & (ar != kf_c) & (ar != 0),
        e_i=e_i, e_j=e_j, e_s=s_m, e_R=R_m, e_t=t_m, e_valid=valid, e_weight=e_weight)
    R_new, t_new, lm_new, costs = _optimize_graph(state, prob, iters, mode)
    state = state.replace(kf_R_cw=R_new, kf_t_cw=t_new, lm_pos=lm_new,
                          kf_loop_edges=_set_loop_edge(state.kf_loop_edges, kf_q, kf_c))
    return state, costs


def _verify_hypothesis_kernel(state: ms.MapState, kf_q0: int, kf_q1: int, kf_c: int,
                              s_qc, R_qc, t_qc, cam_params, cam_kind: int, radius: float = 8.0):
    """Re-confirm a loop hypothesis from a newer keyframe: carry the Sim3
    (candidate camera -> kf_q0 camera) by the relative motion to kf_q1 and
    count projection matches of the candidate region there. Returns
    (n_matches, s1, R1, t1), the Sim3 candidate camera -> kf_q1 camera."""
    R0, t0 = state.kf_R_cw[kf_q0], state.kf_t_cw[kf_q0]
    R_rel = state.kf_R_cw[kf_q1] @ R0.T
    t_rel = state.kf_t_cw[kf_q1] - R_rel @ t0
    s1, R1, t1 = s_qc, R_rel @ R_qc, R_rel @ t_qc + t_rel
    cand_lm = _group_landmarks(state, kf_c)
    Xc_cam = lie.se3_apply(state.kf_R_cw[kf_c], state.kf_t_cw[kf_c], state.lm_pos)
    Xq = s1 * torch.einsum("ij,lj->li", R1, Xc_cam) + t1
    uv = cameras.project(cam_kind, cam_params, Xq)
    _, mutual = assoc.projection_match(
        uv, state.lm_desc.float(), cand_lm & (Xq[..., 2] > 0.1), state.kf_kpts[kf_q1],
        state.kf_desc[kf_q1].float(), state.kf_kpt_valid[kf_q1], radius=radius)
    return torch.sum(mutual, dtype=torch.int32), s1, R1, t1


def _fuse_after_loop_kernel(state: ms.MapState, kf_q: int, kf_c: int, cam_params,
                            cam_kind: int, radius: float = 5.0, prefer_query: bool = False):
    """Merge duplicated landmarks after a correction: the candidate region's
    landmarks projected into the query keyframe; where one lands on a
    keypoint that carries another landmark, the candidate's (older) one wins,
    or with prefer_query the query's (cross-map merges: the active map's
    points absorb the welded map's). Returns (state, n_fused)."""
    L = state.L
    cand_lm = _group_landmarks(state, kf_c)
    uv, _, visible = assoc.project_landmarks(state.lm_pos, cand_lm, state.kf_R_cw[kf_q],
                                             state.kf_t_cw[kf_q], cam_params, cam_kind)
    fuse_kpt = assoc.fuse_duplicates(uv, state.lm_desc.float(), visible, state.kf_kpts[kf_q],
                                     state.kf_desc[kf_q].float(), state.kf_kpt_valid[kf_q],
                                     radius=radius)
    dup_lm = state.kf_landmark_idx[kf_q][fuse_kpt.long().clamp(0, state.N - 1)]
    arangeL = torch.arange(L, dtype=torch.int32, device=state.device)
    do_fuse = (fuse_kpt >= 0) & (dup_lm >= 0) & (dup_lm != arangeL) & cand_lm
    dup_c = dup_lm.clamp(0, L - 1)
    if prefer_query:
        table = torch.where(do_fuse, dup_c, arangeL)
        killed = do_fuse
    else:
        # dup -> survivor: row dup_c[l] takes l where l fuses, else keeps
        # dup_c[l], and is killed where l fuses; where several l write one
        # row the last write wins, as the JAX package's scatters resolve it
        # on the CPU.
        vals = torch.where(do_fuse, arangeL, dup_c)
        last = torch.full((L,), -1, dtype=torch.long, device=state.device)
        last = last.scatter_reduce(0, dup_c.long(), torch.arange(L, device=state.device),
                                   reduce="amax")
        has = last >= 0
        table = torch.where(has, vals[last.clamp(min=0)], arangeL)
        killed = has & do_fuse[last.clamp(min=0)]
    state = ms.replace_landmark_ids(state, table)
    state = state.replace(lm_active=state.lm_active & ~killed)
    return state, torch.sum(do_fuse, dtype=torch.int32)


def _merge_maps_kernel(state: ms.MapState, kf_q: int, kf_c: int, s_qc, R_qc, t_qc):
    """Weld the candidate's map into the query's: every keyframe and
    landmark of the candidate's map through the world-to-world Sim3
    S_w = T_q^-1 S_qc T_c (poses back to SE3 by the scale), relabelled to the
    query's map, and a loop edge between the pair."""
    map_c, map_q = state.kf_map_id[kf_c], state.kf_map_id[kf_q]
    in_old_kf = state.kf_active & (state.kf_map_id == map_c)
    in_old_lm = state.lm_active & (state.lm_map_id == map_c)
    Rq, tq = state.kf_R_cw[kf_q], state.kf_t_cw[kf_q]
    Rc, tc = state.kf_R_cw[kf_c], state.kf_t_cw[kf_c]
    s_w = s_qc
    R_w = Rq.T @ R_qc @ Rc
    t_w = Rq.T @ (s_qc * (R_qc @ tc) + t_qc - tq)
    lm_new = s_w * torch.einsum("ij,lj->li", R_w, state.lm_pos) + t_w
    R_new = torch.einsum("kij,jl->kil", state.kf_R_cw, R_w.T)
    t_new = s_w * state.kf_t_cw - torch.einsum("kij,j->ki", R_new, t_w)
    return state.replace(
        lm_pos=torch.where(in_old_lm[:, None], lm_new, state.lm_pos),
        kf_R_cw=torch.where(in_old_kf[:, None, None], R_new, state.kf_R_cw),
        kf_t_cw=torch.where(in_old_kf[:, None], t_new, state.kf_t_cw),
        kf_map_id=torch.where(in_old_kf, map_q, state.kf_map_id),
        lm_map_id=torch.where(in_old_lm, map_q, state.lm_map_id),
        kf_loop_edges=_set_loop_edge(state.kf_loop_edges, kf_q, kf_c))


def _merge_propagate_kernel(state: ms.MapState, kf_q: int, kf_c: int, P0_R, P0_t, in_old_kf,
                            min_covis_weight: int, iters: int, nd: int, mode: str = "sim3"):
    """Essential-graph propagation after a merge: edge measurements from the
    poses before the welding BA (P0), the former active map and both weld
    windows fixed, so the absorbed map's interior takes up the seam
    correction. Returns (state, cost_history)."""
    K = state.K
    dev = state.device
    W = ms.covisibility(state)
    e_i, e_j, valid, strong, w_cov = _essential_edges(state, W, min_covis_weight)
    s_m, R_m, t_m = _relative_measurements(P0_R, P0_t, e_i, e_j)
    e_weight = torch.where(strong, 10.0, torch.clamp(w_cov / 100.0, max=1.0))
    ids_c, _ = ms.best_covisible(W * in_old_kf[None, :].to(W.dtype), kf_c, nd - 1)
    fixed = ~in_old_kf
    fixed = fixed | scatterless.seg_any(ids_c, ids_c >= 0, K)
    fixed = fixed.index_fill(0, torch.tensor([kf_q, kf_c, 0], device=dev), True)
    prob = pose_graph.PoseGraphProblem(
        s=torch.ones(K, device=dev), R=state.kf_R_cw, t=state.kf_t_cw,
        opt_mask=state.kf_active & ~fixed, e_i=e_i, e_j=e_j, e_s=s_m, e_R=R_m, e_t=t_m,
        e_valid=valid, e_weight=e_weight)
    R_new, t_new, lm_new, costs = _optimize_graph(state, prob, iters, mode)
    return state.replace(kf_R_cw=R_new, kf_t_cw=t_new, lm_pos=lm_new), costs


def _welding_ba_kernel(state: ms.MapState, kf_q: int, kf_c: int, cam_params, cam_kind: int,
                       iters: int, nd: int, in_old, bf=None):
    """Two-sided welding BA after a merge: the weld windows of both sides
    (each keyframe and its nd-1 best covisibles within its own side, in_old
    [K] marking the absorbed map's keyframes), the absorbed side optimized
    against the active side held fixed (the JAX package's
    adjust_candidate_side=True, the only setting its loop closer uses);
    keyframe 0 stays fixed."""
    dev = state.device
    W = ms.covisibility(state)
    Wq = W * (~in_old)[None, :].to(W.dtype)
    Wc = W * in_old[None, :].to(W.dtype)
    ids_q, _ = ms.best_covisible(Wq, kf_q, nd - 1)
    ids_c, _ = ms.best_covisible(Wc, kf_c, nd - 1)
    win_q = torch.cat([torch.tensor([kf_q], dtype=torch.int32, device=dev), ids_q])
    win_c = torch.cat([torch.tensor([kf_c], dtype=torch.int32, device=dev), ids_c])
    dup = torch.any(win_c[:, None] == win_q[None, :], dim=1)
    win_c = torch.where(dup, -1, win_c)
    window = torch.cat([win_q, win_c]).to(torch.int32)
    opt = (torch.arange(2 * nd, device=dev) >= nd) & (window > 0)
    return _local_ba_body(state, window, opt, cam_params, cam_kind, iters, bf=bf)


class LoopCloser:
    """Host orchestration of loop detection and correction (the JAX
    package's LoopCloser: the same queues, gates and logs)."""

    def __init__(self, cam_params, K: int, desc_dim: int, config: Optional[LoopConfig] = None,
                 seed: int = 3, matcher=None, mesh=None, device=None):
        """matcher: optional learned matcher (LightGlueFrameMatcher) for the
        fire-time keyframe matches, and with learned_verify_matches for the
        verification batch; None = mutual NN only. device None: the device
        of cam_params if it is a tensor, else cuda. mesh: an optional
        parallel.sharded_ba.Mesh; the post-loop global BA then runs
        landmark-sharded over it (maintenance.global_ba)."""
        self.mesh = mesh
        if isinstance(cam_params, torch.Tensor):
            device = cam_params.device if device is None else device
        else:
            cam_params = torch.tensor(np.asarray(cam_params, np.float32))
        self.device = resolve_device(device)
        self.cfg = config or LoopConfig()
        self.cam_params = cam_params.float().to(self.device)
        self.db = kdb.empty_db(desc_dim, K, n_words=2048, seed=seed, device=self.device)
        # The RANSAC draws (the JAX package's PRNGKey(seed), split per dispatch).
        self._generator = torch.Generator().manual_seed(seed)
        self.matcher = matcher
        self.loops_closed = []
        self.score_log = []   # (kf_id, best_score, minscore, dispatched)
        self.cand_log = []    # (kf_id, ids, n_match, sim3_ok, n_inliers, best_j, n_proj)
        self.hyp_log = []     # (q_last, kf_id, cand, n_proj, count, misses)
        # (kf_id, HostCopy of the detect pack, polls before its dispatch)
        self._pending_detect = deque()
        self._pending_cand = deque()     # (kf_id, HostCopy of the pack, s, R, t)
        self._gba_pending = 0
        self._gba_level = None
        self._polls = 0
        # Open hypothesis: {cand, q_last, count, misses, s, R, t, n_inliers},
        # (s, R, t) the Sim3 candidate camera -> q_last camera.
        self._hyp = None
        self._ban_until_kf = -1
        # Set by the inertial system once gravity is aligned: loop
        # corrections then keep roll, pitch and scale (the 4-DoF graph).
        self.use_4dof = False
        # baseline*fx, set by the stereo systems: the welding and global BAs
        # then carry the stereo rows.
        self.bf = None
        self._bf_cache = (None, None)

    def _bf_arr(self):
        """bf as a float32 scalar tensor on the device (None for mono)."""
        if self._bf_cache[0] != self.bf:
            self._bf_cache = (self.bf, None if self.bf is None else
                              torch.tensor(self.bf, dtype=torch.float32, device=self.device))
        return self._bf_cache[1]

    @property
    def pose_graph_mode(self) -> str:
        """Pose-graph flavour of loop correction: "4dof" once an inertial
        system has aligned gravity (use_4dof), else "se3" with fix_scale,
        else "sim3"."""
        if self.use_4dof:
            return "4dof"
        return "se3" if self.cfg.fix_scale else "sim3"

    def _sim3_kwargs(self):
        return dict(seed_chi2=self.cfg.seed_chi2_px, min_seed=self.cfg.min_sim3_inliers,
                    guided_radius=self.cfg.guided_radius, gn_iters=self.cfg.sim3_gn_iters)

    def on_compaction(self):
        """Slot compaction renumbered keyframes: queued packs hold old slot
        ids, so drop them (the detections re-arise on later keyframes)."""
        self._pending_cand.clear()
        self._pending_detect.clear()

    def precompile(self, state: ms.MapState):
        """Run every program of the loop-closing path once on the live
        shapes, on its own generator, and keep no results: the cuBLAS and
        cuSOLVER handles, the allocator's pools and both GBA levels the map
        may need are set up before a timed region."""
        gen = torch.Generator().manual_seed(0)
        cfg = self.cfg
        B = cfg.n_candidates
        vB = min(cfg.verify_top, B)
        dev = self.device
        one, eye, zero3 = (torch.ones((), device=dev), torch.eye(3, device=dev),
                           torch.zeros(3, device=dev))
        _detect_and_add_kernel(state, self.db, 0, B, cfg.min_recent_kfs_gap,
                               cfg.min_recent_time_s, cfg.connected_min_weight)
        ext = self._verify_matches(state, 0, np.zeros((vB,), np.int64))
        _sim3_candidates_kernel(state, 0, np.zeros((vB,), np.int64), self.cam_params, gen,
                                cfg.cam_kind, cfg.fix_scale, ext_matches=ext,
                                **self._sim3_kwargs())
        _verify_hypothesis_kernel(state, 0, 0, 0, one, eye, zero3, self.cam_params,
                                  cfg.cam_kind)
        _sim3_pair_guided(state, 0, 0, self.cam_params, gen, cfg.cam_kind, cfg.fix_scale,
                          ext_matches=self._kf_matches(state, 0, 0), **self._sim3_kwargs())
        _correct_loop_kernel(state, 0, 0, one, eye, zero3, cfg.min_covis_weight,
                             cfg.pose_graph_iters, mode=self.pose_graph_mode)
        _fuse_after_loop_kernel(state, 0, 0, self.cam_params, cfg.cam_kind)
        if cfg.run_gba:
            if cfg.gba_chunk_iters > 0 and self.mesh is None:
                lvl = maintenance.gba_level_for(maintenance.count_global_edges(state))
                for lv in sorted({lvl, min(lvl + 1, len(maintenance.GBA_LEVELS) - 1)}):
                    maintenance.global_ba(state, self.cam_params, cam_kind=cfg.cam_kind,
                                          iters=cfg.gba_chunk_iters, level=lv,
                                          bf=self._bf_arr())
            else:
                maintenance.global_ba(state, self.cam_params, cam_kind=cfg.cam_kind,
                                      iters=cfg.gba_chunk_iters or cfg.gba_iters,
                                      mesh=self.mesh, bf=self._bf_arr())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @profiling.spanned("loop.gba")
    def _gba_chunk(self, state: ms.MapState, fresh: bool = False) -> ms.MapState:
        """One chunk of the deferred post-loop global BA at the compaction
        level the live map needs (one host count per fired loop)."""
        if fresh or self._gba_level is None:
            self._gba_level = maintenance.gba_level_for(maintenance.count_global_edges(state))
        return maintenance.global_ba(state, self.cam_params, cam_kind=self.cfg.cam_kind,
                                     iters=self.cfg.gba_chunk_iters, level=self._gba_level,
                                     mesh=self.mesh, bf=self._bf_arr())

    def _kf_matches(self, state: ms.MapState, kf_q: int, kf_c: int):
        """Learned keyframe <-> keyframe matches (B1 at B=1), or None."""
        if self.matcher is None:
            return None
        return self.matcher(state.kf_kpts[kf_q], state.kf_desc[kf_q].float(),
                            state.kf_kpt_valid[kf_q], state.kf_kpts[kf_c],
                            state.kf_desc[kf_c].float(), state.kf_kpt_valid[kf_c])

    def _verify_matches(self, state: ms.MapState, kf_id: int, ids_np):
        """With learned_verify_matches: one batched learned match of the
        query against the verification candidates (B1 at B=verify_top)."""
        if not (self.cfg.learned_verify_matches and self.matcher is not None
                and hasattr(self.matcher, "match_batch")):
            return None
        jc = torch.as_tensor(np.clip(ids_np, 0, state.K - 1), device=self.device).long()
        q = int(np.clip(kf_id, 0, state.K - 1))
        B = len(ids_np)
        return self.matcher.match_batch(
            state.kf_kpts[q].expand(B, -1, -1), state.kf_desc[q].float().expand(B, -1, -1),
            state.kf_kpt_valid[q].expand(B, -1), state.kf_kpts[jc],
            state.kf_desc[jc].float(), state.kf_kpt_valid[jc])

    def on_keyframe(self, state: ms.MapState, kf_id: int):
        """Process a new keyframe: place recognition and the database insert
        as one device step whose pack is read later, then progress on the
        queues. Returns (state, info)."""
        cfg = self.cfg
        with profiling.span("loop.detect"):
            self.db, dpack = _detect_and_add_kernel(
                state, self.db, kf_id, cfg.n_candidates, cfg.min_recent_kfs_gap,
                cfg.min_recent_time_s, cfg.connected_min_weight)
            dpack = HostCopy(dpack)
        if self._hyp is not None:
            self._pending_cand.clear()
            self._pending_detect.clear()
            return self._advance_hypothesis(state, kf_id)
        if kf_id < self._ban_until_kf:
            return state, {"loop": False}
        self._pending_detect.append((kf_id, dpack, self._polls))
        fired = self._resolve_candidates(state)
        if fired is not None:
            return fired
        self._maybe_dispatch_sim3(state)
        return state, {"loop": False}

    def poll(self, state: ms.MapState):
        """Per-frame progress: one deferred GBA chunk, or resolve landed
        packs and dispatch a gated verification. Never waits on the card.
        Returns (state, info or None)."""
        self._polls += 1
        if self._gba_pending > 0:
            state = self._gba_chunk(state)
            self._gba_pending -= 1
            return state, None
        if self._hyp is not None:
            return state, None
        fired = self._resolve_candidates(state)
        if fired is not None:
            return fired
        self._maybe_dispatch_sim3(state)
        return state, None

    def finalize(self, state: ms.MapState):
        """Flush-time drain: wait for the in-flight packs, resolve them, fire
        a strong open hypothesis, and run the remaining GBA chunks."""
        fired = None
        while fired is None and (self._pending_detect or self._pending_cand) \
                and self._hyp is None:
            for q in (self._pending_detect, self._pending_cand):
                for item in q:
                    item[1].wait()
            self._maybe_dispatch_sim3(state)
            for item in self._pending_cand:
                item[1].wait()
            fired = self._resolve_candidates(state)
        if (fired is None and self._hyp is not None and self.cfg.strong_fire_proj > 0
                and self._hyp["n_inliers"] >= self.cfg.strong_fire_proj):
            fired = self._fire(state, self._hyp["q_last"])
        state = fired[0] if fired is not None else state
        while self._gba_pending > 0:
            state = self._gba_chunk(state)
            self._gba_pending -= 1
        return (state, fired[1]) if fired is not None else (state, None)

    @staticmethod
    def _freshest_ready(queue) -> Optional[int]:
        """Index of the newest entry whose pack has landed, or None."""
        for i in range(len(queue) - 1, -1, -1):
            if queue[i][1].ready():
                return i
        return None

    def _maybe_dispatch_sim3(self, state: ms.MapState):
        """Dispatch the verification of the freshest landed detection (older
        ones are shed), at most one per call and four in flight. Samples
        loop.detect_wait (polls from the detection's dispatch to its read)
        and loop.detect_shed (older detections dropped unread)."""
        while self._pending_detect and len(self._pending_cand) < 4:
            ready_i = self._freshest_ready(self._pending_detect)
            if ready_i is None:
                return
            kf_id, dpack, polls0 = self._pending_detect[ready_i]
            for _ in range(ready_i + 1):
                self._pending_detect.popleft()
            profiling.sample("loop.detect_wait", self._polls - polls0)
            profiling.sample("loop.detect_shed", ready_i)
            if self._dispatch_sim3_for(state, kf_id, dpack):
                return

    def _dispatch_sim3_for(self, state: ms.MapState, kf_id: int, dpack: HostCopy) -> bool:
        """Gate one landed detection and dispatch its verification. Returns
        True when a verification was dispatched."""
        cfg = self.cfg
        p = dpack.numpy()
        B = cfg.n_candidates
        ids_np = p[:B].astype(np.int64)
        scores_np, minscore = p[B:2 * B], float(p[2 * B])
        keep = (ids_np >= 0) & (scores_np >= max(cfg.min_score_ratio * minscore,
                                                 cfg.min_abs_score))
        self.score_log.append((int(kf_id), float(scores_np.max(initial=0.0)), minscore,
                               bool(keep.any())))
        if not keep.any():
            return False
        ids_np = np.where(keep, ids_np, -1)
        vB = min(cfg.verify_top, B)
        ids_np = ids_np[np.argsort(np.where(ids_np >= 0, -scores_np, np.inf))[:vB]]
        with profiling.span("loop.verify"):
            ext = self._verify_matches(state, kf_id, ids_np)
            pack, s_g, R_g, t_g = _sim3_candidates_kernel(
                state, kf_id, ids_np, self.cam_params, self._generator, cfg.cam_kind,
                cfg.fix_scale, ext_matches=ext, **self._sim3_kwargs())
            self._pending_cand.append((kf_id, HostCopy(pack), s_g, R_g, t_g))
        return True

    def _resolve_candidates(self, state: ms.MapState):
        """Read the freshest landed verification pack (shedding older ones)
        and open a hypothesis when it passes the gates; returns (state,
        info) when that hypothesis fires at once, else None."""
        if not self._pending_cand or self._hyp is not None:
            return None
        with profiling.span("loop.resolve"):
            cfg = self.cfg
            while self._pending_cand and self._hyp is None:
                ready_i = self._freshest_ready(self._pending_cand)
                if ready_i is None:
                    return None
                kf_id, pack, s_g, R_g, t_g = self._pending_cand[ready_i]
                for _ in range(ready_i + 1):
                    self._pending_cand.popleft()
                p = pack.numpy()
                B = min(cfg.verify_top, cfg.n_candidates)
                ids_np, nm_np = p[:B], p[B:2 * B]
                ok_np, ninl_np = p[2 * B:3 * B], p[3 * B:4 * B]
                best_j, n_proj = int(p[4 * B]), int(p[4 * B + 1])
                self.cand_log.append((int(kf_id), ids_np.tolist(), nm_np.tolist(), ok_np.tolist(),
                                      ninl_np.tolist(), best_j, n_proj))
                cand = int(ids_np[best_j]) if 0 <= best_j < B else -1
                if (cand >= 0 and ok_np[best_j] and nm_np[best_j] >= cfg.min_bow_matches
                        and n_proj >= cfg.min_sim3_proj):
                    self._hyp = {"cand": cand, "q_last": kf_id, "count": 1, "misses": 0,
                                 "s": s_g, "R": R_g, "t": t_g, "n_inliers": n_proj}
                    if (cfg.consistency_needed <= 1
                            or (cfg.strong_fire_proj > 0 and n_proj >= cfg.strong_fire_proj)):
                        return self._fire(state, kf_id)
            return None

    @profiling.spanned("loop.hypothesis")
    def _advance_hypothesis(self, state: ms.MapState, kf_id: int):
        """Re-confirm the open hypothesis from keyframe kf_id (one host read
        of the match count)."""
        hyp = self._hyp
        n_proj, s1, R1, t1 = _verify_hypothesis_kernel(
            state, hyp["q_last"], kf_id, hyp["cand"], hyp["s"], hyp["R"], hyp["t"],
            self.cam_params, self.cfg.cam_kind)
        n_proj = int(n_proj)
        self.hyp_log.append((int(hyp["q_last"]), int(kf_id), int(hyp["cand"]), n_proj,
                             hyp["count"], hyp["misses"]))
        if n_proj >= self.cfg.min_proj_verify:
            hyp.update(q_last=kf_id, count=hyp["count"] + 1, misses=0, s=s1, R=R1, t=t1)
            if hyp["count"] >= self.cfg.consistency_needed:
                return self._fire(state, kf_id)
            return state, {"loop": False, "pending": True, "candidate": hyp["cand"],
                           "count": hyp["count"]}
        hyp["misses"] += 1
        if hyp["misses"] > self.cfg.max_hyp_misses:
            self._hyp = None
        return state, {"loop": False}

    @profiling.spanned("loop.fire")
    def _fire(self, state: ms.MapState, kf_id: int):
        """Run the correction (same map) or the merge (another map) from
        keyframe kf_id with a fresh Sim3 solve, or the hypothesis's Sim3
        when the fresh one is weaker. Reads ok, n_proj and the map-id pair on
        the host."""
        cfg = self.cfg
        hyp = self._hyp
        self._hyp = None
        self._pending_cand.clear()
        self._pending_detect.clear()
        cand = hyp["cand"]
        with profiling.span("loop.sim3"):
            ok_s, _, s_f, R_f, t_f, n_proj = _sim3_pair_guided(
                state, kf_id, cand, self.cam_params, self._generator, cfg.cam_kind,
                cfg.fix_scale, ext_matches=self._kf_matches(state, kf_id, cand),
                **self._sim3_kwargs())
            n_proj, ok_s = int(n_proj), bool(ok_s)
        if ok_s and n_proj >= cfg.min_sim3_proj:
            s, R, t, n_inl = s_f, R_f, t_f, n_proj
        elif hyp["q_last"] == kf_id:
            s, R, t, n_inl = hyp["s"], hyp["R"], hyp["t"], hyp["n_inliers"]
        else:
            return state, {"loop": False}
        map_q, map_c = (int(x) for x in state.kf_map_id[[kf_id, cand]].cpu())
        if map_q != map_c:
            with profiling.span("loop.merge"):
                in_old = state.kf_active & (state.kf_map_id == map_c)
                state = _merge_maps_kernel(state, kf_id, cand, s, R, t)
                n_fused = 0
                for _ in range(max(1, cfg.merge_rounds)):
                    state, n_f = _fuse_after_loop_kernel(state, kf_id, cand, self.cam_params,
                                                         cfg.cam_kind, prefer_query=True)
                    n_fused += int(n_f)
                    if cfg.welding_ba_iters <= 0:
                        break
                    P0_R, P0_t = state.kf_R_cw, state.kf_t_cw
                    state = _welding_ba_kernel(state, kf_id, cand, self.cam_params, cfg.cam_kind,
                                               cfg.welding_ba_iters, cfg.welding_window, in_old,
                                               bf=self._bf_arr())
                    if cfg.merge_pose_graph_iters > 0:
                        state, _ = _merge_propagate_kernel(
                            state, kf_id, cand, P0_R, P0_t, in_old, cfg.min_covis_weight,
                            cfg.merge_pose_graph_iters, cfg.welding_window,
                            mode=self.pose_graph_mode)
                info = {"loop": True, "merge": True, "candidate": cand, "query_kf": kf_id,
                        "n_inliers": n_inl, "scale": float(s), "n_fused": n_fused}
            self.loops_closed.append((kf_id, cand))
            self._ban_until_kf = kf_id + cfg.post_fire_ban_kfs
            return state, info
        with profiling.span("loop.pose_graph"):
            state, costs = _correct_loop_kernel(state, kf_id, cand, s, R, t,
                                                cfg.min_covis_weight, cfg.pose_graph_iters,
                                                mode=self.pose_graph_mode)
        with profiling.span("loop.fuse"):
            state, n_fused = _fuse_after_loop_kernel(state, kf_id, cand, self.cam_params,
                                                     cfg.cam_kind)
        if cfg.run_gba:
            if cfg.gba_chunk_iters > 0:
                # The first chunk rides this frame, the rest one per poll.
                state = self._gba_chunk(state, fresh=True)
                self._gba_pending = max(-(-cfg.gba_iters // cfg.gba_chunk_iters) - 1, 0)
            else:
                with profiling.span("loop.gba"):
                    state = maintenance.global_ba(state, self.cam_params, cam_kind=cfg.cam_kind,
                                                  iters=cfg.gba_iters, mesh=self.mesh,
                                                  bf=self._bf_arr())
        info = {"loop": True, "candidate": cand, "query_kf": kf_id, "n_inliers": n_inl,
                "scale": float(s), "n_fused": int(n_fused), "pg_cost": float(costs[-1])}
        self.loops_closed.append((kf_id, cand))
        self._ban_until_kf = kf_id + cfg.post_fire_ban_kfs
        return state, info
