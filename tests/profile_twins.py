"""Shared by the tests of the profiling twins (tests/test_torch_profile_*.py):
the lines a JAX profiling script prints, read from its source; the small
snapshot their parity tests run on; and the JAX package's calls written as
profile_insert.py and profile_iters.py write them (those scripts keep
everything inside main, so their expressions are repeated here).

Each print() call in the script's main() becomes a pattern: its arguments
joined by spaces, where a string constant stays as written, a loop variable
bound by an enclosing `for` over a literal list of tuples takes each of its
values in turn (one pattern per value), and anything else (a timing, a
flag, a count) matches one token. f-strings and %-formats split the same
way. A twin prints each pattern's line, then its own additions.
"""
import ast
import itertools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np

from rover_slam_tpu.map import maintenance as jmnt
from rover_slam_tpu.map import map_state as jms
from rover_slam_tpu.ops import association as jassoc
from rover_slam_tpu.ops import scatterless as jscat
from rover_slam_tpu.slam import tracking as jT
from torch_parity import CAM, ring_orbit_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANY = "\0"
# The snapshot: the ring-orbit map the port builds over the loop scene's
# first SNAP_FRAMES frames, SNAP_KPTS keypoints a frame (tables 64 /
# SNAP_KPTS / 8192; 15 keyframes).
SNAP_FRAMES, SNAP_KPTS = 24, 256


def _bindings(for_node):
    """[{name: value}, ...] for `for <target> in <list literal>` (tuple
    targets unpack; non-constant elements bind nothing)."""
    if not isinstance(for_node.iter, (ast.List, ast.Tuple)):
        return [{}]
    tgt = for_node.target
    names = ([e.id for e in tgt.elts if isinstance(e, ast.Name)] if isinstance(tgt, ast.Tuple)
             else [tgt.id] if isinstance(tgt, ast.Name) else [])
    out = []
    for el in for_node.iter.elts:
        vals = el.elts if isinstance(el, ast.Tuple) else [el]
        if not isinstance(tgt, ast.Tuple):
            vals = [el]
        out.append({n: v.value for n, v in zip(names, vals) if isinstance(v, ast.Constant)})
    return out


def _parts(node, env):
    """The pieces of one print argument: strings and ANY."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.Name) and node.id in env:
        return [str(env[node.id])]
    if isinstance(node, ast.JoinedStr):
        out = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                out.append(v.value)
            elif (isinstance(v, ast.FormattedValue) and isinstance(v.value, ast.Name)
                  and v.value.id in env and v.format_spec is None):
                out.append(str(env[v.value.id]))
            else:
                out.append(ANY)
        return out
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod)
            and isinstance(node.left, ast.Constant)):
        return [ANY.join(re.split(r"%[-0-9.]*[dsfr]", node.left.value))]
    return [ANY]


def _pattern(call, env) -> re.Pattern:
    text = " ".join("".join(_parts(a, env)) for a in call.args)
    return re.compile("".join(r"\S+" if c == ANY else re.escape(c) for c in text))


def script_patterns(script: str) -> list:
    """The patterns of every line `script`'s main() prints."""
    tree = ast.parse((ROOT / script).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    pats = []

    def walk(node, envs):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.For):
                envs2 = [{**e, **b} for e, b in itertools.product(envs, _bindings(child))]
                walk(child, envs2)
                continue
            if (isinstance(child, ast.Call) and isinstance(child.func, ast.Name)
                    and child.func.id == "print"):
                pats.extend(_pattern(child, e) for e in envs)
            walk(child, envs)
    walk(main, [{}])
    return pats


def printed_lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


def assert_prints_lines(script: str, lines: list) -> list:
    """Each line of `script` is printed, its counts after it. Returns the
    patterns (at least 8: every script prints that many)."""
    pats = script_patterns(script)
    assert len(pats) >= 8, pats
    counts = re.compile(r" b1=\d+ b2=\d+ syncs=(\d+|None)$")
    for p in pats:
        hits = [ln for ln in lines if p.match(ln)]
        assert hits, f"{script}: no line matches {p.pattern!r}"
        timed = [ln for ln in hits if re.search(r"_ms|\\ ms\\ ", p.pattern)]
        assert all(counts.search(ln) for ln in timed), (p.pattern, timed)
    return pats


def snapshot():
    """The parity tests' map, as it stood before its newest keyframe's
    insert triangulated: the landmarks that keyframe created are removed
    (map_state.remove_landmarks clears their observations), so the pair
    triangulation and the full insert of that keyframe again have free
    keypoints to work on."""
    from rover_slam_tpu_torch.map import map_state as tms
    st = ring_orbit_state(n_frames=SNAP_FRAMES, n_kpts=SNAP_KPTS)
    own = st.lm_active & (st.lm_anchor_kf == int(st.n_kf) - 1)
    assert int(own.sum()) > 0
    return tms.remove_landmarks(st, own)


def last_keyframe_frame(st):
    """The newest keyframe's rows as the previous frame the fused program
    tracks again (what slam.last_frame is in the scripts' runs)."""
    k = int(st.n_kf) - 1
    return types.SimpleNamespace(desc=st.kf_desc[k], valid=st.kf_kpt_valid[k],
                                 landmark_idx=st.kf_landmark_idx[k], kpts=st.kf_kpts[k],
                                 rays=st.kf_rays[k], R_cw=st.kf_R_cw[k], t_cw=st.kf_t_cw[k])


@jax.jit
def copy_state(s):
    """profile_insert.py's copy (its `x + 0` turns the bool fields int32,
    which its full insert runs on)."""
    return jax.tree.map(lambda x: x + 0 if hasattr(x, "dtype") else x, s)


def jax_fused(st, cfg, prev, mr, mi, lr, li, fs, ba_iters):
    """profile_iters.py's run_fused on the JAX map st (its [fs, 200] policy
    with the third entry, 0, that profile_stages.py passes): flags [8]."""
    pol = jnp.asarray([fs, 200.0, 0.0], jnp.float32)
    mask = st.lm_active.copy()
    stc = jax.tree.map(lambda x: x.copy() if hasattr(x, "copy") else x, st)
    outs = jT._track_and_map_kernel(
        stc, pol, mask, prev.desc, prev.valid, prev.landmark_idx,
        prev.kpts, prev.rays, prev.desc, prev.valid,
        prev.R_cw, prev.t_cw, jnp.asarray(0.0, jnp.float32),
        jnp.asarray(CAM), cfg.cam_kind, cfg.image_hw,
        cfg.min_matches_motion, cfg.min_inliers_track,
        cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2,
        jnp.asarray(cfg.kf_tracked_ratio, jnp.float32),
        jnp.asarray(cfg.kf_min_interval, jnp.float32),
        jnp.asarray(cfg.kf_max_interval, jnp.float32),
        cfg.local_window, cfg.fixed_window, ba_iters,
        local_map_only=cfg.local_map_only, ext_matches=None,
        max_depth=jnp.asarray(cfg.th_far_points, jnp.float32),
        min_matches_ref_kf=cfg.min_matches_ref_kf,
        motion_rounds=mr, motion_iters=mi,
        local_rounds=lr, local_iters=li,
        min_inliers_weak=cfg.min_inliers_weak)
    return np.asarray(outs[6])


def jax_insert_full(st, cam):
    """profile_insert.py's three full inserts on the JAX map st: name ->
    (state, scalars, local_mask)."""
    kf_src = int(st.n_kf) - 1
    R = st.kf_R_cw[kf_src]; t = st.kf_t_cw[kf_src]
    kpts = st.kf_kpts[kf_src]; rays = st.kf_rays[kf_src]
    desc = st.kf_desc[kf_src]; valid = st.kf_kpt_valid[kf_src]
    lidx = st.kf_landmark_idx[kf_src]
    cam_kind = 0

    def full(run_ba, ba_iters=2):
        stc = copy_state(st)
        return jT._insert_keyframe_kernel(
            stc, R, t, kpts, rays, desc, valid, lidx,
            jnp.asarray(99.0, jnp.float32), jnp.asarray(kf_src, jnp.int32),
            cam, cam_kind, 8, 8, ba_iters, run_ba=run_ba)
    return {f"{name}_ms": full(**kw)
            for name, kw in [("insert_full(ba2)", dict(run_ba=True, ba_iters=2)),
                             ("insert_full(ba1)", dict(run_ba=True, ba_iters=1)),
                             ("insert_noba", dict(run_ba=False))]}


def jax_insert_stages(st, cam):
    """profile_insert.py's stage calls after the full inserts on the JAX
    map st: name -> the call's outputs (the triangulation's, the fusion's
    and the descriptors' with their states)."""
    cam_kind = 0
    kf_src = int(st.n_kf) - 1
    out = {}

    @jax.jit
    def obs_cov(s):
        obs = jms.observation_matrix(s)
        Wm = obs @ obs.T
        Wm = Wm * (1.0 - jnp.eye(s.K, dtype=Wm.dtype))
        ids, wts = jms.best_covisible(Wm, jnp.asarray(kf_src, jnp.int32), 2)
        return obs, ids, wts
    obs, ids, wts = out["obs+covis_ms"] = obs_cov(st)

    @jax.jit
    def tri2(s):
        s, n0 = jT._triangulate_pair_kernel_body(
            s, jnp.asarray(kf_src, jnp.int32),
            jnp.clip(ids[0], 0, s.K - 1), cam, cam_kind,
            (ids[0] >= 0) & (wts[0] >= 10))
        s, n1 = jT._triangulate_pair_kernel_body(
            s, jnp.asarray(kf_src, jnp.int32),
            jnp.clip(ids[1], 0, s.K - 1), cam, cam_kind,
            (ids[1] >= 0) & (wts[1] >= 10))
        return s.lm_pos, n0, n1, s
    out["triangulate_x2_ms"] = tri2(st)

    @jax.jit
    def fuse(s):
        s2, a, b = jmnt.fuse_into_keyframe(s, jnp.asarray(kf_src, jnp.int32),
                                           cam, cam_kind, obs=obs)
        return s2.lm_pos, a, b, s2
    out["fuse_ms"] = fuse(st)

    @jax.jit
    def ddesc(s):
        return jmnt.update_distinctive_descriptors(
            s, jnp.asarray(kf_src, jnp.int32), obs=obs)
    out["distinctive_desc_ms"] = ddesc(st)

    @jax.jit
    def window(s):
        return jT._covis_window(s, jnp.asarray(kf_src, jnp.int32), 8, 8)
    win, opt_mask = out["covis_window_ms"] = window(st)
    for it in (1, 2, 4):
        out[f"local_ba_iters{it}_ms"] = jT._local_ba_kernel(
            st, win, opt_mask, cam, cam_kind, it).lm_pos

    @jax.jit
    def tail(s):
        uv_l, depth_l, visible_l = jassoc.project_landmarks(
            s.lm_pos, s.lm_active, s.kf_R_cw[kf_src], s.kf_t_cw[kf_src],
            cam, cam_kind)
        li_kf = s.kf_landmark_idx[kf_src]
        found_l = jscat.seg_any(li_kf, li_kf >= 0, s.L)
        s = jmnt.update_found_visible(s, visible_l, found_l)
        obs2 = jms.observation_matrix(s)
        s = jmnt.recount_lm_obs(s, obs=obs2)
        s = jmnt.cull_landmarks(s)
        ow = obs2.astype(jnp.float32)
        n_obs_l = ow.sum(0)
        centers = -jnp.einsum("kji,kj->ki", s.kf_R_cw, s.kf_t_cw)
        sum_c = ow.T @ jnp.where(s.kf_active[:, None], centers, 0.0)
        dirs = s.lm_pos * n_obs_l[:, None] - sum_c
        nn = dirs / jnp.maximum(
            jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9)
        w_row = obs2 @ obs2[kf_src]
        nbrs = (w_row > 0).at[kf_src].set(True)
        local_mask = ((nbrs.astype(jnp.float32) @ obs2) > 0) & s.lm_active
        return nn, local_mask, s.lm_found
    out["stats_cull_normals_mask_ms"] = tail(st)
    return out


def iters_pair(schedules):
    """profile_iters_port.sweep on the snapshot (its newest keyframe as the
    previous frame, the ring scene's TrackerConfig) and the JAX package's
    fused program, as profile_iters.py runs it, for the "track" and
    "insert" tags of each of `schedules` (fs is a traced argument there, so
    one compile a schedule serves both). Returns (port results, {(schedule,
    tag): JAX flags}, port lines)."""
    import torch
    import profile_iters_port
    from rover_slam_tpu_torch.slam.tracking import TrackerConfig
    from torch_parity import to_jax_state
    st = snapshot()
    cfg = TrackerConfig(local_map_only=True)
    slam = types.SimpleNamespace(state=st, last_frame=last_keyframe_frame(st), cfg=cfg,
                                 cam_params=torch.from_numpy(CAM))
    lines = []
    res = profile_iters_port.sweep(slam, torch.device("cpu"), warmup=0, reps=1,
                                   emit=lines.append)
    st_j = to_jax_state(st)
    prev_j = last_keyframe_frame(st_j)
    ref = {(sched, tag): jax_fused(st_j, cfg, prev_j, *sched, fs, ba)
           for sched in schedules for tag, fs, ba in profile_iters_port.tags(cfg)
           if tag != "insert_ba1"}
    return res, ref, lines


def check_schedule(pair, sched):
    """The port's ok, n_inl and ins flags of one schedule equal the JAX
    package's for "track" and "insert"; "insert_ba1" (the same track step
    and policy, one BA iteration in the insert) gives the port the
    insert's flags; n_kf (flag 6) equal too."""
    res, ref, lines = pair
    for tag in ("track", "insert"):
        r, fl = res[(sched, tag)], ref[(sched, tag)]
        assert (r["ok"], r["n_inl"], r["ins"]) == (int(fl[0]), int(fl[1]), int(fl[5])), (tag, fl)
        assert r["ins"] == (tag == "insert") and r["n_inl"] > 0
        np.testing.assert_array_equal(r["out"][-1].numpy()[[0, 1, 5, 6]], fl[[0, 1, 5, 6]])
    ba1 = res[(sched, "insert_ba1")]
    assert (ba1["ok"], ba1["n_inl"], ba1["ins"]) == tuple(
        res[(sched, "insert")][k] for k in ("ok", "n_inl", "ins"))
    head = "(%d,%d,%d,%d) " % sched
    assert sum(ln.startswith(head) for ln in lines) == 3
