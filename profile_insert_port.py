"""The port's keyframe insert split by stage at the bench's widths: the twin
of profile_insert.py, with the map snapshot that profile_loop.py writes.

    python3 profile_insert_port.py [--state PATH] [--out PATH]
                                        # needs a CUDA device; exits 1 without one

Without --state it first runs profile_loop.py's configuration on the port
(bench_port.run_path_c on bench_port.py's scene: 40 + 60 frames at the
bench's per-frame motion, kf_tracked_ratio 0.75, ba_iters 2, ba_every 1,
LoopConfig(min_covis_weight=30, gba_iters=10, gba_chunk_iters=1),
pipeline=4; 480x640, SuperPoint 1024 x 256-D and 9-layer LightGlue from the
shipped npz, tables 512 / 1024 / 16384) and saves its map with
map/atlas.save_atlas at --out (default probe_out/probe_state.npz); with
--state it loads such a snapshot (either package's) with load_atlas.

On that map, with the newest keyframe's rows as the inserted frame, it
prints profile_insert.py's lines under its names:

  state_copy_ms          the map's clone (bench_port.clone_state)
  insert_full(ba2)_ms    slam/tracking.py _insert_keyframe_body, 2 BA
  insert_full(ba1)_ms    iterations, 1, and without the windowed BA
  insert_noba_ms
  obs+covis_ms           map_state.observation_matrix, its covisibility
                         product and best_covisible(2)
  triangulate_x2_ms      _triangulate_pair_kernel_body against both
                         neighbours (mutual NN on kernel B2)
  fuse_ms                map/maintenance.fuse_into_keyframe
  distinctive_desc_ms    maintenance.update_distinctive_descriptors
  covis_window_ms        tracking._covis_window(8, 8)
  local_ba_iters{1,2,4}_ms  tracking._local_ba_body on that window
  stats_cull_normals_mask_ms  the insert's tail: project_landmarks,
                         seg_any, update_found_visible, recount_lm_obs,
                         cull_landmarks, the normals and the local-map mask

Each line ends with b1=, b2= and syncs=: the kernel B1 and B2 launches of
one call and its implicit host syncs (torch.cuda.set_sync_debug_mode
("warn"), as bench_port.run_path_c counts them). The last line is the
card's name and power limit (nvidia-smi).

A time here is the eager port's host-inclusive time a call, not an XLA
program's: profile_insert.py's protocol (2 warm-up calls, then 10 calls
ended by one device synchronize), every call on its own clone of the map,
less the clone's time, as profile_insert.py subtracts its copy from the
full insert.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from bench_port import (H, LIGHTGLUE_LAYERS, NK, N_WARM, W, PathA, bench_camera, card,
                        clone_state, counts, log, profile_call, run_path_c)

N_TIMED = 60           # profile_loop.py's PROF_TIMED default
OUT = os.path.join("probe_out", "probe_state.npz")


def snapshot(dev, n_warm: int = N_WARM, n_timed: int = N_TIMED, **widths):
    """profile_loop.py's run on the port: its final map and the scene's
    camera."""
    scene = PathA(dev, n_warm + n_timed, **widths)
    r = run_path_c(scene, count_syncs=False, n_warm=n_warm, loop=True, name="profile_loop",
                   keep_slam=True)
    return r.pop("_slam").state, scene.cam


def insert_stages(st, cam, warmup: int = 2, reps: int = 10, emit=log) -> dict:
    """profile_insert.py's lines on st (the newest keyframe inserted again
    and its stages alone). Returns name -> bench_port.profile_call's result;
    emits one line each."""
    from rover_slam_tpu_torch.geometry import cameras
    from rover_slam_tpu_torch.map import maintenance as mnt
    from rover_slam_tpu_torch.map import map_state as ms
    from rover_slam_tpu_torch.ops import association as assoc
    from rover_slam_tpu_torch.ops import scatterless
    from rover_slam_tpu_torch.slam import tracking as T

    dev = st.device
    K, N, L = st.K, st.N, st.L
    emit(f"state: K={K} N={N} L={L} n_kf={int(st.n_kf)} n_lm={int(st.n_lm)}")
    cam = torch.as_tensor(cam, dtype=torch.float32, device=dev)
    cam_kind = cameras.PINHOLE
    src = int(st.n_kf) - 1
    kf = torch.tensor(src, dtype=torch.int32, device=dev)
    frame = (st.kf_R_cw[src], st.kf_t_cw[src], st.kf_kpts[src], st.kf_rays[src],
             st.kf_desc[src], st.kf_kpt_valid[src], st.kf_landmark_idx[src])
    res = {}

    def line(name, fn, minus_ms):
        r = res[name] = profile_call(lambda: fn(clone_state(st)), dev, warmup, reps,
                                     minus_ms=minus_ms)
        emit(f"{name} {r['ms']} {counts(r)}")
        return r["out"]

    line("state_copy_ms", lambda s: s.n_kf, 0.0)
    t_copy = res["state_copy_ms"]["ms"]

    def full(s, run_ba=True, ba_iters=2):
        s2, scal, mask = T._insert_keyframe_body(
            s, *frame, torch.tensor(99.0, device=dev), kf, cam, cam_kind, 8, 8, ba_iters,
            run_ba=run_ba)
        return scal, mask, s2.lm_pos, s2.kf_R_cw, s2.kf_t_cw, s2.kf_landmark_idx
    for name, kw in (("insert_full(ba2)", dict(run_ba=True, ba_iters=2)),
                     ("insert_full(ba1)", dict(run_ba=True, ba_iters=1)),
                     ("insert_noba", dict(run_ba=False))):
        line(f"{name}_ms", lambda s, kw=kw: full(s, **kw), t_copy)

    def obs_cov(s):
        obs = ms.observation_matrix(s)
        Wm = obs @ obs.T
        Wm.fill_diagonal_(0.0)
        ids, wts = ms.best_covisible(Wm, kf, 2)
        return obs, ids, wts
    obs, ids, wts = line("obs+covis_ms", obs_cov, t_copy)

    def tri2(s):
        n = []
        for j in range(2):
            s, n_j = T._triangulate_pair_kernel_body(
                s, kf, ids[j].long().clamp(0, K - 1), cam, cam_kind,
                (ids[j] >= 0) & (wts[j] >= 10))
            n.append(n_j)
        return s.lm_pos, n[0], n[1]
    line("triangulate_x2_ms", tri2, t_copy)

    def fuse(s):
        s2, a, b = mnt.fuse_into_keyframe(s, kf, cam, cam_kind, obs=obs)
        return s2.lm_pos, a, b
    line("fuse_ms", fuse, t_copy)
    line("distinctive_desc_ms",
         lambda s: mnt.update_distinctive_descriptors(s, kf, obs=obs).lm_desc, t_copy)
    win, opt_mask = line("covis_window_ms", lambda s: T._covis_window(s, kf, 8, 8), t_copy)
    for it in (1, 2, 4):
        line(f"local_ba_iters{it}_ms",
             lambda s, it=it: T._local_ba_body(s, win, opt_mask, cam, cam_kind, it).lm_pos,
             t_copy)

    def tail(s):
        _, _, visible_l = assoc.project_landmarks(s.lm_pos, s.lm_active, s.kf_R_cw[src],
                                                  s.kf_t_cw[src], cam, cam_kind)
        li_kf = s.kf_landmark_idx[src]
        found_l = scatterless.seg_any(li_kf, li_kf >= 0, s.L)
        s = mnt.update_found_visible(s, visible_l, found_l)
        obs2 = ms.observation_matrix(s)
        s = mnt.recount_lm_obs(s, obs=obs2)
        s = mnt.cull_landmarks(s)
        n_obs_l = obs2.sum(0)
        centers = -torch.einsum("kji,kj->ki", s.kf_R_cw, s.kf_t_cw)
        sum_c = obs2.T @ torch.where(s.kf_active[:, None], centers, 0.0)
        dirs = s.lm_pos * n_obs_l[:, None] - sum_c
        nn_ = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
        w_row = obs2 @ obs2[src]
        nbrs = (w_row > 0).index_fill(0, kf.reshape(1).long(), True)
        local_mask = ((nbrs.float() @ obs2) > 0) & s.lm_active
        return nn_, local_mask, s.lm_found
    line("stats_cull_normals_mask_ms", tail, t_copy)
    return res


def run(device=None, state: str | None = None, out: str = OUT, n_warm: int = N_WARM,
        n_timed: int = N_TIMED, hw=(H, W), n_kpts: int = NK, layers: int = LIGHTGLUE_LAYERS,
        tables=None, warmup: int = 2, reps: int = 10, emit=log) -> dict:
    """profile_insert.py's protocol on the port, on the snapshot at `state`
    or, with none, on the map of profile_loop.py's run (saved at `out`).
    device None is the card; the other arguments cut the widths and the
    frames of that run."""
    from rover_slam_tpu_torch.map import atlas
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    if state is None:
        st, cam = snapshot(dev, n_warm, n_timed, hw=hw, n_kpts=n_kpts, layers=layers,
                           tables=tables)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        atlas.save_atlas(st, out)
        emit(f"# snapshot saved to {out}")
    else:
        st = atlas.load_atlas(state, device=dev)
        cam = bench_camera(hw)
    return insert_stages(st, cam, warmup, reps, emit=emit)


def main(argv=(), device=None, **cut) -> int:
    """Print profile_insert.py's lines for the port. Without a CUDA device it
    fails unless the caller asks for another device (the CPU tests do, with
    a cut size)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--state", default=None, help="a saved map (save_atlas) to profile on")
    ap.add_argument("--out", default=OUT, help="where the run's map is saved without --state")
    args = ap.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("profile_insert_port.py: no CUDA device", file=sys.stderr)
        return 1
    run(device, state=args.state, out=args.out, **cut)
    print(card() if device is None else f"device {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
