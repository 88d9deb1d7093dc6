"""Each program of the port's hot path timed alone at the bench's widths: the
twin of profile_stages.py.

    python3 profile_stages_port.py      # needs a CUDA device; exits 1 without one

The scene is profile_stages.py's: bench_port.py's ring photo world at
480x640 (fx 458), 60 frames of orbit_trajectory over 0.4 revolutions at
1/30 s; SuperPoint (1024 keypoints, 256-D) and 9-layer LightGlue from the
shipped npz, LightGlue as the frame matcher; bench.py's TrackerConfig,
tables 512 / 1024 / 16384, loop closing with LoopConfig(min_covis_weight=30),
pipeline=4; every frame through bench_port.PathA.step, then flush. On the
map that run leaves it prints profile_stages.py's lines under its names:

  superpoint_ms, lightglue_pair_ms   one frame / one 1024-keypoint pair
  fused_noinsert_ms, fused_insert_ms slam/tracking.py _track_and_map_body,
                                     the last frame tracked again against
                                     itself, policy [fs, 200, 0] with fs 0
                                     and 99, with its did_insert flag
  detect_add_ms                      slam/loop_closing.py _detect_and_add_kernel
                                     on the newest keyframe
  match_batch{B}_ms                  LightGlueFrameMatcher.match_batch of the
                                     newest keyframe against its B candidates
  sim3_candidates_ms(ext|nn)         _sim3_candidates_kernel on those
                                     candidates with the learned matches and
                                     with mutual NN (kernel B2); a
                                     torch.Generator seeded 0 each call in
                                     place of PRNGKey(0)

Each line ends with b1=, b2= and syncs=: the kernel B1 and B2 launches of
one call and its implicit host syncs (torch.cuda.set_sync_debug_mode
("warn"), as bench_port.run_path_c counts them). The last line is the
card's name and power limit (nvidia-smi).

A time here is the eager port's host-inclusive time a call, not an XLA
program's: profile_stages.py's protocol (2 warm-up calls, then 10 calls, 5
for the fused program, ended by one device synchronize). The port's bodies
run eagerly, so every call that takes the map starts from its own clone of
it (bench_port.clone_state), and the clone's time (state_copy_ms, printed
first) is subtracted from those lines.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from bench_port import (H, LIGHTGLUE_LAYERS, NK, W, PathA, card, clone_state, counts, log,
                        profile_call)

N_FRAMES, REVS = 60, 0.4


def orbit_scene(dev, n_frames: int, revs: float, **widths) -> PathA:
    """bench_port.py's scene on the JAX profiling scripts' orbit: n_frames
    frames over revs revolutions at 1/30 s."""
    from rover_slam_tpu_torch.utils import synthetic
    gt = synthetic.orbit_trajectory(n_frames=n_frames, orbit_radius=5.0, revs=revs,
                                    dt=1.0 / 30.0)
    return PathA(dev, n_frames, gt=gt, **widths)


def run_scene(scene: PathA, loop: bool):
    """The JAX scripts' loop: a fresh pipeline=4 system, every frame, flush."""
    scene.warm_up()
    slam = scene.new_slam(pipeline=4, loop=loop)
    for i in range(len(scene.imgs)):
        scene.step(slam, i)
    slam.flush()
    return slam


def fused_call(st, prev, cfg, cam, fs: float, ba_iters: int | None = None,
               schedule: tuple | None = None):
    """slam/tracking.py _track_and_map_body on st, the previous frame `prev`
    (a FrameData: desc, valid, landmark_idx, kpts, rays, R_cw, t_cw) tracked
    again against itself from its own pose, as profile_stages.py and
    profile_iters.py call it: policy [fs, 200, 0], the local-map mask
    lm_active, mutual-NN matching (kernel B2), cfg's thresholds; ba_iters
    and schedule (motion_rounds, motion_iters, local_rounds, local_iters)
    default to cfg's. Returns the program's outputs after the state: policy,
    local_mask, R, t, lm_idx, flags [8] = [ok, n_inl, stage1_ok, n_cand,
    weak, did_insert, n_kf, n_lm]."""
    from rover_slam_tpu_torch.slam import tracking as T
    dev = st.device
    mr, mi, lr, li = schedule or (cfg.motion_rounds, cfg.motion_iters, cfg.local_rounds,
                                  cfg.local_iters)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = T._track_and_map_body(
        st, torch.tensor([fs, 200.0, 0.0], **f32), st.lm_active.clone(), prev.desc,
        prev.valid, prev.landmark_idx, prev.kpts, prev.rays, prev.desc, prev.valid,
        prev.R_cw, prev.t_cw, torch.tensor(0.0, **f32), torch.as_tensor(cam, **f32),
        cfg.cam_kind, cfg.image_hw, cfg.min_matches_motion, cfg.min_inliers_track,
        cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2,
        torch.tensor(cfg.kf_tracked_ratio, **f32), torch.tensor(float(cfg.kf_min_interval), **f32),
        torch.tensor(float(cfg.kf_max_interval), **f32), cfg.local_window, cfg.fixed_window,
        cfg.ba_iters if ba_iters is None else ba_iters, local_map_only=cfg.local_map_only,
        ext_matches=None, max_depth=torch.tensor(cfg.th_far_points, **f32),
        min_matches_ref_kf=cfg.min_matches_ref_kf, motion_rounds=mr, motion_iters=mi,
        local_rounds=lr, local_iters=li, min_inliers_weak=cfg.min_inliers_weak)
    return outs[1:]


def copy_ms(st, dev, warmup: int = 2, reps: int = 10) -> dict:
    """The state clone alone (profile_insert.py's state_copy_ms)."""
    return profile_call(lambda: clone_state(st).n_kf, dev, warmup, reps)


def program_stages(slam, matcher, dev, warmup: int = 2, reps: int = 10, fused_reps: int = 5,
                   emit=log) -> dict:
    """profile_stages.py's lines after the front end's, on slam's map:
    the fused program without and with the insert, the loop closer's
    detect program, match_batch and the Sim3-candidates program with the
    learned and the mutual-NN matches. Returns name -> bench_port.
    profile_call's result; emits one line each."""
    from rover_slam_tpu_torch.slam.loop_closing import (_detect_and_add_kernel,
                                                        _sim3_candidates_kernel)
    st, prev, cfg = slam.state, slam.last_frame, slam.cfg
    res = {"state_copy_ms": copy_ms(st, dev, warmup, reps)}
    t_copy = res["state_copy_ms"]["ms"]
    emit(f"state_copy_ms {t_copy} {counts(res['state_copy_ms'])}")
    for name, fs in (("fused_noinsert_ms", 0.0), ("fused_insert_ms", 99.0)):
        r = res[name] = profile_call(lambda fs=fs: fused_call(clone_state(st), prev, cfg,
                                                              slam.cam_params, fs),
                                     dev, warmup, fused_reps, minus_ms=t_copy)
        r["did_insert"] = int(r["out"][-1][5])
        emit(name, r["ms"], "did_insert=", r["did_insert"], counts(r))

    lc = slam.loop_closer
    lcfg = lc.cfg
    kf_id = slam.n_kf - 1

    def detect():
        return _detect_and_add_kernel(clone_state(st), lc.db, kf_id, lcfg.n_candidates,
                                      lcfg.min_recent_kfs_gap, lcfg.min_recent_time_s,
                                      lcfg.connected_min_weight)[1]
    r = res["detect_add_ms"] = profile_call(detect, dev, warmup, reps, minus_ms=t_copy)
    emit("detect_add_ms", r["ms"], counts(r))
    B = lcfg.n_candidates
    ids = r["out"][:B].cpu().numpy().astype(np.int64)
    r["candidates"] = ids.tolist()
    jc = torch.as_tensor(np.clip(ids, 0, st.K - 1), device=dev)
    q = min(max(kf_id, 0), st.K - 1)
    qk, qd, qv = st.kf_kpts[q], st.kf_desc[q].float(), st.kf_kpt_valid[q]

    def match_batch():
        return matcher.match_batch(qk.expand(B, -1, -1), qd.expand(B, -1, -1),
                                   qv.expand(B, -1), st.kf_kpts[jc], st.kf_desc[jc].float(),
                                   st.kf_kpt_valid[jc])
    name = f"match_batch{B}_ms"
    r = res[name] = profile_call(match_batch, dev, warmup, reps)
    emit(name, r["ms"], counts(r))
    ext_m = r["out"]
    for name, ext in (("sim3_candidates_ms(ext)", ext_m), ("sim3_candidates_ms(nn)", None)):
        def sim3(ext=ext):
            return _sim3_candidates_kernel(
                clone_state(st), kf_id, ids, lc.cam_params, torch.Generator().manual_seed(0),
                lcfg.cam_kind, lcfg.fix_scale, ext_matches=ext, **lc._sim3_kwargs())
        r = res[name] = profile_call(sim3, dev, warmup, reps, minus_ms=t_copy)
        emit(name, r["ms"], counts(r))
    return res


def run(device=None, n_frames: int = N_FRAMES, revs: float = REVS, hw=(H, W), n_kpts: int = NK,
        layers: int = LIGHTGLUE_LAYERS, tables=None, warmup: int = 2, reps: int = 10,
        fused_reps: int = 5, emit=log) -> dict:
    """profile_stages.py's protocol on the port; device None is the card, the
    other arguments cut the widths and the frames."""
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    scene = orbit_scene(dev, n_frames, revs, hw=hw, n_kpts=n_kpts, layers=layers, tables=tables)
    res = {}
    img0 = scene.imgs[0]
    r = res["superpoint_ms"] = profile_call(lambda: scene.ext(img0), dev, warmup, reps)
    emit("superpoint_ms", r["ms"], counts(r))
    o0, o1 = scene.ext(scene.imgs[0]), scene.ext(scene.imgs[1])
    r = res["lightglue_pair_ms"] = profile_call(
        lambda: scene.matcher(o0["keypoints"][0], o0["descriptors"][0], o0["valid"][0],
                              o1["keypoints"][0], o1["descriptors"][0], o1["valid"][0]),
        dev, warmup, reps)
    emit("lightglue_pair_ms", r["ms"], counts(r))
    slam = run_scene(scene, loop=True)
    emit("n_kf after run:", slam.n_kf)
    res.update(program_stages(slam, scene.matcher, dev, warmup, reps, fused_reps, emit=emit))
    return res


def main(device=None, **cut) -> int:
    """Print profile_stages.py's lines for the port. Without a CUDA device it
    fails unless the caller asks for another device (the CPU tests do, with
    a cut size)."""
    if device is None and not torch.cuda.is_available():
        print("profile_stages_port.py: no CUDA device", file=sys.stderr)
        return 1
    run(device, **cut)
    print(card() if device is None else f"device {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
