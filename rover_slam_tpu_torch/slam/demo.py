"""Self-contained end-to-end demo: synthetic scene -> SLAM -> ATE.

Counterpart of rover_slam_tpu/slam/demo.py: renders a synthetic trajectory
through a landmark world, tracks it with MonocularSLAM (or the
mono-inertial system with --inertial), and prints per-stage timings plus the
scale-aligned ATE against ground truth. Runs on the card unless --device
cpu is given; --trace DIR writes a torch.profiler Chrome trace into DIR,
each frame under a "frame#i" span with "track_frame" inside it.

  python -m rover_slam_tpu_torch.slam.demo [--frames 60] [--inertial] [--loop]
      [--pipeline 4] [--keypoints 512] [--device cpu] [--trace DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from .. import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--keypoints", type=int, default=512)
    ap.add_argument("--inertial", action="store_true")
    ap.add_argument("--loop", action="store_true",
                    help="orbit trajectory + loop closing enabled")
    ap.add_argument("--pipeline", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace into DIR")
    args = ap.parse_args(argv)
    if args.trace:
        from ..utils.profiling import device_trace
        ctx = device_trace(args.trace)
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        return _run(args)


def _run(args):
    from ..utils import synthetic, trajectory
    from ..utils.profiling import span
    from . import tracking as T

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", file=sys.stderr)

    if args.inertial:
        from ..imu import preintegration as pre
        from .inertial_system import MonocularInertialSLAM
        calib = pre.ImuCalib(
            Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
            sigma_g=np.float32(1.7e-4 * np.sqrt(200.0)),
            sigma_a=np.float32(2e-3 * np.sqrt(200.0)),
            walk_g=np.float32(1.9e-5 / np.sqrt(200.0)),
            walk_a=np.float32(3e-3 / np.sqrt(200.0)))
        world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=args.seed)
        R_gt, t_gt, times, v_gt, imu = synthetic.orbit_with_imu(
            n_frames=args.frames, revs=0.5, dt=0.1)
        frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=args.keypoints,
                                           pix_noise=0.5, desc_noise=0.05)
        slam = MonocularInertialSLAM(world.cam_params, calib, tinit_s=1.5,
                                     map_capacity=(96, args.keypoints, 16384),
                                     desc_dim=64, device=dev)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            with span(f"frame#{i}", sample=False):
                if i > 0:
                    for a, g, t in zip(*imu[i - 1]):
                        slam.feed_imu(a, g, t)
                with span("track_frame", sample=False):
                    slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
        with_scale = False      # metric ATE: the IMU makes scale observable
    else:
        from .system import MonocularSLAM
        if args.loop:
            world = synthetic.ring_world(n_landmarks=8000, desc_dim=64, seed=args.seed)
            R_gt, t_gt, times, _, _ = synthetic.orbit_with_imu(
                n_frames=args.frames, revs=1.1, dt=0.1)
        else:
            world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=args.seed)
            R_gt, t_gt, times = synthetic.forward_trajectory(
                n_frames=args.frames, dt=0.1, speed=0.6, yaw_rate=0.04)
        frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=args.keypoints,
                                           pix_noise=0.4, desc_noise=0.05)
        slam = MonocularSLAM(world.cam_params, map_capacity=(96, args.keypoints, 16384),
                             desc_dim=64, pipeline=args.pipeline,
                             enable_loop_closing=args.loop, device=dev)
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            with span(f"frame#{i}", sample=False), span("track_frame", sample=False):
                slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
        slam.flush()
        with_scale = True       # mono scale is gauge freedom
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    wall = time.perf_counter() - t0
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt_pos = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in zip(R_gt, t_gt)])
    pairs = trajectory.associate_by_time(est_t, times)
    if args.inertial:   # score post-initialization segment only
        pairs = [p for p in pairs if est_t[p[0]] >= 2.0]
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    rmse, _ = trajectory.ate_rmse(e, g, with_scale=with_scale)
    path_len = float(np.linalg.norm(np.diff(g, axis=0), axis=1).sum())

    print(slam.timers.report(), file=sys.stderr)
    ok = slam.tracking_state == T.OK
    kind = ("metric " if not with_scale else "") + "ATE"
    print(f"{len(frames)} frames in {wall:.2f}s "
          f"({len(frames) / wall:.1f} fps) | state="
          f"{'OK' if ok else slam.tracking_state} kfs={slam.n_kf} "
          f"loops={len(getattr(slam, 'loop_events', []))} | "
          f"{kind} {rmse * 100:.2f} cm over {path_len:.1f} m")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
