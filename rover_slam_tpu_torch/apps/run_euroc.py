"""CLI driver: run SLAM on an EuRoC-format sequence.

Counterpart of rover_slam_tpu/apps/run_euroc.py (the reference's mono_euroc,
mono_inertial_euroc, stereo_euroc and stereo_inertial_euroc mains, with no
vocabulary argument).

Usage:
  python -m rover_slam_tpu_torch.apps.run_euroc SETTINGS.yaml MAV0_DIR \
      [--sensor monocular|monocular-inertial|stereo|stereo-inertial] [--out traj.txt] \
      [--superpoint-ckpt superpoint_v1.pth] [--lightglue-ckpt superpoint_lightglue.pth] \
      [--max-frames N] [--gt gt.txt] [--stats-out stats.json] \
      [--frame-log frames.json] [--device cuda|cpu]

Images are decoded and prefetched by the native C++ runtime; SuperPoint (and
LightGlue with --lightglue-ckpt) run on the device; IMU samples are fed in
time relative to the first frame; the trajectory is written in TUM format,
the atlas saved when the settings name System.SaveAtlasToFile, and, given
ground truth, scored with the Horn ATE protocol (metric with an IMU,
scale-aligned without, plain stereo included, as the JAX app scores it).
The stereo sensors read the right eye from cam1/ (the app returns 1 without
it) through a second prefetcher; both eyes go through one SuperPoint call as
a batch of two, remapped first through the settings' rectification on a raw
rig, and the frame goes to track_stereo_frame with the right eye's pixels
(as the JAX app passes them, on a fisheye rig too: ROADMAP.md §C).
--frame-log writes each frame's image-read (the wait on the prefetcher;
read_r_ms for the right eye), extract and track times (ms), its tracking
state and whether the IMU was ready, and the inertial system's scale log
(the init's scale, then refinements).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..geometry import cameras, rectify
from ..models.superpoint import SuperPointExtractor, load_torch_weights
from ..utils import dataset, trajectory
from ..utils.config import build_system, load_settings


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("data_dir", help="EuRoC mav0/ directory")
    ap.add_argument("--sensor", default="monocular")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--superpoint-ckpt", default=None)
    ap.add_argument("--lightglue-ckpt", default=None,
                    help="official superpoint_lightglue.pth; enables the LightGlue "
                         "frame-to-frame matcher in the tracker")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--gt", default=None, help="TUM-format ground truth")
    ap.add_argument("--stats-out", default=None,
                    help="write run stats (n_kf, fps, ate_cm) as JSON")
    ap.add_argument("--frame-log", default=None,
                    help="write per-frame times (ms), states and IMU readiness as JSON")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    settings = load_settings(args.settings, sensor=args.sensor)
    matcher = None
    if args.lightglue_ckpt:
        from ..models.lightglue import (LightGlueFrameMatcher, LightGlueMatcher,
                                        load_torch_weights as lg_weights)
        matcher = LightGlueFrameMatcher(
            LightGlueMatcher(params=lg_weights(args.lightglue_ckpt), device=dev),
            settings.image_hw)
    slam = build_system(settings, matcher=matcher, device=dev)
    n_kf_loaded = slam.n_kf

    seq = dataset.load_euroc_sequence(args.data_dir)
    paths = seq["image_paths"][: args.max_frames]
    t_cam = seq["t_cam"][: len(paths)]
    stereo = "stereo" in args.sensor
    if stereo:
        paths_r = seq.get("right_image_paths", [])[: len(paths)]
        if len(paths_r) != len(paths):
            print("stereo sensor needs cam1/ in the sequence", file=sys.stderr)
            return 1
    pf = dataset.ImagePrefetcher(paths, depth=8)
    pf_r = dataset.ImagePrefetcher(paths_r, depth=8) if stereo else None
    rr = getattr(slam, "rectification", None)
    maps = None if rr is None else [torch.from_numpy(m).to(dev) for m in (rr.map1, rr.map2)]
    h, w = settings.image_hw
    ext = SuperPointExtractor(
        params=load_torch_weights(args.superpoint_ckpt) if args.superpoint_ckpt else None,
        max_keypoints=settings.n_features, device=dev)

    imu_idx = 0
    t_imu = seq.get("t_imu")
    frames = []

    def stamp():
        # Device syncs only for --frame-log's times: they serialize extraction
        # and tracking.
        if args.frame_log:
            _sync(dev)
        return time.perf_counter()

    t0 = time.perf_counter()
    try:
        for i in range(len(paths)):
            t_a = time.perf_counter()
            img = pf.get(i).astype(np.float32) / 255.0
            t_b = time.perf_counter()
            if img.shape != (h, w):
                print(f"frame {i}: image {img.shape} != settings {(h, w)}", file=sys.stderr)
                return 1
            t_r = t_b
            if stereo:
                img_r = pf_r.get(i).astype(np.float32) / 255.0
                t_r = time.perf_counter()
                pair = torch.from_numpy(np.stack([img, img_r])).to(dev)
                if maps is not None:
                    # Raw rig: both eyes through the rectification maps.
                    pair = torch.stack([rectify.remap(pair[0], maps[0]),
                                        rectify.remap(pair[1], maps[1])])
                out = ext(pair)
            else:
                out = ext(torch.from_numpy(img[None]).to(dev))
            kpts = out["keypoints"][0]
            rays = cameras.unproject(settings.cam_kind, slam.cam_params, kpts)
            t_c = stamp()
            if t_imu is not None and hasattr(slam, "feed_imu") and i > 0:
                while imu_idx < len(t_imu) and t_imu[imu_idx] <= t_cam[i]:
                    # Relative time: track_frame gets t_rel below, and the
                    # preintegrator differences IMU stamps against frame stamps.
                    slam.feed_imu(seq["acc"][imu_idx], seq["gyro"][imu_idx],
                                  float(t_imu[imu_idx] - t_cam[0]))
                    imu_idx += 1
            t_rel = float(t_cam[i] - t_cam[0])
            if stereo:
                info = slam.track_stereo_frame(kpts, rays, out["descriptors"][0],
                                               out["valid"][0], out["keypoints"][1],
                                               out["descriptors"][1], out["valid"][1], t_rel)
            else:
                info = slam.track_frame(kpts, rays, out["descriptors"][0], out["valid"][0],
                                        t_rel)
            t_d = stamp()
            frames.append({"read_ms": (t_b - t_a) * 1e3, **({"read_r_ms": (t_r - t_b) * 1e3}
                                                             if stereo else {}),
                           "extract_ms": (t_c - t_r) * 1e3,
                           "track_ms": (t_d - t_c) * 1e3, "state": int(info.get("state")),
                           "imu_ready": bool(getattr(slam, "imu_ready", False))})
            if i % 50 == 0:
                print(f"frame {i}/{len(paths)} state={info.get('state')} "
                      f"inliers={info.get('n_inliers')}", file=sys.stderr)
    finally:
        pf.close()
        if pf_r is not None:
            pf_r.close()
    _sync(dev)
    wall = time.perf_counter() - t0

    times_, Rs, ts = slam.get_trajectory()
    trajectory.save_tum(args.out, times_ + t_cam[0], Rs, ts)
    if settings.save_atlas:
        # Multi-session persistence (reference System::SaveAtlas on Shutdown;
        # reloaded through System.LoadAtlasFromFile).
        from ..map import atlas
        atlas.save_atlas(slam.state, settings.save_atlas)
        print(f"atlas -> {settings.save_atlas}", file=sys.stderr)
    print(f"{len(paths)} frames in {wall:.1f}s ({len(paths) / wall:.1f} fps); "
          f"trajectory -> {args.out}", file=sys.stderr)

    ate_cm = None
    if args.gt and len(times_) >= 2:
        gt_t, gt_p, _ = trajectory.load_tum(args.gt)
        est_pos = np.stack([-Rs[i].T @ ts[i] for i in range(len(times_))])
        pairs = trajectory.associate_by_time(times_ + t_cam[0], gt_t)
        e = np.stack([est_pos[i] for i, _ in pairs])
        g = np.stack([gt_p[j] for _, j in pairs])
        rmse, _ = trajectory.ate_rmse(e, g, with_scale="inertial" not in args.sensor)
        ate_cm = float(rmse * 100)
        print(f"ATE RMSE: {ate_cm:.2f} cm over {len(pairs)} poses")
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump({"n_kf": int(slam.n_kf), "frames": len(paths),
                       "fps": len(paths) / wall, "ate_cm": ate_cm,
                       "n_loops": len(getattr(slam, "loop_events", [])),
                       "imu_ready": bool(getattr(slam, "imu_ready", False))}, f)
    if args.frame_log:
        with open(args.frame_log, "w") as f:
            json.dump({"n_kf_loaded": n_kf_loaded, "wall_s": wall, "frames": frames,
                       "scale_log": [(k, float(v)) for k, v in getattr(slam, "scale_log", [])]},
                      f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
