#!/usr/bin/env python3
"""ATE evaluation of a TUM-format trajectory against ground truth: the
reference's offline protocol (evaluation/evaluate_ate_scale.py, Horn
alignment with optimal scale for monocular; evaluation/associate.py for
timestamp association) on the port's trajectory module. Numpy only.

Usage (as a module or as this file):
  python -m rover_slam_tpu_torch.apps.evaluate_ate_scale GT_FILE EST_FILE \
      [--max_difference 0.02] [--no_scale] [--verbose]

Files: `t tx ty tz qx qy qz qw` per line (# comments allowed), timestamps in
seconds (ns-epoch stamps are scaled). Prints `rmse,scale` (meters) on one
line like the reference, or full statistics with --verbose.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from rover_slam_tpu_torch.utils import trajectory  # noqa: E402


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 4:
                rows.append(vals[:8])
    arr = np.asarray(rows)
    t = arr[:, 0]
    if t.max() > 1e14:      # ns-epoch timestamps (EuRoC GT files)
        t = t * 1e-9
    return t, arr[:, 1:4]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gt_file")
    ap.add_argument("est_file")
    ap.add_argument("--max_difference", type=float, default=0.02)
    ap.add_argument("--no_scale", action="store_true",
                    help="rigid alignment only (stereo/inertial: metric ATE)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    t_gt, p_gt = load(args.gt_file)
    t_est, p_est = load(args.est_file)
    pairs = trajectory.associate_by_time(t_est, t_gt, max_dt=args.max_difference)
    if len(pairs) < 2:
        print("error: fewer than 2 associated pairs", file=sys.stderr)
        sys.exit(1)
    e = p_est[[i for i, _ in pairs]]
    g = p_gt[[j for _, j in pairs]]
    s, R, t = trajectory.horn_align(e, g, with_scale=not args.no_scale)
    aligned = (s * (R @ e.T)).T + t
    err = np.linalg.norm(aligned - g, axis=1)
    rmse = float(np.sqrt((err ** 2).mean()))
    if args.verbose:
        print(f"compared_pose_pairs {len(pairs)} pairs")
        print(f"alignment_scale {s:.6f}")
        print(f"absolute_translational_error.rmse {rmse:.6f} m")
        print(f"absolute_translational_error.mean {err.mean():.6f} m")
        print(f"absolute_translational_error.median {np.median(err):.6f} m")
        print(f"absolute_translational_error.std {err.std():.6f} m")
        print(f"absolute_translational_error.min {err.min():.6f} m")
        print(f"absolute_translational_error.max {err.max():.6f} m")
    else:
        print(f"{rmse:.6f},{s:.6f}")


if __name__ == "__main__":
    main()
