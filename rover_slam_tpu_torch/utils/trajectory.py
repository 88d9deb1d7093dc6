"""ATE evaluation (counterpart of rover_slam_tpu/utils/trajectory.py:
Horn alignment with optimal scale, ATE RMSE, greedy time association)."""
from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """Find s, R, t minimizing ||data - (s R model + t)|| (Horn / Umeyama)."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ mc)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / max((mc ** 2).sum(), 1e-12) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_m


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = True):
    """ATE RMSE after (scaled) Horn alignment. Returns (rmse, aligned_est)."""
    s, R, t = horn_align(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=1)
    return float(np.sqrt((err ** 2).mean())), aligned


def associate_by_time(t_est, t_gt, max_dt=0.02):
    """Greedy timestamp association."""
    pairs = []
    j = 0
    for i, te in enumerate(t_est):
        while j + 1 < len(t_gt) and abs(t_gt[j + 1] - te) <= abs(t_gt[j] - te):
            j += 1
        if abs(t_gt[j] - te) <= max_dt:
            pairs.append((i, j))
    return pairs
