"""Trajectory accuracy, plain: greedy time association, Horn / Umeyama
alignment (with scale for a monocular trajectory, without for a metric one)
and the RMSE of the aligned camera centres, in float64 NumPy."""
from __future__ import annotations

import numpy as np


def centres(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of [F,3,3] / [F,3] poses."""
    return -np.einsum("fji,fj->fi", np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64))


def associate(t_est, t_gt, max_dt: float = 0.02) -> list:
    pairs, j = [], 0
    for i, te in enumerate(t_est):
        while j + 1 < len(t_gt) and abs(t_gt[j + 1] - te) <= abs(t_gt[j] - te):
            j += 1
        if abs(t_gt[j] - te) <= max_dt:
            pairs.append((i, j))
    return pairs


def horn(model: np.ndarray, data: np.ndarray, with_scale: bool):
    """s, R, t minimizing |data - (s R model + t)|."""
    mu_m, mu_d = model.mean(0), data.mean(0)
    mc, dc = model - mu_m, data - mu_d
    U, S, Vt = np.linalg.svd(dc.T @ mc)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = (S * np.diag(D)).sum() / max((mc ** 2).sum(), 1e-12) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_m


def ate(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool):
    """(RMSE in the ground truth's units, the alignment's scale)."""
    s, R, t = horn(est_pos, gt_pos, with_scale)
    err = np.linalg.norm((s * (R @ est_pos.T)).T + t - gt_pos, axis=1)
    return float(np.sqrt((err ** 2).mean())), float(s)
