"""Trajectory files and their evaluation (counterpart of
rover_slam_tpu/utils/trajectory.py): quaternion conversions, the TUM and
KITTI trajectory formats (the reference's System::SaveTrajectoryTUM /
SaveTrajectoryKITTI), Horn alignment with optimal scale, ATE and RPE RMSE,
greedy time association. Host numpy: the files match the JAX package's byte
for byte on the same poses."""
from __future__ import annotations

import numpy as np


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[3,3] -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) -> [3,3]."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _world_poses(R_cw, t_cw):
    """Per-frame (R_wc, p_wc) from camera-from-world poses."""
    for R, t in zip(R_cw, t_cw):
        R_wc = np.asarray(R).T
        yield R_wc, -R_wc @ np.asarray(t)


def save_tum(path: str, times, R_cw, t_cw):
    """Write a TUM trajectory, `t tx ty tz qx qy qz qw` (world poses Twc)."""
    with open(path, "w") as f:
        for ti, (R_wc, p) in zip(times, _world_poses(R_cw, t_cw)):
            q = rot_to_quat(R_wc)
            f.write(f"{ti:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def load_tum(path: str):
    """TUM trajectory -> (times [N], positions [N,3], quaternions [N,4])."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def save_kitti(path: str, R_cw, t_cw):
    """Write a KITTI trajectory: per frame the row-major 3x4 world pose
    [R_wc | p_wc], 12 numbers, no timestamps."""
    with open(path, "w") as f:
        for R_wc, p in _world_poses(R_cw, t_cw):
            M = np.concatenate([R_wc, p[:, None]], axis=1).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in M) + "\n")


def load_kitti(path: str):
    """KITTI trajectory -> (R_wc [N,3,3], p_wc [N,3])."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    return data[:, :, :3], data[:, :, 3]


def rpe_rmse(est_R_wc, est_p_wc, gt_R_wc, gt_p_wc, delta: int = 1):
    """Relative pose error over a fixed frame delta (TUM RGB-D protocol):
    E = (Qi^-1 Q(i+d))^-1 (Pi^-1 P(i+d)). Returns (trans_rmse [m], rot_rmse
    [rad]); nan for fewer than delta + 1 poses. Alignment-invariant."""
    n = len(est_p_wc) - delta
    if n <= 0:
        return float("nan"), float("nan")
    terr = np.zeros(n)
    rerr = np.zeros(n)
    for i in range(n):
        dR_e = np.asarray(est_R_wc[i]).T @ np.asarray(est_R_wc[i + delta])
        dp_e = np.asarray(est_R_wc[i]).T @ (
            np.asarray(est_p_wc[i + delta]) - np.asarray(est_p_wc[i]))
        dR_g = np.asarray(gt_R_wc[i]).T @ np.asarray(gt_R_wc[i + delta])
        dp_g = np.asarray(gt_R_wc[i]).T @ (
            np.asarray(gt_p_wc[i + delta]) - np.asarray(gt_p_wc[i]))
        terr[i] = np.linalg.norm(dR_g.T @ (dp_e - dp_g))
        c = np.clip((np.trace(dR_g.T @ dR_e) - 1.0) / 2.0, -1.0, 1.0)
        rerr[i] = np.arccos(c)
    return float(np.sqrt((terr ** 2).mean())), float(np.sqrt((rerr ** 2).mean()))


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
