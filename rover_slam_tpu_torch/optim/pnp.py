"""PnP RANSAC: camera pose from 3D-2D correspondences (relocalization).

Counterpart of rover_slam_tpu/optim/pnp.py (`_dlt_pose`, `pnp_ransac`):
every hypothesis solves the 6-point DLT and is projected onto SE(3), all
hypotheses batched; the one with the most inliers is polished by the
motion-only pose optimization. The draws come from a torch.Generator, or
from an explicit `samples` [n_hyp, 6] index tensor (the parity tests hand in
the JAX package's own draws).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import cameras, lie
from ..geometry.two_view import draw_samples
from . import pose_opt, robust


class PnPResult(NamedTuple):
    success: torch.Tensor
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _dlt_pose(X: torch.Tensor, x_norm: torch.Tensor):
    """DLT over 6+ points, batched: X [..., M, 3] -> x_norm [..., M, 2]
    (z=1 coordinates) gives P [3, 4] up to scale, projected onto SE(3) with
    the sign that puts the first point in front of the camera."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)          # [..., M, 4]
    zero = torch.zeros_like(Xh)
    u, v = x_norm[..., 0:1], x_norm[..., 1:2]
    A = torch.cat([torch.cat([Xh, zero, -u * Xh], dim=-1),
                   torch.cat([zero, Xh, -v * Xh], dim=-1)], dim=-2)     # [..., 2M, 12]
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    P = Vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    U, S, Vt2 = torch.linalg.svd(P[..., :3])
    det = torch.linalg.det(U @ Vt2)
    one = torch.ones_like(det)
    Dg = torch.stack([one, one, det], dim=-1)
    R = (U * Dg[..., None, :]) @ Vt2
    scale = torch.sum(S * Dg, dim=-1) / 3.0
    scale = torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12), scale)
    t = P[..., 3] / scale[..., None]
    z0 = lie.se3_apply(R, t, X[..., 0, :])[..., 2]
    sign = torch.where(z0 < 0, -1.0, 1.0)
    # -R is not a rotation (det -1): project onto SO(3) again.
    return lie.normalize_rotation(R * sign[..., None, None]), t * sign[..., None]


def pnp_ransac(Xw, uv, valid, cam_params, generator: torch.Generator | None = None,
               cam_kind: int = cameras.PINHOLE, n_hyp: int = 300, min_inliers: int = 10,
               chi2_px: float = robust.CHI2_MONO * 2,
               samples: torch.Tensor | None = None) -> PnPResult:
    """RANSAC over n_hyp 6-point DLT hypotheses drawn among the valid
    correspondences, then the pose optimization on the winner's inliers
    (reference protocol: 300 iterations, minimal set 6)."""
    if samples is None:
        samples = draw_samples(valid, n_hyp, generator, k=6)
    s = samples.long()
    rays = cameras.unproject(cam_kind, cam_params, uv)
    x_norm = rays[:, :2] / rays[:, 2:]
    R, t = _dlt_pose(Xw[s], x_norm[s])                                 # [H,3,3], [H,3]
    Xc = torch.einsum("hij,mj->hmi", R, Xw) + t[:, None, :]
    e2 = torch.sum((cameras.project(cam_kind, cam_params, Xc) - uv) ** 2, dim=-1)
    inl = (e2 < chi2_px) & valid & (Xc[..., 2] > 0.05)                 # [H, M]
    best = torch.argmax(torch.sum(inl, dim=-1, dtype=torch.int32))
    res = pose_opt.pose_optimization(R[best], t[best], Xw, uv, inl[best], cam_params,
                                     cam_kind=cam_kind)
    return PnPResult(success=res.n_inliers >= min_inliers, R_cw=res.R_cw, t_cw=res.t_cw,
                     inliers=res.inliers, n_inliers=res.n_inliers)
