"""Motion-only pose optimization: batched Levenberg-Marquardt / Gauss-Newton
on SE(3) with Huber rounds and chi2 inlier re-classification.

Counterpart of rover_slam_tpu/optim/pose_opt.py (`pose_optimization`); its
`lax.scan` over rounds and iterations becomes Python loops. Perturbation is
left-multiplicative, T_cw <- exp([rho, phi]) T_cw. Stereo observations add
a third residual row (the reference's EdgeStereoSE3ProjectXYZOnlyPose).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, cameras
from ..utils import profiling
from . import robust
from .ba import stereo_row
from .blockinv import solve6


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inliers: torch.Tensor   # [M] bool
    n_inliers: torch.Tensor  # 0-dim int32
    chi2: torch.Tensor      # final per-edge chi2


def _residual_jac(R, t, cam_kind, cam_params, Xw, uv, invd=None, bf=None):
    """e = uv - proj(Xc) [M,D], J = de/d[rho, phi] [M,D,6], depth [M]; D = 3
    with stereo observations (invd [M] inverse depth, bf scalar): the row
    r3 = rect*e_u - bf*(invd - 1/z) of ba.stereo_row, zero where invd <= 0."""
    Xc = lie.se3_apply(R, t, Xw)
    e = uv - cameras.project(cam_kind, cam_params, Xc)
    G = -cameras.project_jac(cam_kind, cam_params, Xc)
    if invd is not None and bf is not None:
        e, G = stereo_row(cam_kind, e, G, Xc, invd, bf)
    J = torch.cat([G, -torch.einsum("mij,mjk->mik", G, lie.so3_hat(Xc))], dim=-1)
    return e, J, Xc[..., 2]


@profiling.spanned("pose_opt")
def pose_optimization(R_cw, t_cw, Xw, uv, valid, cam_params,
                      cam_kind: int = cameras.PINHOLE, info=None,
                      rounds: int = 4, iters_per_round: int = 10,
                      chi2_th: float = robust.CHI2_MONO,
                      check_cost: bool = True, invd=None, bf=None) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks Xw [M,3] observed at
    uv [M,2] (valid [M] bool). check_cost=False runs plain damped GN.
    invd/bf: stereo observations; edges with invd > 0 are 3-dim with the
    7.815 chi2 gate (reference EdgeStereoSE3ProjectXYZOnlyPose)."""
    M = Xw.shape[0]
    dev = Xw.device
    if info is None:
        info = torch.ones((M,), dtype=torch.float32, device=dev)
    stereo = invd is not None and bf is not None
    delta2 = torch.where(invd > 0, robust.CHI2_STEREO, chi2_th) if stereo else chi2_th
    validf = valid.float()
    eye6 = torch.eye(6, device=dev)
    R, t = R_cw, t_cw
    inlier_mask = torch.ones((M,), dtype=torch.float32, device=dev)
    chi2 = None
    for round_idx in range(rounds):
        use_kernel = round_idx < rounds - 1
        lam = torch.tensor(1e-3, device=dev)
        for _ in range(iters_per_round):
            e, J, depth = _residual_jac(R, t, cam_kind, cam_params, Xw, uv, invd, bf)
            chi2 = torch.sum(e * e, dim=-1) * info
            w = robust.huber_weight(chi2, delta2) if use_kernel else torch.ones_like(chi2)
            w = w * info * inlier_mask * validf * (depth > 0).float()
            H = torch.einsum("mki,m,mkj->ij", J, w, J)
            b = torch.einsum("mki,m,mk->i", J, w, e)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = -solve6(Hd, b)
            dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
            dR, dt = lie.se3_exp(dx)
            R_new = lie.normalize_rotation(dR @ R)
            t_new = dR @ t + dt
            if check_cost:
                e_new, _, _ = _residual_jac(R_new, t_new, cam_kind, cam_params, Xw, uv,
                                             invd, bf)
                chi2_new = torch.sum(e_new * e_new, dim=-1) * info
                mask_eff = inlier_mask * validf
                if use_kernel:
                    cost_old = torch.sum(robust.huber_cost(chi2, delta2) * mask_eff)
                    cost_new = torch.sum(robust.huber_cost(chi2_new, delta2) * mask_eff)
                else:
                    cost_old = torch.sum(chi2 * mask_eff)
                    cost_new = torch.sum(chi2_new * mask_eff)
                improved = cost_new < cost_old
                R = torch.where(improved, R_new, R)
                t = torch.where(improved, t_new, t)
                lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            else:
                R, t = R_new, t_new
        e, _, depth = _residual_jac(R, t, cam_kind, cam_params, Xw, uv, invd, bf)
        chi2 = torch.sum(e * e, dim=-1) * info
        inlier_mask = ((chi2 <= delta2) & (depth > 0)).float()
    inliers = (inlier_mask > 0) & valid
    return PoseOptResult(R_cw=R, t_cw=t, inliers=inliers,
                         n_inliers=torch.sum(inliers.to(torch.int32)), chi2=chi2)
