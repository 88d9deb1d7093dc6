"""Motion-only pose optimization: batched Levenberg-Marquardt / Gauss-Newton
on SE(3) with Huber rounds and chi2 inlier re-classification.

Counterpart of rover_slam_tpu/optim/pose_opt.py (`pose_optimization`).
Perturbation is left-multiplicative, T_cw <- exp([rho, phi]) T_cw. Stereo
observations add a third residual row (the reference's
EdgeStereoSE3ProjectXYZOnlyPose).

Routing: CPU tensors go to `pose_optimization_plain`, where the JAX
package's `lax.scan` over rounds and iterations becomes Python loops; CUDA
tensors go to the kernel in csrc/pose_opt.cu, which runs the whole call in
one launch with no host sync, or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..geometry import lie, cameras
from ..ops import _build
from ..utils import profiling
from . import robust
from .ba import stereo_row
from .blockinv import solve6


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inliers: torch.Tensor   # [M] bool
    n_inliers: torch.Tensor  # 0-dim int64
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


# Counter of utils/profiling.py's registry: kernel launches, one a call, by
# "{M}x{rounds}x{iters}" with "/stereo" for stereo observations
# ("pose_opt_launches").


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
    args = (R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
            iters_per_round, chi2_th, check_cost, invd, bf)
    if Xw.device.type == "cpu":
        return pose_optimization_plain(*args)
    return _launch(*args)


def pose_optimization_plain(R_cw, t_cw, Xw, uv, valid, cam_params,
                            cam_kind: int = cameras.PINHOLE, info=None,
                            rounds: int = 4, iters_per_round: int = 10,
                            chi2_th: float = robust.CHI2_MONO,
                            check_cost: bool = True, invd=None, bf=None) -> PoseOptResult:
    """Plain PyTorch version of pose_optimization: Python loops of batched
    ops, two host syncs an iteration (lie.normalize_rotation's SVD)."""
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


def _check(name, x, dev, shape, dtype=torch.float32):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on dev
    (shape None: one element)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"pose_opt: {name} must be a tensor on {dev}, got {type(x).__name__}")
    if x.device != dev:
        raise ValueError(f"pose_opt: {name} on {x.device}, the points on {dev}")
    if x.dtype != dtype:
        raise ValueError(f"pose_opt: {name} is {x.dtype}, the kernel takes {dtype}")
    if (x.numel() != 1) if shape is None else (tuple(x.shape) != shape):
        raise ValueError(f"pose_opt: {name} has shape {tuple(x.shape)}, needs "
                         f"{'one element' if shape is None else shape}")
    if not x.is_contiguous():
        raise ValueError(f"pose_opt: {name} is not contiguous")


def check_args(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
               iters_per_round, invd, bf) -> tuple[int, bool]:
    """Raise on what the kernel does not take (everything but the device
    type: all on Xw's device, float32 but valid's bool, shapes, contiguity,
    bf a one-element tensor). Returns (M, stereo)."""
    dev = Xw.device
    if Xw.dim() != 2:
        raise ValueError(f"pose_opt: Xw has shape {tuple(Xw.shape)}, needs [M, 3]")
    M = Xw.shape[0]
    stereo = invd is not None and bf is not None
    _check("R_cw", R_cw, dev, (3, 3))
    _check("t_cw", t_cw, dev, (3,))
    _check("Xw", Xw, dev, (M, 3))
    _check("uv", uv, dev, (M, 2))
    _check("valid", valid, dev, (M,), torch.bool)
    _check("cam_params", cam_params, dev, (8,))
    if info is not None:
        _check("info", info, dev, (M,))
    if stereo:
        _check("invd", invd, dev, (M,))
        _check("bf", bf, dev, None)
    if cam_kind not in (cameras.PINHOLE, cameras.KANNALA_BRANDT8):
        raise ValueError(f"pose_opt: unknown camera kind {cam_kind}")
    if rounds < 1 or iters_per_round < 0:
        raise ValueError(f"pose_opt: rounds {rounds} (needs >= 1), iterations "
                         f"{iters_per_round} (needs >= 0)")
    return M, stereo


def _launch(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
            iters_per_round, chi2_th, check_cost, invd, bf) -> PoseOptResult:
    """One launch of csrc/pose_opt.cu; outputs allocated here, nothing read
    back to the host."""
    dev = Xw.device
    if dev.type != "cuda":
        raise ValueError(f"pose_opt: unsupported device {dev}")
    M, stereo = check_args(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
                           iters_per_round, invd, bf)
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((3,), dtype=torch.float32, device=dev)
    inliers = torch.empty((M,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    chi2 = torch.empty((M,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.pose_opt(R_cw.data_ptr(), t_cw.data_ptr(), Xw.data_ptr(), uv.data_ptr(),
                              valid.data_ptr(), cam_params.data_ptr(),
                              info.data_ptr() if info is not None else None,
                              invd.data_ptr() if stereo else None,
                              bf.data_ptr() if stereo else None,
                              R.data_ptr(), t.data_ptr(), inliers.data_ptr(),
                              n_inliers.data_ptr(), chi2.data_ptr(), M, cam_kind, rounds,
                              iters_per_round, int(bool(check_cost)), float(chi2_th), stream)
    _build.check(status, "pose_opt")
    profiling.count("pose_opt_launches",
                    f"{M}x{rounds}x{iters_per_round}" + ("/stereo" if stereo else ""))
    return PoseOptResult(R_cw=R, t_cw=t, inliers=inliers, n_inliers=n_inliers, chi2=chi2)


def _lib():
    lib = _build.load("pose_opt")
    fn = lib.pose_opt
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
