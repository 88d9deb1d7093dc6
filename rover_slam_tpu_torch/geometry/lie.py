"""Batched SO(3) / SE(3) on tensors with arbitrary leading batch dimensions.

Counterpart of rover_slam_tpu/geometry/lie.py: SO(3), SE(3) and Sim(3).
Rotations are 3x3 matrices, translations 3-vectors; small-angle branches use
`torch.where` with safe denominators exactly as the JAX package does, so the
functions also run under `torch.func` transforms (the pose graph takes their
forward-mode Jacobians).
"""
from __future__ import annotations

import math

import torch

from ..optim.blockinv import inv3

_EPS = 1e-8


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w[..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-safe."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: w[..., 3] -> R[..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = so3_hat(w)
    return _eye(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]; generic, small-angle and near-pi branches."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w_skew = so3_vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    w_generic = w_skew * (theta / torch.clamp(sin_t, min=1e-12))[..., None]
    w_small = w_skew * (1.0 + theta[..., None] ** 2 / 6.0)
    Rp = R + _eye(R)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(Rp, -1, idx)[..., 0]
    axis = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-12)
    sgn = torch.sign(torch.sum(axis * w_skew, dim=-1, keepdim=True))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    w_pi = axis * sgn * theta[..., None]
    small = (theta < 1e-5)[..., None]
    near_pi = (theta > math.pi - 1e-3)[..., None]
    return torch.where(small, w_small, torch.where(near_pi, w_pi, w_generic))


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = so3_hat(w)
    return _eye(w) - B[..., None, None] * W + C[..., None, None] * (W @ W)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = so3_hat(w)
    small = theta2 < 1e-8
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 / theta2) - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.sin(theta) + _EPS))
    return _eye(w) + 0.5 * W + coef[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    return so3_right_jacobian(-w)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    return so3_right_jacobian_inv(-w)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD. A non-finite input gives
    NaN, as the JAX package's SVD returns it (torch's SVD raises on one):
    an LM step that diverged is then rejected by its cost test."""
    finite = torch.isfinite(R).all(dim=-1).all(dim=-1)[..., None, None]
    U, _, Vt = torch.linalg.svd(torch.where(finite, R, _eye(R)))
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return torch.where(finite, (U * D[..., None, :]) @ Vt, torch.nan)


def se3_exp(xi: torch.Tensor):
    """xi = [rho(3), phi(3)] -> (R, t) with t = Jl(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, X):
    """Transform points X[..., 3]."""
    return torch.einsum("...ij,...j->...i", R, X) + t


def se3_matrix(R, t):
    """(R, t) -> [..., 4, 4] homogeneous matrix."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3): (s scalar, R, t). Acts as X -> s R X + t.
# ---------------------------------------------------------------------------

def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The [..., 3, 3] matrix W(sigma, phi) with t = W rho (Sophus calcW)."""
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = so3_hat(phi)
    W2 = W @ W
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    sigma_safe = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    theta_safe = torch.where(small_theta, torch.ones_like(theta), theta)
    c0 = torch.where(small_sigma, torch.ones_like(s), (s - 1.0) / sigma_safe)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    denom = sigma_safe * sigma_safe + theta_safe * theta_safe
    c1_gen = (sigma_safe * a_ + (1.0 - b_) * theta_safe) / (theta_safe * denom)
    c2_gen = (c0 - ((b_ - 1.0) * sigma_safe + a_ * theta_safe) / denom) \
        / (theta_safe * theta_safe)
    _, B0, C0 = _sinc_coeffs(theta2)
    # theta -> 0 with sigma generic.
    c1_th0 = torch.where(small_sigma, torch.full_like(s, 0.5),
                         ((sigma_safe - 1.0) * s + 1.0) / (sigma_safe * sigma_safe))
    c2_th0 = torch.where(
        small_sigma, torch.full_like(s, 1.0 / 6.0),
        (s * (0.5 * sigma_safe * sigma_safe - sigma_safe + 1.0) - 1.0) / (sigma_safe ** 3))
    c1 = torch.where(small_sigma, B0, torch.where(small_theta, c1_th0, c1_gen))
    c2 = torch.where(small_sigma, C0, torch.where(small_theta, c2_th0, c2_gen))
    return (c0[..., None, None] * _eye(phi) + c1[..., None, None] * W
            + c2[..., None, None] * W2)


def sim3_exp(xi: torch.Tensor):
    """xi = [rho(3), phi(3), sigma(1)] -> (s, R, t), s = exp(sigma)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(phi, sigma), rho)
    return torch.exp(sigma), so3_exp(phi), t


def sim3_log(s, R, t) -> torch.Tensor:
    """Inverse of sim3_exp: rho solves W rho = t through the closed-form 3x3
    inverse (no solver whose error check would sync with the host)."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.einsum("...ij,...j->...i", inv3(_sim3_W(phi, sigma)), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) * (sb,Rb,tb): X -> sa Ra (sb Rb X + tb) + ta."""
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def sim3_apply(s, R, t, X):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, X) + t
