"""Batched camera models: Pinhole and KannalaBrandt8 (equidistant fisheye).

Counterpart of rover_slam_tpu/geometry/cameras.py. A static `kind` selects
the model; parameters are f32[8]:
  Pinhole:        [fx, fy, cx, cy, 0, 0, 0, 0]
  KannalaBrandt8: [fx, fy, cx, cy, k1, k2, k3, k4]
The KB8 Jacobian is written out in closed form (the JAX package takes it with
jacfwd of the same projection).
"""
from __future__ import annotations

import math

import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1

_NEWTON_ITERS = 10


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def pinhole_project(params, X):
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    z = _safe_z(X[..., 2])
    return torch.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], dim=-1)


def pinhole_unproject(params, uv):
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params, X):
    """d(uv)/dX, [..., 2, 3]."""
    fx, fy = params[..., 0], params[..., 1]
    x, y = X[..., 0], X[..., 1]
    iz = 1.0 / _safe_z(X[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _kb8_poly(theta, k1, k2, k3, k4):
    th2 = theta * theta
    return theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))


def kb8_project(params, X):
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k1, k2, k3, k4 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    theta = torch.atan2(r, z)
    r_th = _kb8_poly(theta, k1, k2, k3, k4)
    scale = torch.where(r2 < 1e-18, torch.zeros_like(r), r_th / r)
    return torch.stack([fx * scale * x + cx, fy * scale * y + cy], dim=-1)


def kb8_unproject(params, uv):
    """Fixed-iteration Newton inverse of r(theta); unit-depth ray z=1."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k1, k2, k3, k4 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = torch.clamp(torch.sqrt(mx * mx + my * my), max=math.pi)
    theta = r_d
    for _ in range(_NEWTON_ITERS):
        th2 = theta * theta
        f = _kb8_poly(theta, k1, k2, k3, k4) - r_d
        fp = 1.0 + th2 * (3.0 * k1 + th2 * (5.0 * k2 + th2 * (7.0 * k3 + th2 * 9.0 * k4)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9, torch.full_like(fp, 1e-9), fp)
    scale = torch.where(r_d < 1e-9, torch.ones_like(r_d),
                        torch.tan(theta) / torch.clamp(r_d, min=1e-12))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params, X):
    """Closed-form d(uv)/dX of kb8_project, [..., 2, 3]: u = fx*s*x + cx with
    s = r(theta)/rho, rho = |(x, y)|, theta = atan2(rho, z)."""
    fx, fy = params[..., 0], params[..., 1]
    k1, k2, k3, k4 = params[..., 4], params[..., 5], params[..., 6], params[..., 7]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = x * x + y * y
    rho = torch.sqrt(torch.clamp(r2, min=1e-18))
    theta = torch.atan2(rho, z)
    th2 = theta * theta
    r_th = _kb8_poly(theta, k1, k2, k3, k4)
    dr_dth = 1.0 + th2 * (3.0 * k1 + th2 * (5.0 * k2 + th2 * (7.0 * k3 + th2 * 9.0 * k4)))
    n2 = r2 + z * z
    # d theta / d(x, y, z)
    dth_dx = z * x / (rho * n2)
    dth_dy = z * y / (rho * n2)
    dth_dz = -rho / n2
    # s = r_th / rho; ds = (dr_dth * dtheta * rho - r_th * drho) / rho^2
    s = r_th / rho
    drho_dx, drho_dy = x / rho, y / rho
    ds_dx = (dr_dth * dth_dx - s * drho_dx) / rho
    ds_dy = (dr_dth * dth_dy - s * drho_dy) / rho
    ds_dz = dr_dth * dth_dz / rho
    small = r2 < 1e-18
    zero = torch.zeros_like(x)
    s = torch.where(small, zero, s)
    ds_dx = torch.where(small, zero, ds_dx)
    ds_dy = torch.where(small, zero, ds_dy)
    ds_dz = torch.where(small, zero, ds_dz)
    row0 = torch.stack([fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz], dim=-1)
    row1 = torch.stack([fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def project(kind: int, params, X):
    if kind == PINHOLE:
        return pinhole_project(params, X)
    if kind == KANNALA_BRANDT8:
        return kb8_project(params, X)
    raise ValueError(f"unknown camera kind {kind}")


def unproject(kind: int, params, uv):
    if kind == PINHOLE:
        return pinhole_unproject(params, uv)
    if kind == KANNALA_BRANDT8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera kind {kind}")


def project_jac(kind: int, params, X):
    if kind == PINHOLE:
        return pinhole_project_jac(params, X)
    if kind == KANNALA_BRANDT8:
        return kb8_project_jac(params, X)
    raise ValueError(f"unknown camera kind {kind}")


def make_pinhole(fx, fy, cx, cy, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device)


def make_kb8(fx, fy, cx, cy, k1, k2, k3, k4, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4], dtype=torch.float32,
                        device=device)
