"""Batched two-view triangulation with depth and parallax checks.

Counterpart of rover_slam_tpu/geometry/triangulation.py.
"""
from __future__ import annotations

import torch

from . import lie
from ..optim.blockinv import solve3


def triangulate_dlt(ray0, ray1, R01, t01):
    """DLT triangulation of bearing-ray pairs; x0 = R01 x1 + t01 maps cam1
    points into cam0. Returns points in the cam0 frame [..., 3] (inhomogeneous
    solve through the 3x3 normal equations, as the JAX package does)."""
    R10 = R01.transpose(-1, -2)
    t10 = -torch.einsum("...ij,...j->...i", R10, t01)
    batch = ray0.shape[:-1]
    P0 = torch.cat([torch.eye(3, dtype=ray0.dtype, device=ray0.device),
                    torch.zeros((3, 1), dtype=ray0.dtype, device=ray0.device)], dim=1)
    P0 = P0.expand(*batch, 3, 4)
    P1 = torch.cat([R10, t10[..., :, None]], dim=-1).expand(*batch, 3, 4)

    def two_rows(P, ray):
        x, y, z = ray[..., 0:1], ray[..., 1:2], ray[..., 2:3]
        return x * P[..., 2, :] - z * P[..., 0, :], y * P[..., 2, :] - z * P[..., 1, :]

    a0, a1 = two_rows(P0, ray0)
    a2, a3 = two_rows(P1, ray1)
    A = torch.stack([a0, a1, a2, a3], dim=-2)
    A3 = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", A3, A3)
    Atb = torch.einsum("...ki,...k->...i", A3, b)
    AtA = AtA + 1e-9 * torch.eye(3, dtype=A.dtype, device=A.device)
    return solve3(AtA, Atb)


def parallax_cos(ray0, ray1_in0):
    n0 = ray0 / torch.clamp(torch.linalg.norm(ray0, dim=-1, keepdim=True), min=1e-12)
    n1 = ray1_in0 / torch.clamp(torch.linalg.norm(ray1_in0, dim=-1, keepdim=True),
                                min=1e-12)
    return torch.sum(n0 * n1, dim=-1)


def triangulate_and_check(ray0, ray1, R0w, t0w, R1w, t1w,
                          min_parallax_cos: float = 0.9998):
    """Triangulate in the world frame (Tcw poses); returns (Xw [..., 3],
    valid [...]) with cheirality along each bearing and the parallax gate."""
    R1w_inv, t1w_inv = lie.se3_inverse(R1w, t1w)
    R01, t01 = lie.se3_compose(R0w, t0w, R1w_inv, t1w_inv)
    Xc0 = triangulate_dlt(ray0, ray1, R01, t01)
    R0w_inv, t0w_inv = lie.se3_inverse(R0w, t0w)
    Xw = lie.se3_apply(R0w_inv, t0w_inv, Xc0)
    z0 = torch.sum(ray0 * Xc0, dim=-1)
    z1 = torch.sum(ray1 * lie.se3_apply(R1w, t1w, Xw), dim=-1)
    cosp = parallax_cos(ray0, torch.einsum("...ij,...j->...i", R01, ray1))
    valid = (z0 > 0) & (z1 > 0) & (cosp < min_parallax_cos) & (cosp > -0.5)
    return Xw, valid


def reprojection_error2(params_project, Xc: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Squared pixel reprojection error given a projection closure."""
    duv = params_project(Xc) - uv
    return torch.sum(duv * duv, dim=-1)
