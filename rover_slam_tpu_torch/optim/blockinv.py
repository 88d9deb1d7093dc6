"""Closed-form batched small-block inverses and solves (3x3, 6x6, n x n).

Counterpart of rover_slam_tpu/optim/blockinv.py. The same adjugate / block
Schur formulas are kept (not torch.linalg) so that the port rounds where the
JAX package does and a batch of thousands of tiny systems stays one set of
elementwise kernels on the card.
"""
from __future__ import annotations

import torch


def _eps_guard(det):
    return torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)


def inv3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = _eps_guard(a * A11 + b * A21 + c * A31)
    inv = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return inv / det[..., None, None]


def _block_inv(M, k, inv_a, inv_s):
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    C = M[..., k:, :k]
    D = M[..., k:, k:]
    Ai = inv_a(A)
    AiB = Ai @ B
    Si = inv_s(D - C @ AiB)
    CAi = C @ Ai
    top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], dim=-1)
    bot = torch.cat([-Si @ CAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv6(M):
    """Batched 6x6 inverse via the 3x3 block Schur complement."""
    return _block_inv(M, 3, inv3, inv3)


def chol3(A):
    """Batched lower Cholesky of SPD 3x3 blocks (closed form)."""
    eps = 1e-12
    l11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=eps))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32, min=eps))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], -1),
        torch.stack([l21, l22, z], -1),
        torch.stack([l31, l32, l33], -1),
    ], -2)


def _inv2(A):
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = _eps_guard(a * d - b * c)
    row0 = torch.stack([d, -b], -1)
    row1 = torch.stack([-c, a], -1)
    return torch.stack([row0, row1], -2) / det[..., None, None]


def invn(M):
    """Batched inverse of small SPD-ish [..., n, n] blocks by recursive 2-way
    block Schur complements (same split points as the JAX package)."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / torch.where(torch.abs(M) < 1e-12, torch.full_like(M, 1e-12), M)
    if n == 2:
        return _inv2(M)
    if n == 3:
        return inv3(M)
    k = (n // 2 + 2) // 3 * 3 if n > 4 else n // 2
    k = min(max(k, 1), n - 1)
    return _block_inv(M, k, invn, invn)


def solven(A, b, refine: int = 2):
    """Batched solve via invn plus `refine` rounds of iterative refinement."""
    Ai = invn(A)
    x = torch.einsum("...ij,...j->...i", Ai, b)
    for _ in range(refine):
        r = b - torch.einsum("...ij,...j->...i", A, x)
        x = x + torch.einsum("...ij,...j->...i", Ai, r)
    return x


def solve3(A, b):
    return torch.einsum("...ij,...j->...i", inv3(A), b)


def solve6(A, b):
    return torch.einsum("...ij,...j->...i", inv6(A), b)
