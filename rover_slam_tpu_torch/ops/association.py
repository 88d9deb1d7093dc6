"""Data association as dense masked tensor ops.

Counterpart of rover_slam_tpu/ops/association.py. Descriptors are unit-norm,
so L2^2 = 2 - 2 cos and the [L, N] distance matrix is one product
(`desc_dist2`, bf16 inputs with a bf16 result as the JAX package computes
it). Mutual nearest-neighbour matching lives in `nn_matcher` (kernel B2) and
is re-exported here under the JAX package's name.
"""
from __future__ import annotations

import torch

from ..geometry import lie, cameras
from .nn_matcher import TH_HIGH, mutual_nn_match  # noqa: F401  (the package's matcher)

TH_LOW = 1.2


def project_landmarks(lm_pos, lm_mask, R_cw, t_cw, cam_params,
                      cam_kind: int = cameras.PINHOLE, image_hw=(480, 640),
                      min_depth: float = 0.1, max_depth=100.0):
    """Project landmarks into a camera with the frustum mask.
    Returns (uv [L,2], depth [L], visible [L])."""
    Xc = lie.se3_apply(R_cw, t_cw, lm_pos)
    uv = cameras.project(cam_kind, cam_params, Xc)
    depth = Xc[..., 2]
    h, w = image_hw
    visible = (lm_mask & (depth > min_depth) & (depth < max_depth)
               & (uv[..., 0] >= 0) & (uv[..., 0] < w)
               & (uv[..., 1] >= 0) & (uv[..., 1] < h))
    return uv, depth, visible


def desc_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, N] squared L2 between unit descriptor sets, one bf16 product."""
    cos = (a.to(torch.bfloat16) @ b.to(torch.bfloat16).T).float()
    return torch.clamp(2.0 - 2.0 * cos, min=0.0)


def projection_match(lm_uv, lm_desc, lm_visible, f_kpts, f_desc, f_valid,
                     radius=15.0, th_desc2: float = TH_HIGH ** 2):
    """Mutual-best landmark <-> keypoint association within a pixel radius
    (scalar or per landmark [L]) and the descriptor gate.
    Returns (kpt_lm_idx [N] int32 with -1, lm_matched [L] bool)."""
    d2 = desc_dist2(lm_desc, f_desc)
    duv = lm_uv[:, None, :] - f_kpts[None, :, :]
    pix2 = torch.sum(duv * duv, dim=-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=lm_uv.device)
    r2 = r * r if r.dim() == 0 else (r * r)[:, None]
    ok = (pix2 <= r2) & lm_visible[:, None] & f_valid[None, :] & (d2 <= th_desc2)
    big = 1e9
    d2m = torch.where(ok, d2, big)
    best_kpt = torch.argmin(d2m, dim=1)
    best_lm = torch.argmin(d2m, dim=0)
    lm_has = torch.gather(d2m, 1, best_kpt[:, None])[:, 0] < big
    L, N = d2m.shape
    mutual = (best_lm[best_kpt] == torch.arange(L, device=d2m.device)) & lm_has
    n_idx = torch.arange(N, device=d2m.device)
    kpt_ok = (best_kpt[best_lm] == n_idx) & mutual[best_lm]
    return torch.where(kpt_ok, best_lm, -1).to(torch.int32), mutual


def invert_matches(matches0: torch.Tensor, n1: int) -> torch.Tensor:
    """matches1 [n1] int32 with matches1[j] = i iff matches0[i] == j (the
    first such i; -1 where none)."""
    n0 = matches0.shape[0]
    tgt = torch.where((matches0 >= 0) & (matches0 < n1), matches0.long(), n1)
    first = torch.full((n1 + 1,), n0, dtype=torch.long, device=matches0.device)
    first = first.scatter_reduce(0, tgt, torch.arange(n0, device=matches0.device),
                                 reduce="amin")[:n1]
    return torch.where(first < n0, first, -1).to(torch.int32)


def epipolar_gate(rays0, rays1, matches0, R01, t01, th: float = 0.01):
    """Keep matches within `th` (z=1-plane units) of both epipolar lines of
    E = [t10]x R10, where x0 = R01 x1 + t01."""
    R10 = R01.transpose(-1, -2)
    t10 = -R10 @ t01
    t10 = t10 / torch.clamp(torch.linalg.norm(t10), min=1e-9)
    E = lie.so3_hat(t10) @ R10
    m = matches0.long().clamp(0, rays1.shape[0] - 1)

    def z1(p):
        z = p[..., 2:]
        return p / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)

    p0 = z1(rays0)
    p1 = z1(rays1[m])
    l1 = p0 @ E.T
    l0 = p1 @ E
    num = torch.abs(torch.sum(p1 * l1, dim=-1))
    d1 = num / torch.clamp(torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2), min=1e-9)
    d0 = num / torch.clamp(torch.sqrt(l0[..., 0] ** 2 + l0[..., 1] ** 2), min=1e-9)
    ok = (matches0 >= 0) & (d0 < th) & (d1 < th)
    return torch.where(ok, matches0, -1).to(torch.int32)


def fuse_duplicates(lm_uv, lm_desc, lm_visible, f_kpts, f_desc, f_valid,
                    radius: float = 3.0, th_desc2: float = TH_LOW ** 2):
    """Per projected landmark, the keypoint slot it collides with (-1 = none)
    (reference SPmatcher::Fuse)."""
    d2 = desc_dist2(lm_desc, f_desc)
    duv = lm_uv[:, None, :] - f_kpts[None, :, :]
    pix2 = torch.sum(duv * duv, dim=-1)
    ok = (pix2 <= radius * radius) & lm_visible[:, None] & f_valid[None, :] \
        & (d2 <= th_desc2)
    d2m = torch.where(ok, d2, 1e9)
    best_kpt = torch.argmin(d2m, dim=1)
    has = torch.gather(d2m, 1, best_kpt[:, None])[:, 0] < 1e9
    return torch.where(has, best_kpt, -1).to(torch.int32)
