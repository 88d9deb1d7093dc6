"""Monocular two-view initialization: batched essential / homography RANSAC,
LO refit of the leading hypotheses, model selection and motion
disambiguation.

Counterpart of rover_slam_tpu/geometry/two_view.py (`reconstruct`). Works on
z=1-plane coordinates. The RANSAC draws come from a torch.Generator, or from
an explicit `samples` [n_hyp, 8] index tensor (the parity test hands in the
JAX package's own draws, since the two generators give different numbers).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import triangulation
from ..ops.scatterless import top_k

CHI2_F = 3.841
CHI2_H = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor        # bool
    R_21: torch.Tensor           # [3,3] x2 = R x1 + t
    t_21: torch.Tensor           # [3] (unit scale)
    points3d: torch.Tensor       # [M,3] in cam1 frame
    is_triangulated: torch.Tensor  # [M] bool
    used_homography: torch.Tensor  # bool


def _hartley_T(x, w):
    """Normalization: center + isotropic scale to RMS sqrt(2). x [...,M,2],
    w [...,M]."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(x * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((x - mean[..., None, :]) ** 2, dim=-1))
    rms = torch.sum(d * w, dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(rms, min=1e-9)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * mean[..., 0]], -1),
                     torch.stack([z, s, -s * mean[..., 1]], -1),
                     torch.stack([z, z, o], -1)], -2)
    return T, (x - mean[..., None, :]) * s[..., None, None]


def _eight_point_E(x1, x2, w=None):
    """(Weighted) normalized 8-point E, batched over leading dims."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    T1, x1n = _hartley_T(x1, w)
    T2, x2n = _hartley_T(x2, w)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w[..., None]
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    # The last row of Vt, as the JAX package reads Vt[8]: with 9+ points that
    # is the null vector; for a minimal 8-point sample Vt has 8 rows and JAX
    # clamps the index to row 7 (matched here, not mended).
    En = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    E = T2.transpose(-1, -2) @ En @ T1
    U, S, Vt2 = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    Sd = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * Sd[..., None, :]) @ Vt2


def _four_point_H(x1, x2):
    """DLT homography from 4 points, batched: x1, x2 [...,4,2] -> H [...,3,3]."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    o, z = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(x1.shape[:-2] + (8, 9))
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    H = Vt[..., 8, :].reshape(x1.shape[:-2] + (3, 3))
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-9, torch.full_like(h22, 1e-9), h22)


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epi_chi2(E, x1, x2, sigma2):
    """Symmetric epipolar chi2 per point; E [...,3,3], x [M,2]."""
    p1, p2 = _homog(x1), _homog(x2)
    l2 = p1 @ E.transpose(-1, -2)
    l1 = p2 @ E
    d2 = torch.sum(p2 * l2, -1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(p1 * l1, -1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1 / sigma2, d2 / sigma2


def _h_chi2(H, x1, x2, sigma2):
    """Symmetric transfer chi2 per point; H [...,3,3]. A singular H (a
    degenerate sample) gets a non-finite inverse and scores nothing, as
    jnp.linalg.inv gives it, instead of raising."""
    p1, p2 = _homog(x1), _homog(x2)
    Hp1 = p1 @ H.transpose(-1, -2)
    Hinv = torch.linalg.inv_ex(H + 1e-12 * torch.eye(3, device=H.device)).inverse
    Hp2 = p2 @ Hinv.transpose(-1, -2)

    def dehom(P):
        return P[..., :2] / torch.clamp(torch.abs(P[..., 2:]), min=1e-9) \
            * torch.sign(P[..., 2:] + 1e-30)

    e12 = torch.sum((x2 - dehom(Hp1)) ** 2, -1)
    e21 = torch.sum((x1 - dehom(Hp2)) ** 2, -1)
    return e21 / sigma2, e12 / sigma2


def _decompose_E(E):
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H):
    """Faugeras SVD decomposition into 8 candidate motions."""
    U, S, Vt = torch.linalg.svd(H)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    aux_st = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    aux_sp = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    Rs, ts = [], []
    for i in range(4):
        Rp = torch.stack([torch.stack([ct, zero, -st[i]]), torch.stack([zero, one, zero]),
                          torch.stack([st[i], zero, ct])])
        tp = torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3)
        Rs.append(s * U @ Rp @ Vt)
        tt = U @ tp
        ts.append(tt / torch.clamp(torch.linalg.norm(tt), min=1e-12))
    for i in range(4):
        Rp = torch.stack([torch.stack([cp, zero, sp[i]]), torch.stack([zero, -one, zero]),
                          torch.stack([sp[i], zero, -cp])])
        tp = torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3)
        Rs.append(s * U @ Rp @ Vt)
        tt = U @ tp
        ts.append(tt / torch.clamp(torch.linalg.norm(tt), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def _score_motion(R, t, x1, x2, mask, sigma2, min_parallax_cos=0.99998):
    """Triangulate all points under one motion and count the good ones
    (reference CheckRT). Returns (n_good, Xw, ok, cos of the 50th-largest
    parallax)."""
    ray1, ray2 = _homog(x1), _homog(x2)
    eye = torch.eye(3, device=x1.device)
    Xw, valid = triangulation.triangulate_and_check(
        ray1, ray2, eye, torch.zeros(3, device=x1.device), R, t,
        min_parallax_cos=1.1)
    z1 = Xw[:, 2]
    safe1 = torch.where(torch.abs(z1[:, None]) < 1e-9, torch.full_like(z1[:, None], 1e-9),
                        z1[:, None])
    uv1 = Xw[:, :2] / safe1
    Xc2 = (R @ Xw.T).T + t
    z2 = Xc2[:, 2]
    safe2 = torch.where(torch.abs(z2[:, None]) < 1e-9, torch.full_like(z2[:, None], 1e-9),
                        z2[:, None])
    uv2 = Xc2[:, :2] / safe2
    e1 = torch.sum((uv1 - x1) ** 2, 1) / sigma2
    e2 = torch.sum((uv2 - x2) ** 2, 1) / sigma2
    c2_in_1 = -R.T @ t
    n2 = Xw - c2_in_1
    cosp = torch.sum(Xw * n2, 1) / torch.clamp(
        torch.linalg.norm(Xw, dim=1) * torch.linalg.norm(n2, dim=1), min=1e-12)
    good = (mask & valid & (z1 > 0) & (z2 > 0)
            & (e1 < 4.0 * CHI2_F) & (e2 < 4.0 * CHI2_F))
    ok = good & (cosp < min_parallax_cos)
    n_good = torch.sum(ok.to(torch.int32))
    cos_sorted = torch.sort(torch.where(ok, cosp, 2.0)).values
    idx50 = torch.clamp(torch.minimum(n_good - 1, torch.tensor(50, device=x1.device)),
                        0, cosp.shape[0] - 1)
    return n_good, Xw, ok, cos_sorted[idx50]


def draw_samples(mask: torch.Tensor, n_hyp: int, generator: torch.Generator,
                 k: int = 8):
    """[n_hyp, k] indices drawn with replacement, uniformly among the valid
    entries (the JAX package's weighted jax.random.choice), uniformly among
    all when none is valid. Fetches the mask to the host."""
    p = mask.float().cpu()
    if not bool(p.any()):
        p = torch.ones_like(p)
    draws = torch.multinomial(p, n_hyp * k, replacement=True, generator=generator)
    return draws.reshape(n_hyp, k).to(mask.device)


def reconstruct(x1, x2, mask, generator: torch.Generator | None = None,
                sigma_n: float = 0.0022, n_hyp: int = 400,
                min_inliers: int = 50, h_ratio: float = 0.45,
                samples: torch.Tensor | None = None) -> TwoViewResult:
    """Full two-view reconstruction. x1, x2: [M,2] matched z=1-plane coords;
    mask [M] valid matches; sigma_n measurement sigma in normalized units.
    `samples` [n_hyp, 8] overrides the RANSAC draws."""
    sigma2 = sigma_n * sigma_n
    if samples is None:
        samples = draw_samples(mask, n_hyp, generator)
    samples = samples.long()
    xs1, xs2 = x1[samples], x2[samples]          # [n_hyp, 8, 2]
    maskf = mask.float()

    Es = _eight_point_E(xs1, xs2)
    e1, e2 = _epi_chi2(Es, x1, x2, sigma2)      # [n_hyp, M]
    score_pt_F = (torch.where(e1 < CHI2_F, CHI2_H - e1, 0.0)
                  + torch.where(e2 < CHI2_F, CHI2_H - e2, 0.0)) * maskf
    inl_F = (e1 < CHI2_F) & (e2 < CHI2_F) & mask
    scores_F = torch.sum(score_pt_F, dim=1)
    SF = scores_F.max()

    Hs = _four_point_H(xs1[:, :4], xs2[:, :4])
    h1, h2 = _h_chi2(Hs, x1, x2, sigma2)
    score_pt_H = (torch.where(h1 < CHI2_H, CHI2_H - h1, 0.0)
                  + torch.where(h2 < CHI2_H, CHI2_H - h2, 0.0)) * maskf
    scores_H = torch.sum(score_pt_H, dim=1)
    best_H = torch.argmax(scores_H)
    SH = scores_H[best_H]
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > h_ratio

    # LO-RANSAC: refit the top-8 essential hypotheses on their consensus.
    _, top_idx = top_k(scores_F, 8)
    inl_H = (h1[best_H] < CHI2_H) & (h2[best_H] < CHI2_H) & mask
    return select_motion(x1, x2, mask, Es[top_idx], inl_F[top_idx], Hs[best_H], inl_H,
                         use_H, sigma2, min_inliers)


def select_motion(x1, x2, mask, E_top, inl_top, H_best, inl_H, use_H, sigma2: float,
                  min_inliers: int) -> TwoViewResult:
    """`reconstruct` past its hypothesis scoring: the LO refit of the leading
    essential hypotheses E_top [k,3,3] on their inlier sets inl_top [k,M],
    the candidate motions of the refit winner and of the best homography
    H_best (inliers inl_H), model selection by use_H, and the triangulation
    gate. Split out so that a caller can hand in another runtime's leaders:
    a minimal sample that repeats a match leaves its 8-point fit to the SVD's
    rounding, so the leaders themselves are not a function of the inputs."""
    dev = x1.device
    k = E_top.shape[0]
    E_b, inl_b = E_top, inl_top
    for _ in range(3):
        E_r = _eight_point_E(x1.expand(k, -1, -1), x2.expand(k, -1, -1), inl_b.float())
        e1r, e2r = _epi_chi2(E_r, x1, x2, sigma2)
        inl_r = (e1r < CHI2_F) & (e2r < CHI2_F) & mask
        better = inl_r.sum(1) >= inl_b.sum(1)
        E_b = torch.where(better[:, None, None], E_r, E_b)
        inl_b = torch.where(better[:, None], inl_r, inl_b)
    best_lo = torch.argmax(inl_b.sum(1))
    E_best = E_b[best_lo]
    inl_F_best = inl_b[best_lo]

    Rs_E, ts_E = _decompose_E(E_best)
    Rs_H, ts_H = _decompose_H(H_best)
    Rs = torch.cat([Rs_E, Rs_H])
    ts = torch.cat([ts_E, ts_H])
    model_mask_E = torch.arange(12, device=dev) < 4
    model_sel = torch.where(use_H, ~model_mask_E, model_mask_E)
    inlier_mask = torch.where(use_H, inl_H, inl_F_best)
    outs = [_score_motion(Rs[i], ts[i], x1, x2, inlier_mask, sigma2) for i in range(12)]
    n_goods = torch.stack([o[0] for o in outs])
    Xws = torch.stack([o[1] for o in outs])
    goods = torch.stack([o[2] for o in outs])
    med_cos = torch.stack([o[3] for o in outs])
    n_goods = torch.where(model_sel, n_goods, -1)
    best_m = torch.argmax(n_goods)
    n_best = n_goods[best_m]
    n_similar = torch.sum((n_goods > 0.7 * n_best).to(torch.int32))
    parallax_ok = med_cos[best_m] < math.cos(math.radians(1.0))
    success = ((n_best >= min_inliers)
               & (n_best >= 0.8 * torch.sum(inlier_mask.to(torch.int32)))
               & (n_similar == 1) & parallax_ok)
    return TwoViewResult(success=success, R_21=Rs[best_m], t_21=ts[best_m],
                         points3d=Xws[best_m],
                         is_triangulated=goods[best_m] & success,
                         used_homography=use_H)
