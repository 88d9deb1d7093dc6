"""Sim(3) estimation: Horn closed form, batched RANSAC and the Gauss-Newton
refit of loop verification.

Counterpart of rover_slam_tpu/optim/sim3_solver.py. Every RANSAC hypothesis
is evaluated in one batch. The draws come from a torch.Generator through
`two_view.draw_samples`, or from an explicit `samples` [n_hyp, 3] index
tensor (the parity tests hand in the JAX package's own draws). The GN refit
takes its Jacobians in closed form: the JAX package differentiates the same
residuals with `jax.jacfwd` at the zero perturbation, which these equal up to
rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import cameras, lie
from ..geometry.two_view import draw_samples


def horn_sim3(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor | None = None,
              fix_scale: bool = False):
    """Closed-form Sim3 (s, R, t) minimizing ||Q - (s R P + t)||^2 over
    [..., M, 3] correspondences with optional weights [..., M] (Horn's method
    through the SVD)."""
    if w is None:
        w = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu_p = torch.sum(P * w[..., None], dim=-2) / wsum[..., None]
    mu_q = torch.sum(Q * w[..., None], dim=-2) / wsum[..., None]
    Pc = P - mu_p[..., None, :]
    Qc = Q - mu_q[..., None, :]
    W = torch.einsum("...mi,...m,...mj->...ij", Qc, w, Pc)
    U, S, Vt = torch.linalg.svd(W)
    d = torch.sign(torch.linalg.det(U @ Vt))
    one = torch.ones_like(d)
    Dg = torch.stack([one, one, d], dim=-1)
    R = (U * Dg[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones_like(d)
    else:
        var_p = torch.sum(w[..., None] * Pc * Pc, dim=(-2, -1))
        s = torch.sum(S * Dg, dim=-1) / torch.clamp(var_p, min=1e-12)
    t = mu_q - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_p)
    return s, R, t


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def sim3_ransac(X1, X2, mask, uv1, uv2, cam_params, generator=None,
                n_hyp: int = 300, min_inliers: int = 20, chi2_px: float = 9.21,
                fix_scale: bool = False, cam_kind: int = cameras.PINHOLE,
                has1=None, has2=None, samples: torch.Tensor | None = None) -> Sim3Result:
    """RANSAC Sim3 S21 from 3D-3D correspondences X1, X2 [M, 3] (camera
    frames 1 and 2) with image-space inlier checks in both images. has1/has2
    say which side of a pair carries a real map point: hypotheses sample
    pairs with both sides real, one-sided pairs are credited through the one
    projection check defined for them."""
    if has1 is None:
        has1 = torch.ones_like(mask)
    if has2 is None:
        has2 = torch.ones_like(mask)
    both = mask & has1 & has2
    if samples is None:
        samples = draw_samples(both, n_hyp, generator, k=3)
    samples = samples.long()

    def score(s21, R21, t21):
        """Inlier masks [..., M] of hypotheses with leading dims."""
        s12 = 1.0 / torch.clamp(s21, min=1e-9)
        R12 = R21.transpose(-1, -2)
        t12 = -s12[..., None] * torch.einsum("...ij,...j->...i", R12, t21)
        X2_in_1 = s12[..., None, None] * torch.einsum("...ij,mj->...mi", R12, X2) \
            + t12[..., None, :]
        X1_in_2 = s21[..., None, None] * torch.einsum("...ij,mj->...mi", R21, X1) \
            + t21[..., None, :]
        e1 = torch.sum((cameras.project(cam_kind, cam_params, X2_in_1) - uv1) ** 2, -1)
        e2 = torch.sum((cameras.project(cam_kind, cam_params, X1_in_2) - uv2) ** 2, -1)
        ok1 = (e1 < chi2_px) | ~has2
        ok2 = (e2 < chi2_px) | ~has1
        return ok1 & ok2 & mask & (has1 | has2)

    ss, Rs, ts = horn_sim3(X1[samples], X2[samples], fix_scale=fix_scale)   # [H]
    inls = score(ss, Rs, ts)                                                  # [H, M]
    n_inl = torch.sum(inls, dim=-1, dtype=torch.int32)
    best = torch.argmax(n_inl)
    inl_b = inls[best]
    w = (inl_b & both).float()
    s_r, R_r, t_r = horn_sim3(X1, X2, w, fix_scale=fix_scale)
    inl_r = score(s_r, R_r, t_r)
    better = torch.sum(inl_r, dtype=torch.int32) >= n_inl[best]
    s_f = torch.where(better, s_r, ss[best])
    R_f = torch.where(better, R_r, Rs[best])
    t_f = torch.where(better, t_r, ts[best])
    inl_f = torch.where(better, inl_r, inl_b)
    n_f = torch.sum(inl_f, dtype=torch.int32)
    return Sim3Result(success=n_f >= min_inliers, s=s_f, R=R_f, t=t_f,
                      inliers=inl_f, n_inliers=n_f)


def _accumulate(J, r, w, JTJ, JTr):
    Jw = J * w[:, None, None]
    return (JTJ + torch.einsum("mij,mik->jk", Jw, J),
            JTr + torch.einsum("mij,mi->j", Jw, r))


def sim3_gn_refine(X, uv, w_mask, s0, R0, t0, cam_params,
                   cam_kind: int = cameras.PINHOLE, iters: int = 8,
                   fix_scale: bool = False, huber_px: float = 3.0,
                   chi2_px: float = 9.21, X_bwd=None, uv_bwd=None, w_bwd=None,
                   X_src3=None, X_dst3=None, w_3d=None):
    """Gauss-Newton refit of a Sim3 (source camera -> target camera) on
    forward reprojections of source points X into the target image uv, with
    optional backward reprojections (target points X_bwd into the source
    image through the inverse Sim3) and 3D-3D pairs weighted by w_3d, Huber
    IRLS weights and relative Levenberg damping. The update is left
    multiplicative, p = (omega, tau, sigma): R' = exp(omega) R,
    t' = exp(omega) t + tau, s' = s exp(sigma). Returns (s, R, t,
    n_inliers), the count of forward matches under chi2_px after the refit."""
    dev = X.device
    wm = w_mask.float()
    eye3 = torch.eye(3, device=dev)
    eye7 = torch.eye(7, device=dev)
    lim = torch.tensor([0.5] * 6 + [0.3], device=dev)   # step clamp (one upload a call)

    def forward(s, R, t, Xs):
        sRX = s * (Xs @ R.T)
        return sRX, sRX + t

    def huber(r):
        e = torch.linalg.norm(r, dim=-1)
        return torch.clamp(huber_px / torch.clamp(e, min=1e-6), max=1.0)

    s, R, t = s0, R0, t0
    for _ in range(iters):
        # Forward: d Xt = [-hat(Xt), I, s R X] d p.
        sRX, Xt = forward(s, R, t, X)
        r0 = cameras.project(cam_kind, cam_params, Xt) - uv
        dXt = torch.cat([-lie.so3_hat(Xt), eye3.expand(X.shape[0], 3, 3), sRX[..., None]], -1)
        J = cameras.project_jac(cam_kind, cam_params, Xt) @ dXt
        w = wm * huber(r0) * (Xt[:, 2] > 0.05).float()
        JTJ, JTr = _accumulate(J, r0, w, torch.zeros(7, 7, device=dev),
                               torch.zeros(7, device=dev))
        if X_bwd is not None:
            # Xs = (1/s) R^T (X_bwd - t): d Xs = [(1/s) R^T hat(X_bwd),
            # -(1/s) R^T, -Xs] d p.
            si = 1.0 / torch.clamp(s, min=1e-9)
            Xs = si * (X_bwd @ R) - si * (R.T @ t)
            rb = cameras.project(cam_kind, cam_params, Xs) - uv_bwd
            RTs = si * R.T
            dXs = torch.cat([RTs @ lie.so3_hat(X_bwd), -RTs.expand(X_bwd.shape[0], 3, 3),
                             -Xs[..., None]], -1)
            Jb = cameras.project_jac(cam_kind, cam_params, Xs) @ dXs
            wb = w_bwd.float() * huber(rb) * (Xs[:, 2] > 0.05).float()
            JTJ, JTr = _accumulate(Jb, rb, wb, JTJ, JTr)
        if X_src3 is not None:
            sRX3, Y = forward(s, R, t, X_src3)
            r3 = (Y - X_dst3) * w_3d[:, None]
            J3 = torch.cat([-lie.so3_hat(Y), eye3.expand(Y.shape[0], 3, 3),
                            sRX3[..., None]], -1) * w_3d[:, None, None]
            JTJ, JTr = _accumulate(J3, r3, huber(r3), JTJ, JTr)
        if fix_scale:
            keep = torch.ones(7, device=dev)
            keep[6] = 0.0
            JTJ = JTJ * keep[:, None] * keep[None, :] + (1.0 - keep[:, None] * keep[None, :]) \
                * torch.diag(1.0 - keep)
            JTr = JTr * keep
        JTJ = JTJ + 1e-3 * torch.diag(torch.diagonal(JTJ)) + 1e-4 * eye7
        # LU with partial pivoting, as jnp.linalg.solve; no error check, so
        # no host sync on the card.
        p = -torch.linalg.solve_ex(JTJ, JTr)[0]
        p = torch.maximum(torch.minimum(p, lim), -lim)
        dR = lie.so3_exp(p[:3])
        s, R, t = s * torch.exp(p[6]), dR @ R, dR @ t + p[3:6]
    _, Xt = forward(s, R, t, X)
    r = cameras.project(cam_kind, cam_params, Xt) - uv
    chi2 = torch.sum(r * r, dim=-1)
    inl = (chi2 < chi2_px) & w_mask & (Xt[:, 2] > 0.05)
    return s, R, t, torch.sum(inl, dtype=torch.int32)
