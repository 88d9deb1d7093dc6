"""Bundle adjustment: Levenberg-Marquardt with exact landmark elimination
(Schur complement and a direct reduced-camera solve) for the windowed BA, or
matrix-free block-Jacobi PCG for the global BA.

Counterpart of rover_slam_tpu/optim/ba.py (`solve_ba`) with the options the
two callers use: solver="schur" with red_solver="direct" (the keyframe
insert) and solver="pcg" (`map/maintenance.py::global_ba`), kf_major=True,
lm_cap, two phases with a hard chi2 outlier drop between them. The
`lax.scan` over LM and CG steps becomes a Python loop whose scalars stay on
the device; the JAX package's landmark-side segment sums are sorted segment
sums here (`ops/scatterless.py`: same sums, another but fixed order, so a
solve repeats to the bit).

kf_major is a contract on the edge list: edge rows [k*N, (k+1)*N) belong to
window keyframe k, so pose-side sums are reshape-sums. As in the JAX package
the pose-side reductions are reshape-sums whenever kf_major is set, whatever
layout the caller passes (see global_ba).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, cameras
from ..ops.scatterless import SegmentPlan, nonzero_static, seg_sum, segment_plan
from . import robust
from .blockinv import inv3, inv6, chol3, invn


class BAProblem(NamedTuple):
    R_cw: torch.Tensor          # [Kw,3,3]
    t_cw: torch.Tensor          # [Kw,3]
    pose_opt_mask: torch.Tensor  # [Kw] bool: False = fixed pose
    lm_pos: torch.Tensor        # [Lw,3]
    lm_opt_mask: torch.Tensor   # [Lw] bool
    cam_params: torch.Tensor
    e_kf: torch.Tensor          # [E] window-kf index per edge (kf-major)
    e_lm: torch.Tensor          # [E] landmark index per edge
    e_uv: torch.Tensor          # [E,2] measured pixels
    e_valid: torch.Tensor       # [E] bool
    e_info: torch.Tensor        # [E] inverse measurement variance
    # Stereo observations (None = mono problem): per-edge measured inverse
    # depth (<= 0 where the keypoint has no right-eye match) and bf =
    # baseline*fx. Edges with e_invd > 0 are the reference's 3-dim
    # (u_L, v_L, u_R) edges with the 7.815 chi2 gate
    # (EdgeStereoSE3ProjectXYZ); for fisheye (KB8) the third row is the pure
    # inverse-depth term, as in the JAX package.
    e_invd: torch.Tensor = None  # [E] or None
    bf: torch.Tensor = None      # scalar


class BAResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    lm_pos: torch.Tensor
    e_chi2: torch.Tensor
    e_inlier: torch.Tensor


def stereo_row(cam_kind, e, G, Xc, invd, bf):
    """Append the stereo residual row to e [M,2] and de/dXc G [M,2,3]:
    u_R_meas - u_R_hat = (u_L_meas - bf*invd) - (u_L_hat - bf/z), that is
    r3 = rect*e_u - bf*(invd - 1/z), zero where invd <= 0 (rect = 0 for
    fisheye, where only the inverse-depth term holds). Shared by every
    solver, as the reference's EdgeStereo* share one error."""
    z = torch.clamp(Xc[..., 2], min=1e-6)
    has3 = (invd > 0).float()
    rect = 1.0 if cam_kind == cameras.PINHOLE else 0.0
    r3 = rect * e[:, 0] - bf * (invd - 1.0 / z)
    ez = torch.zeros_like(G[:, :1, :])
    ez[:, 0, 2] = bf / (z * z)
    G3 = rect * G[:, :1, :] - ez
    return (torch.cat([e, (has3 * r3)[:, None]], dim=1),
            torch.cat([G, has3[:, None, None] * G3], dim=1))


def _edge_terms(cam_kind, prob: BAProblem, R, t, X):
    """Residuals e [E,D], Jacobians Jc [E,D,6] and Jl [E,D,3], depth [E]; D = 2
    for mono problems, 3 with stereo observations (the third row is zero on
    mono edges; see BAProblem.e_invd)."""
    Re = R[prob.e_kf.long()]
    Xc = lie.se3_apply(Re, t[prob.e_kf.long()], X[prob.e_lm.long()])
    e = prob.e_uv - cameras.project(cam_kind, prob.cam_params, Xc)
    G = -cameras.project_jac(cam_kind, prob.cam_params, Xc)
    if prob.e_invd is not None and prob.bf is not None:
        e, G = stereo_row(cam_kind, e, G, Xc, prob.e_invd, prob.bf)
    Jc = torch.cat([G, -torch.einsum("eij,ejk->eik", G, lie.so3_hat(Xc))], dim=-1)
    Jl = torch.einsum("eij,ejk->eik", G, Re)
    return e, Jc, Jl, Xc[..., 2]


def solve_ba(prob: BAProblem, cam_kind: int = cameras.PINHOLE, iters: int = 10,
             chi2_th: float = robust.CHI2_MONO, lam0: float = 1e-4,
             phases: int = 2, lm_cap: int | None = None, solver: str = "schur",
             cg_iters: int = 20) -> BAResult:
    """solver "schur": exact landmark elimination, direct reduced solve;
    "pcg": cg_iters of block-Jacobi preconditioned CG on the full system."""
    if solver not in ("schur", "pcg"):
        raise ValueError(f"unknown BA solver {solver!r}")
    Kw = prob.R_cw.shape[0]
    L_full = prob.lm_pos.shape[0]
    dev = prob.lm_pos.device
    if lm_cap is not None and lm_cap < L_full:
        # Compact the landmark VARIABLES; residuals still gather from the
        # full table, edges to landmarks beyond the cap see them held fixed.
        C = lm_cap
        var_idx = nonzero_static(prob.lm_opt_mask, C, fill_value=L_full)
        pad = var_idx >= L_full
        var_c = var_idx.clamp(0, L_full - 1)
        inv = torch.full((L_full + 1,), C, dtype=torch.long, device=dev)
        inv[torch.where(pad, L_full, var_c)] = torch.where(
            pad, C, torch.arange(C, device=dev))
        e_lmv = inv[:L_full][prob.e_lm.long()]
        lmask_c = prob.lm_opt_mask[var_c] & ~pad
    else:
        C = L_full
        var_c = torch.arange(L_full, device=dev)
        e_lmv = prob.e_lm.long()
        lmask_c = prob.lm_opt_mask
    Lw = C
    lm_tgt = torch.where(lmask_c, var_c, L_full)
    pmask = prob.pose_opt_mask.float()[:, None]
    lmask = lmask_c.float()[:, None]
    # Per-edge chi2 gate: 7.815 on stereo (3-dim) edges, chi2_th on mono ones.
    delta2 = (torch.where(prob.e_invd > 0, robust.CHI2_STEREO, chi2_th)
              if prob.e_invd is not None else chi2_th)
    E = prob.e_kf.shape[0]
    Ne = E // Kw
    e_kf = prob.e_kf.long()
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    n = 6 * Kw
    eye_n = torch.eye(n, device=dev) if solver == "schur" else None
    ar_k = torch.arange(Kw, device=dev)

    def seg_c(vals):
        return vals.reshape((Kw, Ne) + tuple(vals.shape[1:])).sum(dim=1)

    # Landmark-side sums through one sort of the edges by (landmark, window
    # kf), made once per solve: sorted by that key the edges are also sorted
    # by landmark, so every Kw-th offset bounds one landmark's edges. Edges of
    # the fixed/overflow bucket (e_lmv == Lw) sort last and are left out.
    if solver == "schur":
        plan_lk = segment_plan(e_lmv * Kw + e_kf, Lw * Kw)
        plan_l = SegmentPlan(plan_lk.order, plan_lk.offsets[::Kw])
    else:
        plan_l = segment_plan(e_lmv, Lw)

    def seg_l(vals):
        return seg_sum(plan_l, vals)

    def seg_cross(vals):   # [E,6,3] -> [Lw,Kw,6,3]
        return seg_sum(plan_lk, vals).reshape(Lw, Kw, 6, 3)

    def lm_step(prob, R, t, X, lam):
        e, Jc, Jl, depth = _edge_terms(cam_kind, prob, R, t, X)
        chi2 = torch.sum(e * e, dim=-1) * prob.e_info
        w = (robust.huber_weight(chi2, delta2) * prob.e_info
             * prob.e_valid.float() * (depth > 0.05).float())
        we = w[:, None] * e
        g_c = seg_c(torch.einsum("eki,ek->ei", Jc, we)) * pmask
        g_l = seg_l(torch.einsum("eki,ek->ei", Jl, we)) * lmask
        Hcc = seg_c(torch.einsum("eki,e,ekj->eij", Jc, w, Jc))
        Hll = seg_l(torch.einsum("eki,e,ekj->eij", Jl, w, Jl))
        dc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        dl = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hcc_d = Hcc + torch.diag_embed(lam * torch.clamp(dc, min=1e-6))
        Hll_d = Hll + torch.diag_embed(lam * torch.clamp(dl, min=1e-6))
        Hcc_d = torch.where(pmask[:, :, None] > 0, Hcc_d, eye6)
        Hll_d = torch.where(lmask[:, :, None] > 0, Hll_d, eye3)
        Pl = inv3(Hll_d + 1e-9 * eye3)
        b_c, b_l = -g_c, -g_l
        if solver == "pcg":
            dx_c, dx_l = _pcg(Jc, Jl, w, e_kf, e_lmv, seg_c, seg_l, pmask, lmask,
                              lam * torch.clamp(dc, min=1e-6), lam * torch.clamp(dl, min=1e-6),
                              inv6(Hcc_d + 1e-9 * eye6), Pl, b_c, b_l, cg_iters)
        else:
            dx_c, dx_l = schur(Jc, Jl, w, Hcc_d, Pl, b_c, b_l)
        return apply_step(prob, R, t, X, lam, dx_c, dx_l, chi2)

    def schur(Jc, Jl, w, Hcc_d, Pl, b_c, b_l):
        # Exact Schur elimination: with Pl = L L^T the cross term
        # sum_l W_l Pl W_l^T is B B^T for B = [W_l L]_l.
        Wt = seg_cross(torch.einsum("eki,e,ekj->eij", Jc, w, Jl))
        Wt = Wt * pmask[None, :, :, None] * lmask[:, None, :, None]
        L3 = chol3(Pl)
        B = torch.einsum("lkab,lbc->lkac", Wt, L3)
        Bf = B.permute(1, 2, 0, 3).reshape(n, Lw * 3)
        S = -(Bf @ Bf.T)
        S = S.reshape(Kw, 6, Kw, 6)
        S[ar_k, :, ar_k, :] += Hcc_d
        Ltb = torch.einsum("lij,li->lj", L3, b_l)
        rhs = b_c - torch.einsum("lkac,lc->ka", B, Ltb)
        Sm = S.reshape(n, n) + 1e-8 * eye_n
        b_r = rhs * pmask
        # Direct reduced-camera solve: Jacobi-equilibrate, closed-form
        # recursive block inverse, one refinement round.
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(Sm), min=1e-12))
        Se = Sm / d_eq[:, None] / d_eq[None, :]
        Sei = invn(Se + 1e-7 * eye_n)
        bv = b_r.reshape(n) / d_eq
        y = Sei @ bv
        y = y + Sei @ (bv - Se @ y)
        dx_c = (y / d_eq).reshape(Kw, 6) * pmask
        dx_l = torch.einsum("lbc,lc->lb", Pl,
                            b_l - torch.einsum("lkab,ka->lb", Wt, dx_c)) * lmask
        return dx_c, dx_l

    def apply_step(prob, R, t, X, lam, dx_c, dx_l, chi2):
        dR, dt = lie.se3_exp(dx_c)
        R_new = lie.normalize_rotation(torch.einsum("kij,kjl->kil", dR, R))
        t_new = torch.einsum("kij,kj->ki", dR, t) + dt
        R_new = torch.where(pmask[:, :, None] > 0, R_new, R)
        t_new = torch.where(pmask > 0, t_new, t)
        # Each optimized landmark is written once; padding and fixed
        # variables go to a spill row that is dropped.
        X_ext = torch.cat([X, X.new_zeros(1, 3)])
        X_new = X_ext.index_put((lm_tgt,), X_ext[lm_tgt]
                                + torch.where(lmask > 0, dx_l, 0.0))[:L_full]

        e_new, _, _, _ = _edge_terms(cam_kind, prob, R_new, t_new, X_new)
        chi2_new = torch.sum(e_new * e_new, dim=-1) * prob.e_info
        mask_e = prob.e_valid.float()
        cost_old = torch.sum(robust.huber_cost(chi2, delta2) * mask_e)
        cost_new = torch.sum(robust.huber_cost(chi2_new, delta2) * mask_e)
        improved = cost_new < cost_old
        R = torch.where(improved, R_new, R)
        t = torch.where(improved, t_new, t)
        X = torch.where(improved, X_new, X)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0), 1e-8, 1e4)
        return R, t, X, lam

    # The chi2 drop between phases reaches only the returned inlier mask:
    # the LM steps of every phase run on the caller's edges. That is what
    # the JAX package computes, whose lax.scan reuses the first phase's trace
    # of the LM step and with it the first phase's edge mask (ROADMAP.md §C).
    R, t, X = prob.R_cw, prob.t_cw, prob.lm_pos
    valid = prob.e_valid
    for phase in range(phases):
        lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
        for _ in range(iters):
            R, t, X, lam = lm_step(prob, R, t, X, lam)
        if phase < phases - 1:
            e_p, _, _, depth_p = _edge_terms(cam_kind, prob, R, t, X)
            chi2_p = torch.sum(e_p * e_p, dim=-1) * prob.e_info
            valid = valid & (chi2_p <= delta2) & (depth_p > 0)
    e, _, _, depth = _edge_terms(cam_kind, prob, R, t, X)
    chi2 = torch.sum(e * e, dim=-1) * prob.e_info
    inlier = (chi2 <= delta2) & (depth > 0) & valid
    return BAResult(R_cw=R, t_cw=t, lm_pos=X, e_chi2=chi2, e_inlier=inlier)


def _pcg(Jc, Jl, w, e_kf, e_lmv, seg_c, seg_l, pmask, lmask, lam_dc, lam_dl, Pc, Pl,
         b_c, b_l, iters: int):
    """Block-Jacobi PCG on the damped normal equations, matrix-free: each
    matvec is two per-edge contractions and their segment sums. Fixed
    variables have identity preconditioner blocks and masked products, so
    they stay at zero."""
    def matvec(v_c, v_l):
        v_c = v_c * pmask
        v_l = v_l * lmask
        v_lp = torch.cat([v_l, v_l.new_zeros(1, 3)])
        u = (torch.einsum("eki,ei->ek", Jc, v_c[e_kf])
             + torch.einsum("eki,ei->ek", Jl, v_lp[e_lmv])) * w[:, None]
        out_c = seg_c(torch.einsum("eki,ek->ei", Jc, u)) + lam_dc * v_c
        out_l = seg_l(torch.einsum("eki,ek->ei", Jl, u)) + lam_dl * v_l
        return out_c * pmask, out_l * lmask

    def precond(r_c, r_l):
        return (torch.einsum("kij,kj->ki", Pc, r_c) * pmask,
                torch.einsum("lij,lj->li", Pl, r_l) * lmask)

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, torch.full_like(v, 1e-20), v)

    x_c, x_l = torch.zeros_like(b_c), torch.zeros_like(b_l)
    r_c, r_l = b_c, b_l
    p_c, p_l = precond(b_c, b_l)
    rz = torch.sum(b_c * p_c) + torch.sum(b_l * p_l)
    for _ in range(iters):
        Ap_c, Ap_l = matvec(p_c, p_l)
        alpha = rz / guard(torch.sum(p_c * Ap_c) + torch.sum(p_l * Ap_l))
        x_c = x_c + alpha * p_c
        x_l = x_l + alpha * p_l
        r_c = r_c - alpha * Ap_c
        r_l = r_l - alpha * Ap_l
        z_c, z_l = precond(r_c, r_l)
        rz_new = torch.sum(r_c * z_c) + torch.sum(r_l * z_l)
        beta = rz_new / guard(rz)
        p_c = z_c + beta * p_c
        p_l = z_l + beta * p_l
        rz = rz_new
    return x_c, x_l
