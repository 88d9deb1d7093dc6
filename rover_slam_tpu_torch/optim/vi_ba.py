"""Visual-inertial bundle adjustment: body poses, velocities, biases and
landmarks with preintegrated IMU factors.

Counterpart of rover_slam_tpu/optim/vi_ba.py (the reference's LocalInertialBA
/ FullInertialBA). State per keyframe: 15 dof [dtheta, dp, dv, dbg, dba],
left perturbation R <- exp(dtheta) R. The inertial edge's Jacobians are
closed forms of the derivatives the JAX package takes by `jax.jacfwd`
(`inertial_terms`; forward mode through `torch.func` runs its decompositions
in Python, op by op), as are the reprojection Jacobians. Landmarks are
Schur-eliminated; the reduced [15 Kw]^2 body system is Jacobi-equilibrated
and solved by LU (`torch.linalg.solve_ex`, no error read on the host). Every
float sum over edges goes through the sorted segment sums of
`ops/scatterless.py`, so a solve repeats to the bit. The LM accept/reject and
the damping stay on the device (`torch.where`). Stereo observations (e_invd,
bf) add the third residual row of optim/ba.py::stereo_row (the reference's
EdgeStereo) with the 7.815 chi2 gate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, cameras
from ..imu import preintegration as preint
from ..ops.scatterless import seg_sum, segment_plan
from . import robust
from .ba import stereo_row
from .blockinv import inv3


class VIBAProblem(NamedTuple):
    # Body states of a temporally ordered window of Kw keyframes.
    R_wb: torch.Tensor       # [Kw,3,3] body->world
    p_wb: torch.Tensor       # [Kw,3]
    v_wb: torch.Tensor       # [Kw,3]
    bg: torch.Tensor         # [Kw,3]
    ba: torch.Tensor         # [Kw,3]
    pose_opt_mask: torch.Tensor  # [Kw] bool
    kf_valid: torch.Tensor   # [Kw] bool, real window slots
    # Camera extrinsics (body->camera) and intrinsics.
    R_cb: torch.Tensor       # [3,3]
    t_cb: torch.Tensor       # [3]
    cam_params: torch.Tensor
    # Preintegration between consecutive window keyframes (slot i: i -> i+1).
    imu_dR: torch.Tensor     # [Kw,3,3]
    imu_dV: torch.Tensor     # [Kw,3]
    imu_dP: torch.Tensor     # [Kw,3]
    imu_JRg: torch.Tensor    # [Kw,3,3]
    imu_JVg: torch.Tensor
    imu_JVa: torch.Tensor
    imu_JPg: torch.Tensor
    imu_JPa: torch.Tensor
    imu_dt: torch.Tensor     # [Kw]
    imu_bg0: torch.Tensor    # [Kw,3] linearization biases of the preintegration
    imu_ba0: torch.Tensor
    imu_info: torch.Tensor   # [Kw,9,9]
    imu_valid: torch.Tensor  # [Kw] bool (last slot invalid)
    walk_info: torch.Tensor  # [6] diagonal info of the gyro+acc random walk
    # Landmarks and reprojection edges.
    lm_pos: torch.Tensor     # [Lw,3]
    lm_opt_mask: torch.Tensor
    e_kf: torch.Tensor       # [E]
    e_lm: torch.Tensor
    e_uv: torch.Tensor
    e_valid: torch.Tensor
    e_info: torch.Tensor
    e_invd: torch.Tensor = None  # [E] stereo inverse depth (<= 0: mono edge)
    bf: torch.Tensor = None


IMU_FIELDS = ("imu_dR", "imu_dV", "imu_dP", "imu_JRg", "imu_JVg", "imu_JVa", "imu_JPg",
              "imu_JPa", "imu_dt", "imu_bg0", "imu_ba0")


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _inertial_residual(x_i, x_j, Ri, pi, vi, bgi, bai, Rj, pj, vj,
                       dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, bg0, ba0):
    """9-dim preintegration residual of a batch of edges [E] with the
    perturbations x = [th, p, v, bg, ba] ([E,15]) applied to both endpoints
    (reference EdgeInertial::computeError). x None is the zero perturbation,
    to the same bits (exp(0) = I exactly) without its launches."""
    Ri_, pi_, vi_, bg, ba = Ri, pi, vi, bgi, bai
    Rj_, pj_, vj_ = Rj, pj, vj
    if x_i is not None:
        Ri_ = lie.so3_exp(x_i[..., 0:3]) @ Ri
        pi_, vi_ = pi + x_i[..., 3:6], vi + x_i[..., 6:9]
        bg, ba = bgi + x_i[..., 9:12], bai + x_i[..., 12:15]
    if x_j is not None:
        Rj_ = lie.so3_exp(x_j[..., 0:3]) @ Rj
        pj_, vj_ = pj + x_j[..., 3:6], vj + x_j[..., 6:9]
    dbg = bg - bg0
    dba = ba - ba0
    dR_c = dR @ lie.so3_exp(_mv(JRg, dbg))
    dV_c = dV + _mv(JVg, dbg) + _mv(JVa, dba)
    dP_c = dP + _mv(JPg, dbg) + _mv(JPa, dba)
    g = preint.gravity_vec(pi)
    t = dt[..., None]
    RiT = Ri_.transpose(-1, -2)
    er = lie.so3_log(dR_c.transpose(-1, -2) @ RiT @ Rj_)
    ev = _mv(RiT, vj_ - vi_ - g * t) - dV_c
    ep = _mv(RiT, pj_ - pi_ - vi_ * t - 0.5 * g * t * t) - dP_c
    return torch.cat([er, ev, ep], dim=-1)


def inertial_terms(states_i, states_j, imu):
    """Residuals [E,9] and Jacobians Ji, Jj [E,9,15] of a batch of inertial
    edges at the zero perturbation, in closed form (the derivatives that the
    JAX package's jax.jacfwd evaluates; tests/test_torch_vi_ba.py holds them
    against central differences of _inertial_residual). states_i = (R, p, v,
    bg, ba) of the edges' first keyframes, states_j = (R, p, v) of their
    second, imu the 11 preintegration arrays (IMU_FIELDS order).

    With E = dR_c^T Ri^T Rj and er = Log(E): the left perturbations give
    E exp(-Rj^T th_i) and E exp(Rj^T th_j), the gyro bias
    exp(-Jr(JRg dbg) JRg d) E, hence Jr^-1(er) times -Rj^T, Rj^T and
    -E^T Jr(JRg dbg) JRg; ev and ep turn with Ri^T exp(-th_i), hence
    Ri^T hat(.) of their world-frame vectors."""
    Ri, pi, vi, bgi, bai = states_i
    Rj, pj, vj = states_j
    dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dt, bg0, ba0 = imu
    r = _inertial_residual(None, None, Ri, pi, vi, bgi, bai, Rj, pj, vj, *imu)
    g = preint.gravity_vec(pi)
    t = dt[..., None]
    RiT = Ri.transpose(-1, -2)
    RjT = Rj.transpose(-1, -2)
    phi = _mv(JRg, bgi - bg0)
    Et = (Rj.transpose(-1, -2) @ Ri) @ (dR @ lie.so3_exp(phi))          # E^T
    Jr_inv = lie.so3_right_jacobian_inv(r[..., 0:3])
    a_v = vj - vi - g * t
    a_p = pj - pi - vi * t - 0.5 * g * t * t
    Z3 = torch.zeros_like(Ri)
    dt3 = dt[..., None, None]
    Ji = torch.cat([
        torch.cat([-Jr_inv @ RjT, Z3, Z3,
                   -Jr_inv @ Et @ lie.so3_right_jacobian(phi) @ JRg, Z3], dim=-1),
        torch.cat([RiT @ lie.so3_hat(a_v), Z3, -RiT, -JVg, -JVa], dim=-1),
        torch.cat([RiT @ lie.so3_hat(a_p), -RiT, -RiT * dt3, -JPg, -JPa], dim=-1)], dim=-2)
    Jj = torch.cat([
        torch.cat([Jr_inv @ RjT, Z3, Z3, Z3, Z3], dim=-1),
        torch.cat([Z3, Z3, RiT, Z3, Z3], dim=-1),
        torch.cat([Z3, RiT, Z3, Z3, Z3], dim=-1)], dim=-2)
    return r, Ji, Jj


def _reproj_terms(prob: VIBAProblem, cam_kind, R_wb, p_wb, X):
    """Reprojection residuals [E,D], Jacobians in the body pose [th, p]
    ([E,D,6]) and in the landmark ([E,D,3]), camera depth [E]; D = 3 with
    stereo observations, ba.stereo_row."""
    e_kf, e_lm = prob.e_kf.long(), prob.e_lm.long()
    Rk, pk, Xe = R_wb[e_kf], p_wb[e_kf], X[e_lm]
    y = Xe - pk
    Xb = torch.einsum("eji,ej->ei", Rk, y)
    Xc = torch.einsum("ij,ej->ei", prob.R_cb, Xb) + prob.t_cb
    e = prob.e_uv - cameras.project(cam_kind, prob.cam_params, Xc)
    G = -cameras.project_jac(cam_kind, prob.cam_params, Xc)        # de/dXc
    if prob.e_invd is not None and prob.bf is not None:
        e, G = stereo_row(cam_kind, e, G, Xc, prob.e_invd, prob.bf)
    # dXc/dXw = R_cb R^T = M, dXc/dp = -M, dXc/dth = M hat(Xw - p).
    M = torch.einsum("ij,ekj->eik", prob.R_cb, Rk)
    J_X = torch.einsum("eij,ejk->eik", G, M)
    J_th = torch.einsum("eij,ejk->eik", J_X, lie.so3_hat(y))
    return e, torch.cat([J_th, -J_X], dim=-1), J_X, Xc[..., 2]


def _pad15(v6):
    """[..., 6] bias entries placed at [9:15] of a zero [..., 15]."""
    return torch.nn.functional.pad(v6, (9, 0))


def solve_vi_ba(prob: VIBAProblem, cam_kind: int = cameras.PINHOLE, iters: int = 8,
                chi2_th: float = robust.CHI2_MONO, lam0: float = 1e-3):
    """LM over [15 Kw body states + 3 Lw landmarks], landmarks Schur-
    eliminated. Returns (R, p, v, bg, ba, X, cost history [iters])."""
    Kw, Lw, D = prob.R_wb.shape[0], prob.lm_pos.shape[0], 15
    n = Kw * D
    dev = prob.R_wb.device
    pmask = (prob.pose_opt_mask & prob.kf_valid).float()
    lmask = prob.lm_opt_mask.float()
    delta2 = (torch.where(prob.e_invd > 0, robust.CHI2_STEREO, chi2_th)
              if prob.e_invd is not None else chi2_th)
    imu = tuple(getattr(prob, f) for f in IMU_FIELDS)
    idx_i = torch.arange(Kw, device=dev)
    idx_j = torch.clamp(idx_i + 1, max=Kw - 1)
    w_imu = prob.imu_valid.float()
    e_kf, e_lm = prob.e_kf.long(), prob.e_lm.long()
    # One sort per index set for the whole solve. H and g take, in the JAX
    # package's order: the reprojection blocks, the inertial blocks (ii, jj,
    # ij, ji), the bias-walk blocks (same four).
    ii, jj, ij, ji = idx_i * Kw + idx_i, idx_j * Kw + idx_j, idx_i * Kw + idx_j, idx_j * Kw + idx_i
    plan_H = segment_plan(torch.cat([e_kf * Kw + e_kf, ii, jj, ij, ji, ii, jj, ij, ji]), Kw * Kw)
    plan_g = segment_plan(torch.cat([e_kf, idx_i, idx_j, idx_i, idx_j]), Kw)
    plan_l = segment_plan(e_lm, Lw)
    plan_w = segment_plan(e_lm * Kw + e_kf, Lw * Kw)
    wb = prob.walk_info[None, :] * w_imu[:, None]                         # [Kw,6]
    Hbb = torch.nn.functional.pad(torch.diag_embed(wb), (9, 0, 9, 0))
    eye3 = torch.eye(3, device=dev)

    def imu_at(R, p, v, bg, ba):
        return ((R[idx_i], p[idx_i], v[idx_i], bg[idx_i], ba[idx_i]),
                (R[idx_j], p[idx_j], v[idx_j]))

    def total_cost(R, p, v, bg, ba, X):
        e, _, _, _ = _reproj_terms(prob, cam_kind, R, p, X)
        c2 = torch.sum(e * e, dim=-1) * prob.e_info
        c_rep = torch.sum(torch.where(prob.e_valid, robust.huber_cost(c2, delta2), 0.0))
        si, sj = imu_at(R, p, v, bg, ba)
        ri = _inertial_residual(None, None, *si, *sj, *imu)
        c_imu = torch.sum(w_imu * torch.einsum("ei,eij,ej->e", ri, prob.imu_info, ri))
        rb = torch.cat([bg[idx_j] - bg[idx_i], ba[idx_j] - ba[idx_i]], dim=-1)
        c_b = torch.sum(w_imu[:, None] * prob.walk_info[None, :] * rb * rb)
        return c_rep + c_imu + c_b

    R, p, v, bg, ba, X = prob.R_wb, prob.p_wb, prob.v_wb, prob.bg, prob.ba, prob.lm_pos
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    # The cost at the current state, carried from each step's accept/reject
    # (the JAX package recomputes it, to the same bits).
    c_old = total_cost(R, p, v, bg, ba, X)
    costs = []
    for _ in range(iters):
        e, Jc6, Jl, depth = _reproj_terms(prob, cam_kind, R, p, X)
        chi2 = torch.sum(e * e, dim=-1) * prob.e_info
        w = (robust.huber_weight(chi2, delta2) * prob.e_info * prob.e_valid
             * (depth > 0.05))
        Jc = torch.nn.functional.pad(Jc6, (0, 9))                         # [E,D,15]
        wJc = Jc * w[:, None, None]
        si, sj = imu_at(R, p, v, bg, ba)
        ri, Ji, Jj = inertial_terms(si, sj, imu)
        info = prob.imu_info * w_imu[:, None, None]
        JiT_I = torch.einsum("eki,ekl->eil", Ji, info)
        JjT_I = torch.einsum("eki,ekl->eil", Jj, info)
        rb = torch.cat([bg[idx_j] - bg[idx_i], ba[idx_j] - ba[idx_i]], dim=-1)

        blocks = torch.cat([
            torch.einsum("eki,ekj->eij", wJc, Jc),
            JiT_I @ Ji, JjT_I @ Jj, JiT_I @ Jj, JjT_I @ Ji, Hbb, Hbb, -Hbb, -Hbb])
        H = seg_sum(plan_H, blocks.reshape(-1, D * D)).reshape(Kw, Kw, D, D)
        H = H.permute(0, 2, 1, 3).reshape(n, n)
        g_vec = seg_sum(plan_g, torch.cat([
            torch.einsum("eki,ek->ei", wJc, e),
            _mv(JiT_I, ri), _mv(JjT_I, ri), _pad15(-wb * rb), _pad15(wb * rb)]))

        # Landmark Schur elimination. The reduced-camera term contracts the
        # landmark axis as one (15 Kw x 3 Lw) product.
        wJl = Jl * w[:, None, None]
        Hll = seg_sum(plan_l, torch.einsum("eki,ekj->eij", wJl, Jl).reshape(-1, 9))
        Hll = Hll.reshape(Lw, 3, 3)
        b_l = seg_sum(plan_l, torch.einsum("eki,ek->ei", wJl, e))
        dl = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_d = Hll + torch.diag_embed(lam * torch.clamp(dl, min=1e-6))
        Hll_d = torch.where(lmask[:, None, None] > 0, Hll_d, eye3)
        Hll_inv = inv3(Hll_d + 1e-9 * eye3)
        Wt = seg_sum(plan_w, torch.einsum("eki,ekj->eij", wJc, Jl).reshape(-1, D * 3))
        Wt = Wt.reshape(Lw, Kw, D, 3) * lmask[:, None, None, None]
        Wf = Wt.permute(1, 2, 0, 3).reshape(n, Lw * 3)
        Yf = torch.einsum("lkab,lbc->kalc", Wt, Hll_inv).reshape(n, Lw * 3)
        H = H - Yf @ Wf.T
        z = torch.einsum("lbc,lc->lb", Hll_inv, b_l).reshape(Lw * 3)
        g_flat = g_vec.reshape(n) - Wf @ z

        # Damping, fixed poses, equilibrated LU solve.
        dcc = torch.diagonal(H)
        Hm = H + torch.diag(lam * torch.clamp(dcc, min=1e-6))
        fixm = (pmask == 0).repeat_interleave(D)
        Hm = torch.where(fixm[:, None] | fixm[None, :], 0.0, Hm)
        Hm = Hm + torch.diag(fixm.float())
        g_flat = (g_flat.reshape(Kw, D) * pmask[:, None]).reshape(n)
        # Jacobi equilibration: bias-walk (~1e10) and reprojection (~1e2)
        # information span 8+ orders of magnitude.
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
        Hs = Hm / d_eq[:, None] / d_eq[None, :]
        y = torch.linalg.solve_ex(Hs + 1e-7 * torch.eye(n, device=dev), -(g_flat / d_eq))[0]
        dx = (y / d_eq).reshape(Kw, D) * pmask[:, None]
        rhs = -b_l - (Wf.T @ dx.reshape(n)).reshape(Lw, 3)
        dx_l = torch.einsum("lbc,lc->lb", Hll_inv, rhs) * lmask[:, None]

        opt = pmask > 0
        R_new = torch.where(opt[:, None, None], lie.normalize_rotation(
            torch.einsum("kij,kjl->kil", lie.so3_exp(dx[:, 0:3]), R)), R)
        p_new = torch.where(opt[:, None], p + dx[:, 3:6], p)
        v_new = torch.where(opt[:, None], v + dx[:, 6:9], v)
        bg_new = torch.where(opt[:, None], bg + dx[:, 9:12], bg)
        ba_new = torch.where(opt[:, None], ba + dx[:, 12:15], ba)
        X_new = torch.where(lmask[:, None] > 0, X + dx_l, X)

        c_new = total_cost(R_new, p_new, v_new, bg_new, ba_new, X_new)
        ok = c_new < c_old
        R, p, v, bg, ba, X = (torch.where(ok, a, b) for a, b in
                              ((R_new, R), (p_new, p), (v_new, v), (bg_new, bg),
                               (ba_new, ba), (X_new, X)))
        lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-8, 1e4)
        costs.append(c_old)
        c_old = torch.where(ok, c_new, c_old)
    return R, p, v, bg, ba, X, torch.stack(costs)


def merge_inertial_ba(prob: VIBAProblem, weld_slot: int, cam_kind: int = cameras.PINHOLE,
                      iters: int = 8, chi2_th: float = robust.CHI2_MONO, lam0: float = 1e-3):
    """The reference's MergeInertialBA: VI-BA over the two temporal windows
    either side of a map weld, `prob` being [old-map window | active window]
    with weld_slot the first slot of the active side. No preintegration spans
    the weld (the chain breaks at weld_slot-1 -> weld_slot), so the sides are
    tied only by the fused landmarks' reprojection edges; the oldest
    keyframe of the old side is the fixed gauge."""
    idx = torch.arange(prob.R_wb.shape[0], device=prob.R_wb.device)
    prob = prob._replace(imu_valid=prob.imu_valid & (idx != weld_slot - 1),
                         pose_opt_mask=prob.pose_opt_mask & (idx != 0))
    return solve_vi_ba(prob, cam_kind=cam_kind, iters=iters, chi2_th=chi2_th, lam0=lam0)
