"""Inertial-only optimization: gravity direction, scale, biases, velocities
against fixed visual poses.

Counterpart of rover_slam_tpu/optim/inertial_init.py (the reference's
InertialOptimization and its 3-stage prior schedule in InitializeIMU). Staged
for global convergence as in the JAX package: (1) the gyro bias from the
rotation residuals, (2) one linear solve of velocities, gravity and scale
(VINS-Mono's alignment, then |g| enforced on the 2-dof tangent plane), (3) a
joint Gauss-Newton over x = [v(3K) | bg | ba | dtheta_g(2) | log s] with the
residuals of EdgeInertialGS. Jacobians by forward-mode autodiff
(`torch.func.jacfwd`); every solve is `torch.linalg.solve_ex` (no error read
on the host); the LM picks among its candidates on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ..geometry import lie
from ..imu import preintegration as preint

G_MAG = preint.GRAVITY


class InertialInitProblem(NamedTuple):
    # Fixed visual body poses, a temporally ordered window of K keyframes.
    R_wb: torch.Tensor      # [K,3,3]
    p_wb: torch.Tensor      # [K,3]
    kf_valid: torch.Tensor  # [K] bool
    # Preintegration linking i -> i+1 (slot i), padded like vi_ba's.
    imu_dR: torch.Tensor
    imu_dV: torch.Tensor
    imu_dP: torch.Tensor
    imu_JRg: torch.Tensor
    imu_JVg: torch.Tensor
    imu_JVa: torch.Tensor
    imu_JPg: torch.Tensor
    imu_JPa: torch.Tensor
    imu_dt: torch.Tensor
    imu_bg0: torch.Tensor
    imu_ba0: torch.Tensor
    imu_info: torch.Tensor  # [K,9,9]
    imu_valid: torch.Tensor
    Rwg0: Optional[torch.Tensor] = None  # [3,3] gravity-direction bootstrap


class InertialInitResult(NamedTuple):
    v_wb: torch.Tensor     # [K,3]
    bg: torch.Tensor
    ba: torch.Tensor
    Rwg: torch.Tensor      # [3,3]: g_world = Rwg (0, 0, -9.81)
    scale: torch.Tensor
    cost: torch.Tensor


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


def _next(K, dev):
    i = torch.arange(K, device=dev)
    return i, torch.clamp(i + 1, max=K - 1)


def _gs_residuals(params, prob: InertialInitProblem, Rwg0):
    """EdgeInertialGS residuals [K,9] of every consecutive pair (fixed
    poses) at params = [v(3K) | bg | ba | thg(2) | log s]."""
    K = prob.R_wb.shape[0]
    i, j = _next(K, params.device)
    v = params[:3 * K].reshape(K, 3)
    bg, ba = params[3 * K:3 * K + 3], params[3 * K + 3:3 * K + 6]
    thg, log_s = params[3 * K + 6:3 * K + 8], params[3 * K + 8]
    s = torch.exp(log_s)
    # A batch of one: forward mode through torch.where on 0-dim operands
    # gives float64 tangents.
    Rwg = Rwg0 @ lie.so3_exp(torch.cat([thg, torch.zeros_like(thg[:1])])[None])[0]
    g = Rwg @ preint.gravity_vec(params)
    Ri, pi, Rj, pj = prob.R_wb[i], prob.p_wb[i], prob.R_wb[j], prob.p_wb[j]
    vi, vj = v[i], v[j]
    dbg, dba = bg - prob.imu_bg0, ba - prob.imu_ba0
    dt = prob.imu_dt[:, None]
    dR_c = prob.imu_dR @ lie.so3_exp(_mv(prob.imu_JRg, dbg))
    dV_c = prob.imu_dV + _mv(prob.imu_JVg, dbg) + _mv(prob.imu_JVa, dba)
    dP_c = prob.imu_dP + _mv(prob.imu_JPg, dbg) + _mv(prob.imu_JPa, dba)
    RiT = Ri.transpose(-1, -2)
    er = lie.so3_log(dR_c.transpose(-1, -2) @ RiT @ Rj)
    ev = _mv(RiT, vj - vi - g * dt) - dV_c
    ep = _mv(RiT, s * (pj - pi) - vi * dt - 0.5 * g * dt * dt) - dP_c
    return torch.cat([er, ev, ep], dim=-1)


def _gyro_bias_only(prob: InertialInitProblem, iters: int = 5):
    """Stage 1: bg from the rotation residuals alone, a 3-variable GN."""
    K = prob.R_wb.shape[0]
    dev = prob.R_wb.device
    i, j = _next(K, dev)
    w_e = (prob.imu_valid & prob.kf_valid).float()

    def r_all(bg):
        dR_c = prob.imu_dR @ lie.so3_exp(_mv(prob.imu_JRg, bg - prob.imu_bg0))
        res = lie.so3_log(dR_c.transpose(-1, -2) @ prob.R_wb[i].transpose(-1, -2)
                          @ prob.R_wb[j])
        return res * w_e[:, None]

    bg = torch.zeros(3, device=dev)
    for _ in range(iters):
        r = r_all(bg)
        J = jacfwd(r_all)(bg)                                   # [K,3,3]
        H = torch.einsum("eki,ekj->ij", J, J) + 1e-9 * torch.eye(3, device=dev)
        bg = bg - _solve(H, torch.einsum("eki,ek->i", J, r))
    return bg


def _linear_vgs(prob: InertialInitProblem, bg, fix_scale: bool = False,
                sigma_vis: float = 0.01):
    """Stage 2: with bg fixed (ba ~ 0) ev and ep are linear in
    x = [v(3K), g(3), s]; one weighted least-squares solve, then (free scale)
    four re-solves with |g| = 9.81 on the tangent plane of the current g.
    Returns (v [K,3], g [3], s)."""
    K = prob.R_wb.shape[0]
    dev = prob.R_wb.device
    nv = 3 * K + 4
    i, j = _next(K, dev)
    w_e = (prob.imu_valid & prob.kf_valid).float()
    Rit = prob.R_wb.transpose(-1, -2)
    dt = prob.imu_dt
    dbg = bg - prob.imu_bg0
    dV_c = prob.imu_dV + _mv(prob.imu_JVg, dbg)
    dP_c = prob.imu_dP + _mv(prob.imu_JPg, dbg)
    dp = prob.p_wb[j] - prob.p_wb[i]
    # A [K,6,nv]: ev = Rit (vj - vi - g dt) - dV_c (rows 0:3),
    # ep = Rit (s dp - vi dt - 0.5 g dt^2) - dP_c (rows 3:6); the blocks are
    # set in the JAX package's order (the padded last slot has i == j).
    A = torch.zeros((K, 6, nv), device=dev)
    kk = torch.arange(K, device=dev)[:, None, None]
    r3 = torch.arange(3, device=dev)[None, :, None]
    c3 = torch.arange(3, device=dev)[None, None, :]

    def put(rows, col0, val):
        A[kk, rows + r3, col0[:, None, None] + c3] = val

    dt3 = dt[:, None, None]
    put(0, 3 * j, Rit)
    put(0, 3 * i, -Rit)
    put(3, 3 * i, -Rit * dt3)
    A[:, 0:3, 3 * K:3 * K + 3] = -Rit * dt3
    A[:, 3:6, 3 * K:3 * K + 3] = -0.5 * Rit * dt3 * dt3
    A[:, 3:6, 3 * K + 3] = _mv(Rit, dp)
    b = torch.cat([dV_c, dP_c], dim=-1)
    # Weight by the v/p information with a visual-noise floor.
    eye6 = torch.eye(6, device=dev)
    C6 = torch.linalg.inv_ex(prob.imu_info[:, 3:9, 3:9] + 1e-8 * eye6).inverse \
        + sigma_vis ** 2 * eye6
    W6 = torch.linalg.inv_ex(C6).inverse * w_e[:, None, None]
    # Padded and invalid slots have W6 = 0, whose square root is 0. The
    # batched CUDA eigh leaves an all-zero matrix's eigenvalues unwritten
    # (they hold whatever the allocator handed out), so those slots take the
    # identity and a zero factor.
    on = w_e[:, None, None] > 0
    lam_, U = torch.linalg.eigh(torch.where(on, 0.5 * (W6 + W6.transpose(-1, -2)), eye6))
    Ws = U @ torch.diag_embed(torch.sqrt(torch.clamp(lam_, min=0.0))) @ U.transpose(-1, -2)
    Ws = torch.where(on, Ws, torch.zeros_like(Ws))
    A = (Ws @ A).reshape(-1, nv)
    b = _mv(Ws, b).reshape(-1)
    if fix_scale:
        b = b - A[:, -1]
        A = torch.cat([A[:, :-1], torch.zeros_like(A[:, -1:])], dim=1)
    eye_nv = torch.eye(nv, device=dev)
    x = _solve(A.T @ A + 1e-6 * eye_nv, A.T @ b)
    v = x[:3 * K].reshape(K, 3)
    g = x[3 * K:3 * K + 3]
    if fix_scale:
        return v, g, torch.ones((), device=dev)
    # Gravity-magnitude-constrained refinement (VINS-Mono's RefineGravity):
    # with |g| free, gravity and v0 absorb most of the s dp signal over short
    # windows and the scale collapses toward zero.
    A_g = A[:, 3 * K:3 * K + 3]
    A_rest = torch.cat([A[:, :3 * K], A[:, 3 * K + 3:]], dim=1)
    ex, ey = torch.tensor([1.0, 0.0, 0.0], device=dev), torch.tensor([0.0, 1.0, 0.0], device=dev)
    n2 = A_rest.shape[1] + 2
    eye_n2 = torch.eye(n2, device=dev)
    for _ in range(4):
        ghat = g / torch.clamp(torch.linalg.norm(g), min=1e-9)
        ref = torch.where(torch.abs(ghat[0]) < 0.9, ex, ey)
        t1 = torch.linalg.cross(ghat, ref)
        t1 = t1 / torch.clamp(torch.linalg.norm(t1), min=1e-9)
        t2 = torch.linalg.cross(ghat, t1)
        T = torch.stack([t1, t2], dim=1)                            # [3,2]
        A2 = torch.cat([A_rest, A_g @ T], dim=1)
        b2 = b - A_g @ (G_MAG * ghat)
        x2 = _solve(A2.T @ A2 + 1e-6 * eye_n2, A2.T @ b2)
        g_new = G_MAG * ghat + T @ x2[-2:]
        g = G_MAG * g_new / torch.clamp(torch.linalg.norm(g_new), min=1e-9)
    return x2[:3 * K].reshape(K, 3), g, x2[3 * K]


def inertial_only_optimization(prob: InertialInitProblem, prior_g: float = 1e2,
                               prior_a: float = 1e6, iters: int = 20,
                               fix_scale: bool = False,
                               fix_gdir: bool = False) -> InertialInitResult:
    """Velocities, biases, gravity direction and scale against fixed visual
    poses; prior_g / prior_a are the bias priors of the reference's 3-stage
    schedule."""
    K = prob.R_wb.shape[0]
    n = 3 * K + 9
    dev = prob.R_wb.device
    # Visual-noise floor on the information: (1e-3 rad)^2 on rotation,
    # sigma_vis^2 on velocity and position.
    sigma_vis = 0.01
    floor = torch.diag(torch.cat([torch.full((3,), 1e-6, device=dev),
                                  torch.full((6,), sigma_vis ** 2, device=dev)]))
    eye9 = torch.eye(9, device=dev)
    info_eff = torch.linalg.inv_ex(
        torch.linalg.inv_ex(prob.imu_info + 1e-6 * eye9).inverse + floor).inverse
    prob = prob._replace(imu_info=info_eff)

    bg_boot = _gyro_bias_only(prob)
    v_boot, g_boot, s_boot = _linear_vgs(prob, bg_boot, fix_scale=fix_scale,
                                         sigma_vis=sigma_vis)
    s_boot = torch.clamp(s_boot, 0.05, 50.0)
    if prob.Rwg0 is not None:
        Rwg0 = prob.Rwg0
    else:
        dirG = g_boot / torch.clamp(torch.linalg.norm(g_boot), min=1e-9)
        gI = torch.tensor([0.0, 0.0, -1.0], device=dev)
        vcross = torch.linalg.cross(gI, dirG)
        sin_n = torch.linalg.norm(vcross)
        ang = torch.atan2(sin_n, torch.dot(gI, dirG))
        axis = vcross / torch.clamp(sin_n, min=1e-9)
        Rwg0 = torch.where(sin_n < 1e-6, torch.eye(3, device=dev), lie.so3_exp(axis * ang))

    w_edge = (prob.imu_valid & prob.kf_valid & torch.roll(prob.kf_valid, -1)).float()
    info = prob.imu_info * w_edge[:, None, None]
    pr = torch.zeros(n, device=dev)
    pr[3 * K:3 * K + 3] = prior_g
    pr[3 * K + 3:3 * K + 6] = prior_a
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if fix_scale:
        keep[n - 1] = False
    if fix_gdir:
        keep[3 * K + 6:3 * K + 8] = False
    bias_only = torch.zeros(n, device=dev)
    bias_only[3 * K:] = 1.0
    step_clip = torch.full((n,), float("inf"), device=dev)
    step_clip[n - 1] = 0.5
    eye_n = torch.eye(n, device=dev)

    def residuals(params):
        return _gs_residuals(params, prob, Rwg0)

    def gn_step(params):
        r = residuals(params)
        J = jacfwd(residuals)(params)                            # [K,9,n]
        JtI = torch.einsum("eki,ekl->eil", J, info)
        H = torch.einsum("eil,elj->ij", JtI, J) + torch.diag(pr)
        g_vec = torch.einsum("eil,el->i", JtI, r) + pr * params * bias_only
        # A fixed variable: its row and column zeroed, 1 on the diagonal.
        H = torch.where(keep[:, None] & keep[None, :], H, 0.0) + torch.diag((~keep).float())
        g_vec = torch.where(keep, g_vec, 0.0)
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-10))
        dx = _solve(H / d_eq[:, None] / d_eq[None, :] + 1e-7 * eye_n, -(g_vec / d_eq)) / d_eq
        # Trust region on the scale step (ep is exponential in log s).
        return torch.clamp(dx, -step_clip, step_clip)

    def cost_of(params):
        r = residuals(params)
        return (torch.sum(torch.einsum("ek,ekl,el->e", r, info, r))
                + prior_g * torch.sum(params[3 * K:3 * K + 3] ** 2)
                + prior_a * torch.sum(params[3 * K + 3:3 * K + 6] ** 2))

    params = torch.cat([v_boot.reshape(-1), bg_boot, torch.zeros(5, device=dev),
                        torch.log(s_boot)[None]])
    c0 = torch.zeros((), device=dev)
    for _ in range(iters):
        dx = gn_step(params)
        c0 = cost_of(params)
        cand1, cand2 = params + dx, params + 0.3 * dx
        best = torch.argmin(torch.stack([c0, cost_of(cand1), cost_of(cand2)]))
        params = torch.where(best == 1, cand1, torch.where(best == 2, cand2, params))
    thg = params[3 * K + 6:3 * K + 8]
    Rwg = Rwg0 @ lie.so3_exp(torch.cat([thg, torch.zeros_like(thg[:1])]))
    return InertialInitResult(v_wb=params[:3 * K].reshape(K, 3), bg=params[3 * K:3 * K + 3],
                              ba=params[3 * K + 3:3 * K + 6], Rwg=Rwg,
                              scale=torch.exp(params[3 * K + 8]), cost=c0)


def apply_scaled_rotation(R_wb, p_wb, v_wb, lm_pos, Rwg, scale):
    """Rotate the world so gravity is -z and apply the recovered scale
    (reference Map::ApplyScaledRotation after IMU init)."""
    Rgw = Rwg.T
    return (torch.einsum("ij,kjl->kil", Rgw, R_wb),
            scale * torch.einsum("ij,kj->ki", Rgw, p_wb),
            scale * torch.einsum("ij,kj->ki", Rgw, v_wb),
            scale * torch.einsum("ij,lj->li", Rgw, lm_pos))
