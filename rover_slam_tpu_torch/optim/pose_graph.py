"""Pose-graph optimization over Sim(3) keyframe poses (the essential graph of
loop correction).

Counterpart of rover_slam_tpu/optim/pose_graph.py. Each edge (i, j) carries a
measured relative Sim3 S_ij and the residual r_ij = log(S_ij S_j S_i^-1) in
R^7; Gauss-Newton takes the edge Jacobians by forward-mode autodiff
(`torch.func.jvp`, the JAX package's `jax.jacfwd`) at the zero left
perturbation. The dense [7K, 7K] system is assembled by sorted segment sums
(`ops/scatterless.py`: no float atomics, a run repeats to the bit) and solved
by block-Jacobi PCG whose scalars stay on the device. The 4-DoF variant
(yaw + translation, for inertial maps) shares that system.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..geometry import lie
from ..ops.scatterless import seg_sum, segment_plan
from .blockinv import invn


def _block_pcg(H, g, pmask_cols, iters: int):
    """Solve H x = g by block-Jacobi PCG. H [K,D,K,D], g [K,D]; fixed
    variables (pmask_cols 0) have identity blocks and zero right-hand side,
    so their solution stays zero."""
    K, D = g.shape
    n = K * D
    Hm = H.reshape(n, n)
    ar = torch.arange(K, device=g.device)
    eye = torch.eye(D, device=g.device)
    Pb = invn(H[ar, :, ar, :] + 1e-8 * eye)

    def pc(r):
        return torch.einsum("kij,kj->ki", Pb, r) * pmask_cols[:, None]

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, torch.full_like(v, 1e-20), v)

    b = g * pmask_cols[:, None]
    x = torch.zeros_like(b)
    r, p = b, pc(b)
    rz = torch.sum(b * p)
    for _ in range(iters):
        Ap = (Hm @ p.reshape(n)).reshape(K, D)
        alpha = rz / guard(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        rz_n = torch.sum(r * z)
        p = z + (rz_n / guard(rz)) * p
        rz = rz_n
    return x


class PoseGraphProblem(NamedTuple):
    s: torch.Tensor          # [K] scales (world->cam)
    R: torch.Tensor          # [K,3,3]
    t: torch.Tensor          # [K,3]
    opt_mask: torch.Tensor   # [K] False = fixed (loop KF / gauge)
    e_i: torch.Tensor        # [E] edge endpoints
    e_j: torch.Tensor
    e_s: torch.Tensor        # [E] measured relative Sim3: S_ij maps j-frame -> i-frame
    e_R: torch.Tensor        # [E,3,3]
    e_t: torch.Tensor        # [E,3]
    e_valid: torch.Tensor    # [E]
    e_weight: torch.Tensor   # [E] information scale


def relative_sim3(s_i, R_i, t_i, s_j, R_j, t_j):
    """S_ij = S_i * S_j^-1 (maps j-camera frame into i-camera frame)."""
    return lie.sim3_compose(s_i, R_i, t_i, *lie.sim3_inverse(s_j, R_j, t_j))


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """r = log( S_m * (exp(xi_j) S_j) * (exp(xi_i) S_i)^-1 ), a 7-vector."""
    s1, R1, t1 = lie.sim3_compose(*lie.sim3_exp(xi_i), s_i, R_i, t_i)
    s2, R2, t2 = lie.sim3_compose(*lie.sim3_exp(xi_j), s_j, R_j, t_j)
    se, Re, te = lie.sim3_compose(s2, R2, t2, *lie.sim3_inverse(s1, R1, t1))
    se, Re, te = lie.sim3_compose(s_m, R_m, t_m, se, Re, te)
    return lie.sim3_log(se, Re, te)


def _edge_jacobians(res, xi_i, xi_j, *meas):
    """Jacobians [E,d,d] of every edge's residual res(xi_i, xi_j, *meas) in
    its two endpoints' perturbations: edge e depends on row e alone, so one
    forward-mode pass per tangent direction, applied to all edges at once,
    gives column k of every edge's Jacobian."""
    d = xi_i.shape[1]
    basis = torch.eye(d, device=xi_i.device)[:, None, :].expand(d, xi_i.shape[0], d)

    def cols(which):
        def one(v):
            return jvp(lambda a, b: res(a, b, *meas), (xi_i, xi_j),
                       (v, torch.zeros_like(v)) if which == 0 else (torch.zeros_like(v), v))[1]
        return vmap(one)(basis).permute(1, 2, 0)          # [d,E,d] -> [E,d,d]

    return cols(0), cols(1)


class _GraphSystem:
    """The Gauss-Newton system of a pose graph over K vertices of d dof:
    H [K,d,K,d] and g [K,d] summed from the edges' Jacobian blocks by sorted
    segment sums (one sort for the whole solve), fixed vertices held by
    identity blocks, damping lam on the free ones, solved by block-Jacobi
    PCG."""

    def __init__(self, prob: PoseGraphProblem, d: int, lam: float):
        K = prob.R.shape[0]
        dev = prob.R.device
        self.K, self.d = K, d
        self.ei, self.ej = prob.e_i.long(), prob.e_j.long()
        ei, ej = self.ei, self.ej
        self.plan_H = segment_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej,
                                              ej * K + ei]), K * K)
        self.plan_g = segment_plan(torch.cat([ei, ej]), K)
        self.w = prob.e_valid.float() * prob.e_weight
        self.pmask = prob.opt_mask.float()
        fixed = self.pmask == 0
        eye = torch.eye(d, device=dev)
        self.diag_add = torch.where(fixed[:, None, None], eye, lam * eye)
        self.keep_fixed = fixed[:, None, None, None] | fixed[None, None, :, None]
        self.ar = torch.arange(K, device=dev)
        # PCG moves information about one graph hop per iteration.
        self.pcg_iters = max(48, K // 2)

    def step(self, r, Ji, Jj):
        """(cost at the linearization point, dx [K,d] of the GN step)."""
        K, d, w, pmask = self.K, self.d, self.w, self.pmask
        E = r.shape[0]
        cost = torch.sum(w * torch.sum(r * r, dim=-1))
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        Hij = torch.einsum("eki,ekj->eij", Jiw, Jj)
        blocks = torch.cat([torch.einsum("eki,ekj->eij", Jiw, Ji),
                            torch.einsum("eki,ekj->eij", Jjw, Jj),
                            Hij, Hij.transpose(-1, -2)])
        H = seg_sum(self.plan_H, blocks.reshape(4 * E, d * d)).reshape(K, K, d, d)
        H = H.permute(0, 2, 1, 3).contiguous()                   # [K,d,K,d]
        g = seg_sum(self.plan_g, torch.cat([torch.einsum("eki,ek->ei", Jiw, r),
                                            torch.einsum("eki,ek->ei", Jjw, r)]))
        H = torch.where(self.keep_fixed, 0.0, H)
        H[self.ar, :, self.ar, :] += self.diag_add
        g = g * pmask[:, None]
        return cost, -_block_pcg(H, g, pmask, self.pcg_iters) * pmask[:, None]


def optimize_essential_graph(prob: PoseGraphProblem, iters: int = 20, fix_scale: bool = False):
    """Gauss-Newton over Sim3 poses (damping 1e-6). Returns (s, R, t,
    cost_history [iters]). fix_scale locks every vertex's scale (the
    stereo/RGBD graphs)."""
    gs = _GraphSystem(prob, 7, 1e-6)
    if fix_scale:
        gs.diag_add = gs.diag_add.clone()
        gs.diag_add[:, 6, 6] += 1e12
    ei, ej = gs.ei, gs.ej
    zero = torch.zeros((ei.shape[0], 7), device=prob.s.device)
    opt = gs.pmask > 0
    s, R, t = prob.s, prob.R, prob.t
    costs = []
    for _ in range(iters):
        args = (s[ei], R[ei], t[ei], s[ej], R[ej], t[ej], prob.e_s, prob.e_R, prob.e_t)
        r = _edge_residual(zero, zero, *args)
        cost, dx = gs.step(r, *_edge_jacobians(_edge_residual, zero, zero, *args))
        costs.append(cost)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], dim=1)
        s_new, R_new, t_new = lie.sim3_compose(*lie.sim3_exp(dx), s, R, t)
        R_new = lie.normalize_rotation(R_new)
        s = torch.where(opt, s_new, s)
        R = torch.where(opt[:, None, None], R_new, R)
        t = torch.where(opt[:, None], t_new, t)
    return s, R, t, torch.stack(costs)


def _yaw(x):
    """Rotations about the world z axis by x[..., 3]."""
    return lie.so3_exp(torch.nn.functional.pad(x[..., 3:4], (2, 0)))


def _residual_4dof(x_i, x_j, R_i, t_i, R_j, t_j, R_m, t_m):
    """6-dim SE3 residual log(T_m T_j T_i^-1) with the 4-dof updates
    [dt(3), dyaw] applied to both endpoints (reference Edge4DoF +
    VertexPose4DoF: roll and pitch are gravity-locked after IMU alignment)."""
    Rzi, Rzj = _yaw(x_i), _yaw(x_j)
    Ri_ = Rzi @ R_i
    ti_ = torch.einsum("...ij,...j->...i", Rzi, t_i) + x_i[..., :3]
    Rj_ = Rzj @ R_j
    tj_ = torch.einsum("...ij,...j->...i", Rzj, t_j) + x_j[..., :3]
    Rr, tr = lie.se3_compose(Rj_, tj_, *lie.se3_inverse(Ri_, ti_))
    return lie.se3_log(*lie.se3_compose(R_m, t_m, Rr, tr))


def optimize_pose_graph_4dof(prob: PoseGraphProblem, iters: int = 20):
    """4-DoF (yaw + translation) pose graph for inertial maps (reference
    OptimizeEssentialGraph4DoF), damping 1e-6. Uses the edge measurements'
    (R, t); scales are ignored. Returns (R, t, cost_history [iters])."""
    gs = _GraphSystem(prob, 4, 1e-6)
    ei, ej = gs.ei, gs.ej
    zero = torch.zeros((ei.shape[0], 4), device=prob.R.device)
    opt = gs.pmask > 0
    R, t = prob.R, prob.t
    costs = []
    for _ in range(iters):
        args = (R[ei], t[ei], R[ej], t[ej], prob.e_R, prob.e_t)
        r = _residual_4dof(zero, zero, *args)
        cost, dx = gs.step(r, *_edge_jacobians(_residual_4dof, zero, zero, *args))
        costs.append(cost)
        Rz = _yaw(dx)
        R_new = lie.normalize_rotation(torch.einsum("kij,kjl->kil", Rz, R))
        t_new = torch.einsum("kij,kj->ki", Rz, t) + dx[:, :3]
        R = torch.where(opt[:, None, None], R_new, R)
        t = torch.where(opt[:, None], t_new, t)
    return R, t, torch.stack(costs)


def sim3_to_se3(s, R, t):
    """SE3 camera poses from Sim3 ones: translation divided by scale."""
    return R, t / torch.clamp(s[..., None], min=1e-12)


def correct_landmarks(lm_pos, lm_ref_kf, s_old, R_old, t_old, s_new, R_new, t_new, lm_mask):
    """Carry landmarks through their reference keyframe's Sim3 correction:
    X_new = S_new^-1 S_old X_old."""
    ref = lm_ref_kf.long()
    Xc = lie.sim3_apply(s_old[ref], R_old[ref], t_old[ref], lm_pos)
    Xw = lie.sim3_apply(*lie.sim3_inverse(s_new[ref], R_new[ref], t_new[ref]), Xc)
    return torch.where(lm_mask[:, None], Xw, lm_pos)
