"""Motion-only visual-inertial pose optimization with a recursive marginal
prior: the per-frame VI tracking step.

Counterpart of rover_slam_tpu/optim/pose_inertial.py (the reference's
PoseInertialOptimizationLastKeyFrame / LastFrame). The frame's 15-dof state
[pose, v, bg, ba] is optimized against the reprojection edges of fixed
landmarks, one inertial edge and the bias random walk to an anchor (the last
keyframe, fixed; or the last frame, free under the 15-dim prior of the
previous marginalization). A 30-dim damped Gauss-Newton over 4 rounds with
the escalating chi2 gates re-classifies outliers between rounds; the anchor
is then Schur-marginalized into the prior for the next frame. The `lax.scan`
loops are Python loops whose accept/reject and damping stay on the device.
Stereo observations (invd, bf) add the third residual row of
optim/ba.py::stereo_row (the reference's EdgeStereoOnlyPose).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, cameras
from . import blockinv, robust
from .ba import stereo_row
from .vi_ba import IMU_FIELDS, inertial_terms, _inertial_residual

CHI2_ROUNDS = (12.0, 7.5, 5.991, 5.991)


class PoseInertialProblem(NamedTuple):
    # Anchor body state (last keyframe or last frame): the prior's mean.
    R_wb0: torch.Tensor   # [3,3]
    p_wb0: torch.Tensor   # [3]
    v_wb0: torch.Tensor   # [3]
    bg0: torch.Tensor     # [3]
    ba0: torch.Tensor     # [3]
    # Current frame body state (initial estimate).
    R_wb1: torch.Tensor
    p_wb1: torch.Tensor
    v_wb1: torch.Tensor
    bg1: torch.Tensor
    ba1: torch.Tensor
    prior_H: torch.Tensor      # [15,15] information on the anchor
    prior_valid: torch.Tensor  # 0-dim bool
    # Preintegration anchor -> frame.
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
    imu_info: torch.Tensor     # [9,9]
    walk_info: torch.Tensor    # [6] diagonal info of the bias random walk
    # Visual edges to fixed landmarks.
    Xw: torch.Tensor           # [M,3]
    uv: torch.Tensor           # [M,2]
    e_valid: torch.Tensor      # [M] bool
    e_info: torch.Tensor       # [M]
    R_cb: torch.Tensor         # [3,3] body->camera
    t_cb: torch.Tensor         # [3]
    cam_params: torch.Tensor
    invd: torch.Tensor = None  # [M] stereo inverse depth (<= 0: mono edge)
    bf: torch.Tensor = None


class PoseInertialResult(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v_wb: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    # The anchor (moved in LastFrame mode, unchanged in LastKeyFrame mode).
    R_wb0: torch.Tensor
    p_wb0: torch.Tensor
    v_wb0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor
    inliers: torch.Tensor    # [M] bool
    n_inliers: torch.Tensor
    marg_H: torch.Tensor     # [15,15] prior for the next frame
    R_cw: torch.Tensor       # camera pose of the frame
    t_cw: torch.Tensor


def _reproj_frame(prob: PoseInertialProblem, cam_kind, R_wb, p_wb):
    """Residuals [M,D], Jacobians in the frame pose [th, p] ([M,D,6]) and
    depths of the visual edges (EdgeMonoOnlyPose: landmarks are constants;
    D = 3 with stereo observations: ba.stereo_row)."""
    y = prob.Xw - p_wb[None, :]
    Xb = torch.einsum("ji,ej->ei", R_wb, y)
    Xc = torch.einsum("ij,ej->ei", prob.R_cb, Xb) + prob.t_cb
    e = prob.uv - cameras.project(cam_kind, prob.cam_params, Xc)
    G = -cameras.project_jac(cam_kind, prob.cam_params, Xc)
    if prob.invd is not None and prob.bf is not None:
        e, G = stereo_row(cam_kind, e, G, Xc, prob.invd, prob.bf)
    M3 = prob.R_cb @ R_wb.T
    J_p = -torch.einsum("eij,jk->eik", G, M3)
    J_th = torch.einsum("eij,ejk->eik", torch.einsum("eij,jk->eik", G, M3), lie.so3_hat(y))
    return e, torch.cat([J_th, J_p], dim=-1), Xc[..., 2]


def solve_pose_inertial(prob: PoseInertialProblem, cam_kind: int = cameras.PINHOLE,
                        anchor_fixed: bool = True, rounds: int = 4,
                        iters_per_round: int = 4) -> PoseInertialResult:
    """anchor_fixed=True: LastKeyFrame (the anchor is fixed, no prior);
    False: LastFrame (the anchor is free under prior_H and marginalized)."""
    M = prob.Xw.shape[0]
    D = 15
    dev = prob.Xw.device
    gates = (CHI2_ROUNDS[:rounds] + CHI2_ROUNDS[-1:] * max(0, rounds - len(CHI2_ROUNDS)))
    imu = tuple(getattr(prob, f)[None] for f in IMU_FIELDS)
    eye2D = torch.eye(2 * D, device=dev)
    fixm = torch.arange(2 * D, device=dev) < D
    # Stereo edges: the 3-dof Huber delta, and each round's gate scaled by
    # 7.815 / 5.991 (the reference's {15.6, 9.8, 7.815, 7.815}). The cost
    # test keeps the mono delta, as the JAX package does.
    huber_d2, gate_scale = robust.CHI2_MONO, 1.0
    if prob.invd is not None:
        huber_d2 = torch.where(prob.invd > 0, robust.CHI2_STEREO, robust.CHI2_MONO)
        gate_scale = torch.where(prob.invd > 0, robust.CHI2_STEREO / robust.CHI2_MONO, 1.0)

    def imu_residual(x):
        Ra, pa, va, bga, baa, Rf, pf, vf, _, _ = x
        return _inertial_residual(None, None, Ra[None], pa[None], va[None], bga[None],
                                  baa[None], Rf[None], pf[None], vf[None], *imu)[0]

    def linearize(x, inlier_mask, use_kernel):
        """The 30x30 system [2,15,2,15] and g [2,15] at the states x."""
        Ra, pa, va, bga, baa, Rf, pf, vf, bgf, baf = x
        H = torch.zeros((2, D, 2, D), device=dev)
        g = torch.zeros((2, D), device=dev)
        e, J6, depth = _reproj_frame(prob, cam_kind, Rf, pf)
        chi2 = torch.sum(e * e, dim=-1) * prob.e_info
        w = robust.huber_weight(chi2, huber_d2) if use_kernel else torch.ones_like(chi2)
        w = w * prob.e_info * inlier_mask * prob.e_valid * (depth > 0.05)
        Jv = torch.nn.functional.pad(J6, (0, 9))
        wJv = Jv * w[:, None, None]
        H[1, :, 1, :] += torch.einsum("eki,ekj->ij", wJv, Jv)
        g[1] += torch.einsum("eki,ek->i", wJv, e)
        ri, Ja, Jf = inertial_terms((Ra[None], pa[None], va[None], bga[None], baa[None]),
                                    (Rf[None], pf[None], vf[None]), imu)
        ri, Ja, Jf = ri[0], Ja[0], Jf[0]
        JaT_I = Ja.T @ prob.imu_info
        JfT_I = Jf.T @ prob.imu_info
        H[0, :, 0, :] += JaT_I @ Ja
        H[1, :, 1, :] += JfT_I @ Jf
        H[0, :, 1, :] += JaT_I @ Jf
        H[1, :, 0, :] += JfT_I @ Ja
        g[0] += JaT_I @ ri
        g[1] += JfT_I @ ri
        # Bias random walk anchor -> frame.
        rb = torch.cat([bgf - bga, baf - baa])
        Wb = torch.diag(prob.walk_info)
        H[0, 9:, 0, 9:] += Wb
        H[1, 9:, 1, 9:] += Wb
        H[0, 9:, 1, 9:] -= Wb
        H[1, 9:, 0, 9:] -= Wb
        g[0, 9:] -= prob.walk_info * rb
        g[1, 9:] += prob.walk_info * rb
        # Prior on the anchor (residual 0 at its mean, J = I).
        H[0, :, 0, :] += prob.prior_valid.float() * prob.prior_H
        return H, g

    def apply_step(x, dx):
        Ra, pa, va, bga, baa, Rf, pf, vf, bgf, baf = x
        da, df = dx[0], dx[1]
        return (lie.normalize_rotation(lie.so3_exp(da[0:3]) @ Ra), pa + da[3:6],
                va + da[6:9], bga + da[9:12], baa + da[12:15],
                lie.normalize_rotation(lie.so3_exp(df[0:3]) @ Rf), pf + df[3:6],
                vf + df[6:9], bgf + df[9:12], baf + df[12:15])

    def total_cost(x, inlier_mask, use_kernel):
        Ra, pa, va, bga, baa, Rf, pf, vf, bgf, baf = x
        e, _, depth = _reproj_frame(prob, cam_kind, Rf, pf)
        chi2 = torch.sum(e * e, dim=-1) * prob.e_info
        m = inlier_mask * prob.e_valid * (depth > 0.05)
        c_vis = torch.sum((robust.huber_cost(chi2, robust.CHI2_MONO) if use_kernel
                           else chi2) * m)
        ri = imu_residual(x)
        c_imu = ri @ prob.imu_info @ ri
        rb = torch.cat([bgf - bga, baf - baa])
        return c_vis + c_imu + torch.sum(prob.walk_info * rb * rb)

    x = (prob.R_wb0, prob.p_wb0, prob.v_wb0, prob.bg0, prob.ba0,
         prob.R_wb1, prob.p_wb1, prob.v_wb1, prob.bg1, prob.ba1)
    inlier_mask = torch.ones(M, device=dev)
    for rnd in range(rounds):
        use_kernel = rnd < rounds - 1
        lam = torch.full((), 1e-4, device=dev)     # made on the device: no host copy
        # The cost at x: carried from the last step's accept/reject (the JAX
        # package recomputes it, to the same bits).
        c_old = total_cost(x, inlier_mask, use_kernel)
        for _ in range(iters_per_round):
            H, g = linearize(x, inlier_mask, use_kernel)
            Hm, gm = H.reshape(2 * D, 2 * D), g.reshape(2 * D)
            if anchor_fixed:
                Hm = torch.where(fixm[:, None] | fixm[None, :], 0.0, Hm)
                Hm = Hm + torch.diag(fixm.float())
                gm = torch.where(fixm, 0.0, gm)
            Hd = Hm + torch.diag(lam * torch.clamp(torch.diagonal(Hm), min=1e-8)) + 1e-8 * eye2D
            # Jacobi equilibration for the f32 solve (information spans ~1e10).
            d_eq = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12))
            y = blockinv.solven(Hd / d_eq[:, None] / d_eq[None, :], -(gm / d_eq))
            dx = (y / d_eq).reshape(2, D)
            if anchor_fixed:
                dx = torch.cat([torch.zeros_like(dx[:1]), dx[1:]])
            x_new = apply_step(x, dx)
            c_new = total_cost(x_new, inlier_mask, use_kernel)
            ok = c_new < c_old
            x = tuple(torch.where(ok, n, o) for n, o in zip(x_new, x))
            c_old = torch.where(ok, c_new, c_old)
            lam = torch.clamp(torch.where(ok, lam * 0.3, lam * 5.0), 1e-8, 1e4)
        # Re-classify outliers at this round's gate.
        e, _, depth = _reproj_frame(prob, cam_kind, x[5], x[6])
        chi2 = torch.sum(e * e, dim=-1) * prob.e_info
        inlier_mask = ((chi2 <= gates[rnd] * gate_scale) & (depth > 0.05)).float()

    # Marginalization: the kernel-off Hessian at the solution over the final
    # inliers, the anchor Schur-eliminated (equilibrated before the
    # unpivoted recursive inverse).
    H, _ = linearize(x, inlier_mask, False)
    H_ff = H[1, :, 1, :]
    if anchor_fixed:
        marg = H_ff
    else:
        eye = torch.eye(D, device=dev)
        H_aa = H[0, :, 0, :] + 1e-6 * eye
        d_eq = torch.sqrt(torch.clamp(torch.diagonal(H_aa), min=1e-12))
        H_aa_e = H_aa / d_eq[:, None] / d_eq[None, :]
        H_fa_e = H[1, :, 0, :] / d_eq[None, :]
        marg = H_ff - H_fa_e @ blockinv.invn(H_aa_e + 1e-9 * eye) @ H_fa_e.T
    marg = 0.5 * (marg + marg.T)

    Ra, pa, va, bga, baa, Rf, pf, vf, bgf, baf = x
    inliers = (inlier_mask > 0) & prob.e_valid
    R_cw = prob.R_cb @ Rf.T
    t_cw = -R_cw @ pf + prob.t_cb
    return PoseInertialResult(
        R_wb=Rf, p_wb=pf, v_wb=vf, bg=bgf, ba=baf, R_wb0=Ra, p_wb0=pa, v_wb0=va,
        bg0=bga, ba0=baa, inliers=inliers, n_inliers=torch.sum(inliers, dtype=torch.int32),
        marg_H=marg, R_cw=R_cw, t_cw=t_cw)
