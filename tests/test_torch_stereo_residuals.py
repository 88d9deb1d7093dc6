"""The stereo residual row of the port's solvers against the JAX package's:
tests/test_stereo_residuals.py's three cases (scale in pose optimization,
scale in BA, the 7.815 chi2 gate) through both packages, pose for pose, with
both of the port's solve_ba solvers ("schur" with its direct reduced solve,
"pcg"); pose_inertial and vi_ba on the JAX tests' simulate_vi problems with
each edge's true inverse depth added; and a problem whose edges all have
invd = -1, which must give the mono result to the bit. Tolerances: poses
atol 1e-4 (positions of a 4-10 m scene in f32), landmarks 1e-3, the VI
states as tests/test_torch_vi_ba.py and test_torch_pose_inertial.py hold
them, inlier sets equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import cameras as jcam, lie as jlie
from rover_slam_tpu.optim import ba as jba, pose_inertial as jpio, pose_opt as jpo
from rover_slam_tpu.optim import vi_ba as jvb
from rover_slam_tpu_torch.optim import ba as tba, pose_inertial as tpio, pose_opt as tpo
from rover_slam_tpu_torch.optim import vi_ba as tvb

from test_pose_inertial import _build_problem, _perturbed
from test_stereo_residuals import _scene
from test_vi_ba import make_problem, simulate_vi
from torch_parity import POINT, POSE, torch_problem

BF = 458.0 * 0.11


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_both(R0, t0, X, uv, invd=None, **kw):
    valid = np.ones((X.shape[0],), bool)
    cam = _scene(1)[1]
    st = {} if invd is None else dict(invd=invd, bf=np.float32(BF))
    rj = jpo.pose_optimization(*(jnp.asarray(a) for a in (R0, t0, X, uv, valid, cam)),
                               **{k: jnp.asarray(v) for k, v in st.items()}, **kw)
    rt = tpo.pose_optimization(*(_t(a) for a in (R0, t0, X, uv, valid, cam)),
                               **{k: _t(v) for k, v in st.items()}, **kw)
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), **POSE)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), **POSE)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    return rt, rj


def test_stereo_pose_opt_scale():
    X, cam = _scene()
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])), np.float32)
    t_gt = np.array([0.3, -0.1, 0.5], np.float32)
    Xc = X @ R_gt.T + t_gt
    uv = np.asarray(jcam.project(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(Xc)))
    invd = (1.0 / Xc[:, 2]).astype(np.float32)
    rt, _ = _pose_both(R_gt, t_gt * 1.2, X, uv, invd)
    assert float(torch.linalg.norm(rt.t_cw - _t(t_gt))) < 1e-2
    assert int(rt.n_inliers) > 190


def _ba_problem(seed=1, n=300, s=1.3):
    """tests/test_stereo_residuals.py's two-keyframe BA: the estimate is the
    scene scaled by s, the stereo rows measure metric inverse depth."""
    X, cam = _scene(n, seed=seed)
    R1 = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.05, 0.0])), np.float32)
    poses = ((np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
             (R1, np.array([-0.4, 0.0, 0.1], np.float32)))
    uv, invd = [], []
    for R, t in poses:
        Xc = X @ R.T + t
        uv.append(np.asarray(jcam.project(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(Xc))))
        invd.append((1.0 / Xc[:, 2]).astype(np.float32))
    kw = dict(R_cw=np.stack([p[0] for p in poses]),
              t_cw=np.stack([p[1] * s for p in poses]),
              pose_opt_mask=np.asarray([False, True]), lm_pos=X * s,
              lm_opt_mask=np.ones((n,), bool), cam_params=cam,
              e_kf=np.repeat(np.arange(2, dtype=np.int32), n),
              e_lm=np.tile(np.arange(n, dtype=np.int32), 2),
              e_uv=np.concatenate(uv), e_valid=np.ones((2 * n,), bool),
              e_info=np.ones((2 * n,), np.float32))
    return X, kw, np.concatenate(invd)


def _ba_both(kw, solver, **extra):
    opts = dict(iters=15, phases=1, solver=solver, cg_iters=30)
    rj = jba.solve_ba(jba.BAProblem(**{k: jnp.asarray(v) for k, v in {**kw, **extra}.items()}),
                      kf_major=True, red_solver="direct", **opts)
    rt = tba.solve_ba(tba.BAProblem(**{k: _t(v) for k, v in {**kw, **extra}.items()}), **opts)
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), **POSE)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), **POSE)
    np.testing.assert_allclose(rt.lm_pos.numpy(), np.asarray(rj.lm_pos), **POINT)
    np.testing.assert_array_equal(rt.e_inlier.numpy(), np.asarray(rj.e_inlier))
    return rt


@pytest.mark.parametrize("solver", ["schur", "pcg"])
def test_stereo_ba_fixes_scale(solver):
    X, kw, invd = _ba_problem()
    mono = _ba_both(kw, solver)
    stereo = _ba_both(kw, solver, e_invd=invd, bf=np.float32(BF))
    scale_mono = float(torch.median(mono.lm_pos[:, 2] / _t(X[:, 2])))
    scale_stereo = float(torch.median(stereo.lm_pos[:, 2] / _t(X[:, 2])))
    assert abs(scale_mono - 1.3) < 0.05, scale_mono
    assert abs(scale_stereo - 1.0) < 0.05, scale_stereo


@pytest.mark.parametrize("solver", ["schur", "pcg"])
def test_no_stereo_edges_is_mono_to_the_bit(solver):
    """e_invd all -1: the third row is zero on every edge and every gate is
    the mono one, so solve_ba gives the mono solve, bit for bit.
    pose_optimization's 6x6 normal equations are one einsum over (edge, row),
    whose summation order follows the row count: there the zero row moves
    the pose by rounding only (held to 1e-6), with equal inlier sets."""
    _, kw, invd = _ba_problem(seed=3, n=120)
    kw = {k: _t(v) for k, v in kw.items()}
    opts = dict(iters=4, phases=2, solver=solver, cg_iters=10)
    mono = tba.solve_ba(tba.BAProblem(**kw), **opts)
    none = tba.solve_ba(tba.BAProblem(**kw, e_invd=torch.full((240,), -1.0),
                                      bf=torch.tensor(BF)), **opts)
    for a, b in zip(mono, none):
        assert torch.equal(a, b)
    X, cam = _scene(80, seed=4)
    uv = np.asarray(jcam.project(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(X)))
    args = [_t(a) for a in (np.eye(3, dtype=np.float32), np.full(3, 0.05, np.float32), X, uv,
                            np.ones(80, bool), cam)]
    po_m = tpo.pose_optimization(*args)
    po_n = tpo.pose_optimization(*args, invd=torch.full((80,), -1.0), bf=torch.tensor(BF))
    for a, b in zip(po_m[:2], po_n[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(po_m.inliers, po_n.inliers)


def test_stereo_chi2_gate():
    """A v-row error of chi2 6.5 (between 5.991 and 7.815) stays an inlier
    as a stereo edge and is rejected as a mono one, in both packages."""
    X, cam = _scene(50, seed=2)
    uv = np.array(jcam.project(jcam.PINHOLE, jnp.asarray(cam), jnp.asarray(X)))
    invd = (1.0 / X[:, 2]).astype(np.float32)
    uv[0, 1] += np.sqrt(6.5)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    kw = dict(rounds=1, iters_per_round=0)
    rs, _ = _pose_both(eye, zero, X, uv, invd, **kw)
    rm, _ = _pose_both(eye, zero, X, uv, **kw)
    assert bool(rs.inliers[0]) and not bool(rm.inliers[0])


def _sim_invd(sim, sel=None):
    """The true inverse depth of each simulate_vi edge (camera = body), -1 on
    every fifth edge (a keypoint with no right-eye match)."""
    R_gt, p_gt, Xw, (e_kf, e_lm, _) = sim[0], sim[1], sim[5], sim[7]
    Xc = np.einsum("eji,ej->ei", R_gt[e_kf], Xw[e_lm] - p_gt[e_kf])
    invd = (1.0 / Xc[:, 2]).astype(np.float32)
    invd[np.arange(len(invd)) % 5 == 0] = -1.0
    return invd if sel is None else invd[sel]


def test_stereo_vi_ba():
    sim = simulate_vi(Kw=5, Lw=100)
    pj = make_problem(sim)._replace(e_invd=jnp.asarray(_sim_invd(sim)),
                                    bf=jnp.asarray(BF, jnp.float32))
    out_j = jvb.solve_vi_ba(pj, iters=6)
    out_t = tvb.solve_vi_ba(torch_problem(tvb.VIBAProblem, pj), iters=6)
    for name, a, b, tol in zip(("R", "p", "v", "bg", "ba", "X"), out_t[:6], out_j[:6],
                               (1e-4, 1e-4, 1e-3, 1e-4, 1e-4, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(out_t[6].numpy(), np.asarray(out_j[6]), rtol=5e-3)
    mono = tvb.solve_vi_ba(torch_problem(tvb.VIBAProblem, make_problem(sim)), iters=6)
    # The stereo rows pin the landmarks' depths: closer to the truth than mono.
    err = [float(torch.linalg.norm(o[5] - _t(sim[5]), dim=1).mean()) for o in (out_t, mono)]
    assert err[0] < err[1], err


def test_stereo_pose_inertial():
    """Frames 1 and 2 in a chain, as test_torch_pose_inertial.py's
    test_last_frame_chain: frame 1 anchored on the keyframe, frame 2 free
    under the port's marginal prior from frame 1 (the JAX side given the
    same prior and anchor). Six observations of each frame are corrupted by
    40 px: the stereo gates reject them too."""
    sim = simulate_vi(Kw=4, Lw=120, seed=10)
    R_gt, p_gt, v_gt, bg_true, ba_true = sim[:5]
    e_kf, _, uv = sim[7]
    anchor, prior_H = (R_gt[0], p_gt[0], v_gt[0], bg_true, ba_true), None
    for k in (1, 2):
        R1, p1, v1, bg1, ba1 = _perturbed(sim, k, np.random.default_rng(3 + k))
        uv_k = uv[e_kf == k].copy()
        uv_k[:6] += 40.0
        prob_j = _build_problem(sim, k, R1, p1, v1, bg1, ba1, prior_H=prior_H,
                                anchor_state=anchor, uv_override=uv_k)
        prob_j = prob_j._replace(invd=jnp.asarray(_sim_invd(sim, e_kf == k)),
                                 bf=jnp.asarray(BF, jnp.float32))
        res_j = jpio.solve_pose_inertial(prob_j, anchor_fixed=(k == 1))
        res_t = tpio.solve_pose_inertial(torch_problem(tpio.PoseInertialProblem, prob_j),
                                         anchor_fixed=(k == 1))
        for f, tol in dict(R_wb=1e-4, p_wb=1e-4, v_wb=1e-3, bg=1e-3, ba=1e-3, R_wb0=1e-4,
                           p_wb0=1e-4).items():
            np.testing.assert_allclose(getattr(res_t, f).numpy(),
                                       np.asarray(getattr(res_j, f)), rtol=0, atol=tol,
                                       err_msg=f)
        np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
        assert not res_t.inliers[:6].any() and int(res_t.n_inliers) >= 100
        Hj = np.asarray(res_j.marg_H)
        np.testing.assert_allclose(res_t.marg_H.numpy(), Hj, rtol=0,
                                   atol=1e-3 * np.abs(Hj).max())
        assert np.linalg.norm(res_t.p_wb.numpy() - p_gt[k]) < 1e-2
        anchor = tuple(a.numpy() for a in (res_t.R_wb, res_t.p_wb, res_t.v_wb, res_t.bg,
                                           res_t.ba))
        prior_H = res_t.marg_H.numpy()
