"""Motion-only VI pose optimization of the port against the JAX package on
tests/test_pose_inertial.py's problems: both anchor modes (LastKeyFrame:
anchor fixed; LastFrame: anchor free under the previous marginal prior),
the marginal prior marg_H, and the chi2 inlier gating with corrupted
observations. Tolerances: rotations and positions atol 1e-4, velocities and
biases 1e-3, marg_H relative 1e-3 of its largest entry, inlier sets equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.imu import preintegration as jpre
from rover_slam_tpu.optim import pose_inertial as jpio
from rover_slam_tpu_torch.optim import pose_inertial as tpio

from test_pose_inertial import _build_problem, _perturbed
from test_vi_ba import simulate_vi
from torch_parity import torch_problem

TOL = dict(R_wb=1e-4, p_wb=1e-4, v_wb=1e-3, bg=1e-3, ba=1e-3, R_wb0=1e-4, p_wb0=1e-4,
           v_wb0=1e-3, bg0=1e-3, ba0=1e-3, R_cw=1e-4, t_cw=1e-4)


def _solve_both(prob_j, anchor_fixed):
    res_j = jpio.solve_pose_inertial(prob_j, anchor_fixed=anchor_fixed)
    prob_t = torch_problem(tpio.PoseInertialProblem, prob_j)
    res_t = tpio.solve_pose_inertial(prob_t, anchor_fixed=anchor_fixed)
    for f, tol in TOL.items():
        np.testing.assert_allclose(getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)),
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    Hj = np.asarray(res_j.marg_H)
    np.testing.assert_allclose(res_t.marg_H.numpy(), Hj, rtol=0, atol=1e-3 * np.abs(Hj).max())
    return res_t, res_j


def test_last_keyframe_mode():
    sim = simulate_vi(Kw=4, Lw=120, seed=10)
    R1, p1, v1, bg1, ba1 = _perturbed(sim, 1, np.random.default_rng(3))
    res_t, _ = _solve_both(_build_problem(sim, 1, R1, p1, v1, bg1, ba1), True)
    np.testing.assert_allclose(res_t.p_wb0.numpy(), sim[1][0], atol=1e-6)


def test_last_frame_chain():
    """Frames 1-4 in a chain: the first anchored on the keyframe, each later
    one free under the port's own previous marginal prior (the JAX side
    given the same prior and anchor)."""
    sim = simulate_vi(Kw=5, Lw=120, seed=12)
    R_gt, p_gt, v_gt, bg_true, ba_true = sim[:5]
    anchor = (R_gt[0], p_gt[0], v_gt[0], bg_true, ba_true)
    prior_H = None
    for k in range(1, 5):
        R1, p1, v1 = (np.asarray(x) for x in jpre.predict_state(
            *(jnp.asarray(a) for a in anchor[:3]), sim[6][k - 1],
            jnp.asarray(anchor[3]), jnp.asarray(anchor[4])))
        prob = _build_problem(sim, k, R1, p1, v1, anchor[3], anchor[4], prior_H=prior_H,
                              anchor_state=anchor)
        res_t, _ = _solve_both(prob, anchor_fixed=(k == 1))
        anchor = tuple(a.numpy() for a in (res_t.R_wb, res_t.p_wb, res_t.v_wb, res_t.bg,
                                           res_t.ba))
        prior_H = res_t.marg_H.numpy()
        assert np.linalg.norm(anchor[1] - p_gt[k]) < 1e-2


def test_inlier_gating():
    sim = simulate_vi(Kw=4, Lw=150, seed=13)
    e_kf, _, uv = sim[7]
    rng = np.random.default_rng(6)
    uv_k = uv[e_kf == 1].copy()
    bad = rng.choice(len(uv_k), 30, replace=False)
    uv_k[bad] += rng.uniform(30, 80, (30, 2)) * rng.choice([-1, 1], (30, 2))
    R1, p1, v1, bg1, ba1 = _perturbed(sim, 1, rng, pose_noise=0.02)
    prob = _build_problem(sim, 1, R1, p1, v1, bg1, ba1, uv_override=uv_k)
    res_t, _ = _solve_both(prob, True)
    assert not res_t.inliers.numpy()[bad].any()


@pytest.mark.parametrize("rounds,iters", [(2, 3), (5, 2)])
def test_round_schedules(rounds, iters):
    """Fewer rounds than gates, and more (the last gate repeats)."""
    sim = simulate_vi(Kw=4, Lw=120, seed=11)
    R1, p1, v1, bg1, ba1 = _perturbed(sim, 1, np.random.default_rng(4))
    prob_j = _build_problem(sim, 1, R1, p1, v1, bg1, ba1)
    res_j = jpio.solve_pose_inertial(prob_j, rounds=rounds, iters_per_round=iters)
    res_t = tpio.solve_pose_inertial(torch_problem(tpio.PoseInertialProblem, prob_j),
                                     rounds=rounds, iters_per_round=iters)
    np.testing.assert_allclose(res_t.p_wb.numpy(), np.asarray(res_j.p_wb), atol=1e-4)
    np.testing.assert_array_equal(res_t.inliers.numpy(), np.asarray(res_j.inliers))
    assert torch.isfinite(res_t.marg_H).all()
