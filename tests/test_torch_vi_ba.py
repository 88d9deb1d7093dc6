"""Visual-inertial BA of the port against the JAX package on
tests/test_vi_ba.py's simulated window (constant yaw, sinusoidal
acceleration, IMU at 200 Hz, 0.5 px noise, perturbed initial states): the
cost history, poses, velocities, biases and landmarks after the LM steps,
and merge_inertial_ba across a weld. Tolerances: the cost history rtol 5e-3
(the port's closed-form inertial Jacobians and the JAX package's jacfwd
agree within 2e-5 on entries of order 1, test_inertial_terms_jacobians,
which moves a middle LM step's cost by up to 0.2 %), rotations and
positions atol 1e-4, velocities 1e-3, biases 1e-4, landmarks 1e-3."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.optim import vi_ba as jvb
from rover_slam_tpu_torch.optim import vi_ba as tvb

from test_vi_ba import make_problem, simulate_vi
from torch_parity import torch_problem

TOL = dict(R=1e-4, p=1e-4, v=1e-3, bg=1e-4, ba=1e-4, X=1e-3)


def _compare(out_t, out_j, **tol):
    tol = {**TOL, **tol}
    for name, a, b in zip(("R", "p", "v", "bg", "ba", "X"), out_t[:6], out_j[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol[name],
                                   err_msg=name)
    np.testing.assert_allclose(out_t[6].numpy(), np.asarray(out_j[6]), rtol=5e-3)


@pytest.fixture(scope="module")
def sim():
    return simulate_vi(Kw=6, Lw=100)


@pytest.mark.parametrize("fix_first", [1, 2])
def test_solve_vi_ba(sim, fix_first):
    pj = make_problem(sim, fix_first=fix_first)
    out_j = jvb.solve_vi_ba(pj, iters=8)
    out_t = tvb.solve_vi_ba(torch_problem(tvb.VIBAProblem, pj), iters=8)
    _compare(out_t, out_j)
    costs = out_t[6].numpy()
    assert costs[-1] < 0.5 * costs[0]
    # Fixed poses stay bit-exact.
    pt = torch_problem(tvb.VIBAProblem, pj)
    assert torch.equal(out_t[0][:fix_first], pt.R_wb[:fix_first])


def test_solve_vi_ba_masked_landmarks_and_edges(sim):
    """Landmarks outside the optimized set and invalid edges (the window
    code's padding) take no part, on both sides. The landmarks (6-14 m
    deep) are held to 2e-3: with the edges thinned they are less
    constrained, and the order of the f32 sums (it follows the number of
    CPU threads) moves them by up to 1.1e-3."""
    pj = make_problem(sim)
    lm_opt = np.arange(pj.lm_pos.shape[0]) % 7 != 0
    e_valid = np.arange(pj.e_kf.shape[0]) % 11 != 0
    pj = pj._replace(lm_opt_mask=np.asarray(lm_opt), e_valid=np.asarray(e_valid))
    out_j = jvb.solve_vi_ba(pj, iters=6)
    out_t = tvb.solve_vi_ba(torch_problem(tvb.VIBAProblem, pj), iters=6)
    _compare(out_t, out_j, X=2e-3)
    np.testing.assert_array_equal(out_t[5].numpy()[~lm_opt], np.asarray(pj.lm_pos)[~lm_opt])


def test_merge_inertial_ba(sim):
    """The weld breaks the IMU chain at weld_slot - 1 and fixes slot 0. Three
    LM steps: past them the two sides, tied by reprojections alone, drift
    apart on equal costs along a weakly observed direction (rounding of the
    f32 solve, not of the model). Along it lies the accelerometer bias, held
    to 5e-4 here."""
    pj = make_problem(sim, fix_first=0)
    out_j = jvb.merge_inertial_ba(pj, 3, iters=3)
    out_t = tvb.merge_inertial_ba(torch_problem(tvb.VIBAProblem, pj), 3, iters=3)
    _compare(out_t, out_j, ba=5e-4)
    assert torch.equal(out_t[0][0], torch.from_numpy(np.array(pj.R_wb[0])))


def test_inertial_terms_jacobians(sim):
    """The closed-form Jacobians of the inertial residual against the JAX
    package's jax.jacfwd of its own residual (atol 2e-5 on entries of order
    1; f32 rounding of its arccos-based so3_log derivative) and against
    central differences of the port's residual (atol 2e-3); the residuals
    themselves within 1e-5."""
    pt = torch_problem(tvb.VIBAProblem, make_problem(sim))
    K = pt.R_wb.shape[0]
    i = torch.arange(K - 1)
    j = i + 1
    si = (pt.R_wb[i], pt.p_wb[i], pt.v_wb[i], pt.bg[i] + 0.001, pt.ba[i] - 0.01)
    sj = (pt.R_wb[j], pt.p_wb[j], pt.v_wb[j])
    imu = tuple(getattr(pt, f)[i] for f in tvb.IMU_FIELDS)
    r, Ji, Jj = tvb.inertial_terms(si, sj, imu)
    z = jnp.zeros(15)
    args_j = [jnp.asarray(a.numpy()) for a in (*si, *sj, *imu)]
    rj = jax.vmap(lambda *a: jvb._inertial_residual(z, z, *a))(*args_j)
    for argnum, J in ((0, Ji), (1, Jj)):
        Jx = jax.vmap(lambda *a: jax.jacfwd(jvb._inertial_residual, argnums=argnum)(z, z, *a))(
            *args_j)
        np.testing.assert_allclose(J.numpy(), np.asarray(Jx), rtol=0, atol=2e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
    h = 1e-3
    for which, J in ((0, Ji), (1, Jj)):
        for k in (0, 4, 7, 10, 13):
            d = torch.zeros((K - 1, 15))
            d[:, k] = h
            zero = torch.zeros_like(d)
            args = (d, zero) if which == 0 else (zero, d)
            rp = tvb._inertial_residual(*args, *si, *sj, *imu)
            args = (-d, zero) if which == 0 else (zero, -d)
            rm = tvb._inertial_residual(*args, *si, *sj, *imu)
            np.testing.assert_allclose(J[:, :, k].numpy(), ((rp - rm) / (2 * h)).numpy(),
                                       atol=2e-3)
