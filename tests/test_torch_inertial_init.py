"""Inertial-only initialization of the port against the JAX package on
tests/test_inertial_init.py's problems (visual poses scaled by 1/2.5 and
tilted away from gravity): each stage (gyro bias, the linear velocity /
gravity / scale solve) and the whole staged optimization with its prior
schedules, fixed scale and fixed gravity direction; then the world
alignment. Tolerances: scale rtol 1e-4, gravity rotation atol 1e-5, gyro
bias 1e-6, accel bias 1e-4, velocities 1e-4 (metric, ~1 m/s). With zero
bias priors (VIBA2's schedule) the accelerometer bias and the gravity tilt
are one unobservable direction over this 2.25 s window: both sides converge
(cost 2e-8) to other points of it, 1.5e-4 rad and 1.4e-3 m/s^2 apart
(= 9.81 x 1.5e-4), so there the tilt is held to 5e-4 and ba to 5e-3."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import lie as jlie
from rover_slam_tpu.optim import inertial_init as jii
from rover_slam_tpu_torch.optim import inertial_init as tii

from test_inertial_init import make_init_problem
from test_vi_ba import simulate_vi
from torch_parity import torch_problem


@pytest.fixture(scope="module")
def sim():
    return simulate_vi(Kw=10)


def _problem(sim, **kw):
    pj = make_init_problem(sim, scale_error=2.5, grav_rot=(0.06, -0.04), **kw)
    return pj, torch_problem(tii.InertialInitProblem, pj)


def test_bootstrap_stages(sim):
    pj, pt = _problem(sim)
    bg_j = jii._gyro_bias_only(pj)
    bg_t = tii._gyro_bias_only(pt)
    np.testing.assert_allclose(bg_t.numpy(), np.asarray(bg_j), rtol=0, atol=1e-6)
    for fix_scale in (False, True):
        vj, gj, sj = jii._linear_vgs(pj, bg_j, fix_scale=fix_scale)
        vt, gt, st = tii._linear_vgs(pt, torch.from_numpy(np.array(bg_j)), fix_scale=fix_scale)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-4)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(prior_g=1e2, prior_a=1e10), dict(prior_g=1.0, prior_a=1e5),
                                dict(prior_g=0.0, prior_a=0.0), dict(fix_scale=True),
                                dict(fix_gdir=True)],
                         ids=["stage1", "viba1", "viba2", "fix_scale", "fix_gdir"])
def test_inertial_only_optimization(sim, kw):
    pj, pt = _problem(sim)
    rj = jii.inertial_only_optimization(pj, **kw)
    rt = tii.inertial_only_optimization(pt, **kw)
    flat = kw.get("prior_a", 1) == 0.0
    np.testing.assert_allclose(float(rt.scale), float(rj.scale), rtol=1e-4)
    np.testing.assert_allclose(rt.Rwg.numpy(), np.asarray(rj.Rwg), rtol=0,
                               atol=5e-4 if flat else 1e-5)
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), rtol=0,
                               atol=5e-3 if flat else 1e-4)
    np.testing.assert_allclose(rt.v_wb.numpy(), np.asarray(rj.v_wb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3, atol=1e-3)
    if "fix_scale" not in kw:
        assert abs(float(rt.scale) - 2.5) < 0.125


def test_padded_window_and_given_gravity(sim):
    """The system's bucket padding (masked slots repeat the last keyframe,
    zero information) and a given gravity bootstrap Rwg0."""
    pj, _ = _problem(sim)
    K = pj.R_wb.shape[0]
    pad = 6

    def padf(a, zero):
        a = np.asarray(a)
        tail = np.zeros((pad,) + a.shape[1:], a.dtype) if zero else np.repeat(a[-1:], pad, 0)
        return jnp.asarray(np.concatenate([a, tail]))

    pj = pj._replace(**{f: padf(getattr(pj, f), f not in ("R_wb", "p_wb"))
                        for f in pj._fields if f.startswith("imu_") or f in ("R_wb", "p_wb")},
                     kf_valid=jnp.asarray(np.arange(K + pad) < K),
                     Rwg0=jlie.so3_exp(jnp.asarray([0.05, -0.03, 0.0])))
    rj = jii.inertial_only_optimization(pj)
    rt = tii.inertial_only_optimization(torch_problem(tii.InertialInitProblem, pj))
    np.testing.assert_allclose(float(rt.scale), float(rj.scale), rtol=1e-4)
    np.testing.assert_allclose(rt.Rwg.numpy(), np.asarray(rj.Rwg), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.v_wb.numpy(), np.asarray(rj.v_wb), rtol=0, atol=1e-4)


def test_padded_slots_ignore_unwritten_eigenvalues(sim, monkeypatch):
    """On the card the batched eigh leaves an all-zero matrix's eigenvalues
    unwritten, and a padded slot's weight matrix is all zero: with the
    allocator's NaNs there the linear solve returned NaN in one process and
    a finite scale in another (C4). Here eigh is made to return NaN for
    every all-zero matrix, as the card can: the padded solve is unchanged
    and matches the JAX package's."""
    pj, _ = _problem(sim)
    K, pad = pj.R_wb.shape[0], 6

    def padf(a, zero):
        a = np.asarray(a)
        tail = np.zeros((pad,) + a.shape[1:], a.dtype) if zero else np.repeat(a[-1:], pad, 0)
        return jnp.asarray(np.concatenate([a, tail]))

    pj = pj._replace(**{f: padf(getattr(pj, f), f not in ("R_wb", "p_wb"))
                        for f in pj._fields if f.startswith("imu_") or f in ("R_wb", "p_wb")},
                     kf_valid=jnp.asarray(np.arange(K + pad) < K))
    pt = torch_problem(tii.InertialInitProblem, pj)
    bg = torch.from_numpy(np.array(jii._gyro_bias_only(pj)))
    want = tii._linear_vgs(pt, bg)
    eigh = torch.linalg.eigh

    def unwritten_for_zero(M):
        lam, U = eigh(M)
        zero = (M == 0).flatten(-2).all(-1)
        return torch.where(zero[..., None], float("nan"), lam), U

    monkeypatch.setattr(torch.linalg, "eigh", unwritten_for_zero)
    got = tii._linear_vgs(pt, bg)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    vj, gj, sj = jii._linear_vgs(pj, jnp.asarray(bg.numpy()))
    np.testing.assert_allclose(float(got[2]), float(sj), rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(gj), rtol=0, atol=1e-4)


def test_apply_scaled_rotation(sim):
    R, p, v, X = (np.asarray(a, np.float32) for a in (sim[0], sim[1], sim[2], sim[5]))
    Rwg = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.05, 0.0])))
    out_j = jii.apply_scaled_rotation(*(jnp.asarray(a) for a in (R, p, v, X, Rwg)),
                                      jnp.float32(2.0))
    out_t = tii.apply_scaled_rotation(*(torch.from_numpy(np.array(a)) for a in (R, p, v, X, Rwg)),
                                      torch.tensor(2.0))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
