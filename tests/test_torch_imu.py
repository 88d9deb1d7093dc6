"""IMU preintegration of the port against the JAX package on the same numpy
inputs (random samples from a seed): integrate with masked padding, merge,
information_9, predict_state and the bias-corrected getters, and the
synthetic IMU generators. Tolerances are stated per comparison: f32
rounding of a 40-step chain (atol 1e-5 on rotations and deltas, relative
1e-4 on the covariance and 1e-3 on its inverse, whose entries reach 1e9)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.imu import preintegration as jpre
from rover_slam_tpu.utils import synthetic as jsyn
from rover_slam_tpu_torch.imu import preintegration as tpre
from rover_slam_tpu_torch.utils import synthetic as tsyn

CALIB_NP = dict(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                sigma_g=np.float32(1.7e-4 * np.sqrt(200.0)),
                sigma_a=np.float32(2e-3 * np.sqrt(200.0)),
                walk_g=np.float32(1.9e-5 / np.sqrt(200.0)),
                walk_a=np.float32(3e-3 / np.sqrt(200.0)))
CALIB_J = jpre.ImuCalib(**{k: jnp.asarray(v) for k, v in CALIB_NP.items()})
CALIB_T = tpre.calib_from_numpy(CALIB_J)
TOL = {"dR": 1e-5, "dV": 1e-5, "dP": 1e-5, "JRg": 1e-5, "JVg": 1e-5, "JVa": 1e-5,
       "JPg": 1e-5, "JPa": 1e-5, "dt": 1e-6, "bg": 0, "ba": 0}


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    acc = (np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    gyro = (np.array([0.05, 0.4, -0.1]) + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    dts = np.full(n, 1.0 / 200.0, np.float32) + rng.uniform(0, 1e-4, n).astype(np.float32)
    return acc, gyro, dts


def _biases(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.003, 3).astype(np.float32),
            rng.normal(0, 0.03, 3).astype(np.float32))


def _both(n_real, n_pad=0, seed=0):
    acc, gyro, dts = _samples(n_real + n_pad, seed)
    mask = np.arange(n_real + n_pad) < n_real
    bg, ba = _biases(seed + 100)
    sj = jpre.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                        jnp.asarray(mask), CALIB_J, bg=jnp.asarray(bg), ba=jnp.asarray(ba))
    st = tpre.integrate(torch.from_numpy(acc), torch.from_numpy(gyro), torch.from_numpy(dts),
                        torch.from_numpy(mask), CALIB_T, bg=torch.from_numpy(bg),
                        ba=torch.from_numpy(ba))
    return st, sj, (acc, gyro, dts, bg, ba)


def _assert_state_close(st, sj):
    for f in tpre.PreintState._fields:
        a, b = st._asdict()[f].numpy(), np.asarray(getattr(sj, f))
        if f == "C":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(), err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL[f], err_msg=f)


@pytest.mark.parametrize("n_real,n_pad", [(40, 24), (7, 57), (64, 0)])
def test_integrate_with_padding(n_real, n_pad):
    """The padded window of the JAX package; the port's unpadded window of
    the real samples alone equals its padded one bit for bit (a masked step
    leaves the state as it was)."""
    st, sj, (acc, gyro, dts, bg, ba) = _both(n_real, n_pad, seed=n_real)
    _assert_state_close(st, sj)
    st_real = tpre.integrate(torch.from_numpy(acc[:n_real]), torch.from_numpy(gyro[:n_real]),
                             torch.from_numpy(dts[:n_real]), None, CALIB_T,
                             bg=torch.from_numpy(bg), ba=torch.from_numpy(ba))
    for a, b in zip(st_real, st):
        assert torch.equal(a, b)


def test_merge_and_information_9():
    s1, j1, _ = _both(20, 0, seed=1)
    s2, j2, _ = _both(33, 0, seed=2)
    s2 = s2._replace(bg=s1.bg, ba=s1.ba)       # merge's contract: one linearization bias
    j2 = j2._replace(bg=j1.bg, ba=j1.ba)
    _assert_state_close(tpre.merge(s1, s2), jpre.merge(j1, j2))
    for st, sj in ((s1, j1), (tpre.merge(s1, s2), jpre.merge(j1, j2))):
        it, ij = tpre.information_9(st).numpy(), np.asarray(jpre.information_9(sj))
        np.testing.assert_allclose(it, ij, rtol=1e-3, atol=1e-3 * np.abs(ij).max())
    batched = tpre.information_9(tpre.PreintState(*(torch.stack([a, b]) for a, b in zip(s1, s2))))
    assert torch.equal(batched[0], tpre.information_9(s1))


def test_predict_state_and_bias_jacobians():
    st, sj, _ = _both(40, 0, seed=5)
    rng = np.random.default_rng(6)
    R0 = np.array(jsyn.lie.so3_exp(jnp.asarray([0.1, -0.3, 0.2])), np.float32)
    p0 = rng.normal(size=3).astype(np.float32)
    v0 = rng.normal(size=3).astype(np.float32)
    dbg, dba = _biases(7)
    bg = np.array(sj.bg) + dbg
    ba = np.array(sj.ba) + dba
    T = [torch.from_numpy(x) for x in (R0, p0, v0, bg, ba)]
    J = [jnp.asarray(x) for x in (R0, p0, v0, bg, ba)]
    out_t = tpre.predict_state(T[0], T[1], T[2], st, T[3], T[4])
    out_j = jpre.predict_state(J[0], J[1], J[2], sj, J[3], J[4])
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tpre.delta_rotation(st, T[3]).numpy(),
                               np.asarray(jpre.delta_rotation(sj, J[3])), atol=1e-5)
    np.testing.assert_allclose(tpre.delta_velocity(st, T[3], T[4]).numpy(),
                               np.asarray(jpre.delta_velocity(sj, J[3], J[4])), atol=1e-5)
    np.testing.assert_allclose(tpre.delta_position(st, T[3], T[4]).numpy(),
                               np.asarray(jpre.delta_position(sj, J[3], J[4])), atol=1e-5)


def test_carry_helpers():
    _, sj, _ = _both(9, 0, seed=3)
    st = tpre.preint_from_numpy(sj)
    for f in tpre.PreintState._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    assert tpre.init_state().dR.dtype == torch.float32


@pytest.mark.parametrize("gen", ["orbit_with_imu", "wavy_forward_with_imu"])
def test_synthetic_imu_generators(gen):
    """Same seed, same samples as the JAX package's to f32 rounding (the
    rotations come from each package's f32 so3_exp, one ulp apart at most):
    poses and IMU samples within atol 1e-5 plus rtol 1e-5, times exact."""
    kw = dict(n_frames=12, dt=0.1)
    tol = dict(rtol=1e-5, atol=1e-5)
    out_t = getattr(tsyn, gen)(**kw)
    out_j = getattr(jsyn, gen)(**kw)
    for a, b in zip(out_t[:4], out_j[:4]):
        np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_array_equal(out_t[2], out_j[2])
    assert len(out_t[4]) == len(out_j[4]) == 11
    for (at, gt, tt), (aj, gj, tj) in zip(out_t[4], out_j[4]):
        np.testing.assert_allclose(at, aj, **tol)
        np.testing.assert_allclose(gt, gj, **tol)
        np.testing.assert_array_equal(tt, tj)
