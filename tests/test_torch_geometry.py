"""Leaf math of the port (lie, cameras, triangulation, blockinv, robust)
against the JAX package on the same numpy inputs, at f32 tolerance
(rtol 1e-5, atol 1e-5 unless a case states its own bound and reason)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import cameras as jcam, lie as jlie, triangulation as jtri
from rover_slam_tpu.optim import blockinv as jbi, ba as jba, robust as jrob
from rover_slam_tpu_torch.geometry import cameras as tcam, lie as tlie, triangulation as ttri
from rover_slam_tpu_torch.optim import blockinv as tbi, robust as trob

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def _rotvecs(rng, n):
    """Generic, small-angle (Taylor branch) and near-pi rotation vectors."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.01, 3.0, n - 6),
                          [0.0, 1e-6, 3e-5, np.pi - 5e-4, np.pi - 2e-3, 2.5]])
    return (axes * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize("fn", ["so3_hat", "so3_exp", "so3_right_jacobian",
                                "so3_right_jacobian_inv", "so3_left_jacobian",
                                "so3_left_jacobian_inv"])
def test_so3_maps(fn):
    w = _rotvecs(np.random.default_rng(0), 40)
    # The inverse Jacobians divide by theta*sin(theta), which cancels near pi
    # in f32: 1e-4 there.
    tol = dict(rtol=1e-4, atol=1e-4) if fn.endswith("_inv") else TOL
    _close(getattr(tlie, fn)(*_t(w)), getattr(jlie, fn)(*_j(w)), **tol)


def test_so3_log_all_branches():
    w = _rotvecs(np.random.default_rng(1), 40)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    # Near pi, arccos amplifies the f32 rounding of the trace: 1e-4 there.
    _close(tlie.so3_log(*_t(R)), jlie.so3_log(*_j(R)), rtol=1e-4, atol=1e-4)
    _close(tlie.so3_log(*_t(R[:-3])), jlie.so3_log(*_j(R[:-3])))


def test_se3_exp_log_compose_inverse_apply():
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=(30, 3)), _rotvecs(rng, 30)], 1).astype(np.float32)
    (Rj, tj), (Rt, tt) = jlie.se3_exp(*_j(xi)), tlie.se3_exp(*_t(xi))
    _close(Rt, Rj)
    _close(tt, tj)
    R, t = np.asarray(Rj), np.asarray(tj)
    _close(tlie.se3_log(*_t(R[:-3], t[:-3])), jlie.se3_log(*_j(R[:-3], t[:-3])),
           rtol=1e-4, atol=1e-4)
    for a, b in zip(tlie.se3_inverse(*_t(R, t)), jlie.se3_inverse(*_j(R, t))):
        _close(a, b)
    R2, t2 = R[::-1].copy(), t[::-1].copy()
    for a, b in zip(tlie.se3_compose(*_t(R, t, R2, t2)), jlie.se3_compose(*_j(R, t, R2, t2))):
        _close(a, b)
    X = rng.normal(size=(30, 3)).astype(np.float32)
    _close(tlie.se3_apply(*_t(R, t, X)), jlie.se3_apply(*_j(R, t, X)))
    # one pose applied to a point cloud (broadcast batch)
    _close(tlie.se3_apply(*_t(R[0], t[0], X)), jlie.se3_apply(*_j(R[0], t[0], X)))


def test_normalize_rotation():
    rng = np.random.default_rng(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(_rotvecs(rng, 20))))
    Rn = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    _close(tlie.normalize_rotation(*_t(Rn)), jlie.normalize_rotation(*_j(Rn)))


PIN = np.asarray([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], np.float32)
KB8 = np.asarray([190.978, 190.973, 254.932, 256.897, 0.00348238, 0.000715034,
                  -0.00205323, 0.000202936], np.float32)


def _points(rng, n=200):
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                     rng.uniform(0.5, 12, n)], 1).astype(np.float32)


@pytest.mark.parametrize("kind,params", [(0, PIN), (1, KB8)])
def test_camera_project_unproject(kind, params):
    X = _points(np.random.default_rng(4))
    uv_j = jcam.project(kind, *_j(params, X))
    uv_t = tcam.project(kind, *_t(params, X))
    _close(uv_t, uv_j, rtol=1e-5, atol=1e-3)     # pixels up to ~1e3: f32 ulp ~6e-5
    uv = np.asarray(uv_j)
    _close(tcam.unproject(kind, *_t(params, uv)), jcam.unproject(kind, *_j(params, uv)),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,params", [(0, PIN), (1, KB8)])
def test_camera_jacobian(kind, params):
    X = _points(np.random.default_rng(5))
    # KB8: closed form here vs jacfwd there; entries reach ~1e3 px/m.
    _close(tcam.project_jac(kind, *_t(params, X)), jcam.project_jac(kind, *_j(params, X)),
           rtol=1e-4, atol=1e-3)


def _two_views(rng, n=100):
    X = _points(rng, n) + np.asarray([0, 0, 3], np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t0 = np.asarray([0.1, 0.0, -0.05], np.float32)
    R1 = np.asarray(jlie.so3_exp(jnp.asarray([-0.03, 0.1, 0.0], jnp.float32)))
    t1 = np.asarray([-0.6, 0.05, 0.1], np.float32)
    r0 = (R0 @ X.T).T + t0
    r1 = (R1 @ X.T).T + t1
    r0 = (r0 / r0[:, 2:] + rng.normal(0, 1e-3, r0.shape) * [1, 1, 0]).astype(np.float32)
    r1 = (r1 / r1[:, 2:] + rng.normal(0, 1e-3, r1.shape) * [1, 1, 0]).astype(np.float32)
    return r0, r1, R0, t0, R1, t1


def test_triangulation():
    r0, r1, R0, t0, R1, t1 = _two_views(np.random.default_rng(6))
    Xj, vj = jtri.triangulate_and_check(*_j(r0, r1, R0, t0, R1, t1))
    Xt, vt = ttri.triangulate_and_check(*_t(r0, r1, R0, t0, R1, t1))
    # Normal-equation solve on points up to ~15 m deep: 1e-4 relative.
    _close(Xt, Xj, rtol=1e-4, atol=1e-4)
    assert (vt.numpy() == np.asarray(vj)).all()
    R01 = R0 @ R1.T
    t01 = t0 - R01 @ t1
    _close(ttri.triangulate_dlt(*_t(r0, r1, R01, t01)),
           jtri.triangulate_dlt(*_j(r0, r1, R01, t01)), rtol=1e-4, atol=1e-4)
    _close(ttri.parallax_cos(*_t(r0, r1)), jtri.parallax_cos(*_j(r0, r1)))


def _spd(rng, batch, n):
    A = rng.normal(size=batch + (n, n))
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("fn,n", [("inv3", 3), ("inv6", 6), ("chol3", 3)])
def test_blockinv_closed_forms(fn, n):
    M = _spd(np.random.default_rng(7), (50,), n)
    _close(getattr(tbi, fn)(*_t(M)), getattr(jbi, fn)(*_j(M)))


@pytest.mark.parametrize("n", [1, 2, 5, 7, 12, 96])
def test_blockinv_invn_solven(n):
    rng = np.random.default_rng(8)
    M = _spd(rng, (4,), n)
    b = rng.normal(size=(4, n)).astype(np.float32)
    # n = 96 is the reduced camera system of a 16-keyframe window: deeper
    # recursion, 1e-4.
    tol = TOL if n < 50 else dict(rtol=1e-4, atol=1e-4)
    _close(tbi.invn(*_t(M)), jbi.invn(*_j(M)), **tol)
    _close(tbi.solven(*_t(M, b)), jbi.solven(*_j(M, b)), **tol)


def test_blockinv_solves():
    rng = np.random.default_rng(9)
    for n, ft, fj in ((3, tbi.solve3, jbi.solve3), (6, tbi.solve6, jbi.solve6)):
        M = _spd(rng, (20,), n)
        b = rng.normal(size=(20, n)).astype(np.float32)
        _close(ft(*_t(M, b)), fj(*_j(M, b)))


def test_robust():
    chi2 = np.random.default_rng(10).uniform(0, 30, 500).astype(np.float32)
    assert trob.CHI2_MONO == jrob.CHI2_MONO and trob.CHI2_STEREO == jrob.CHI2_STEREO
    _close(trob.huber_weight(torch.from_numpy(chi2), 5.991),
           jrob.huber_weight(jnp.asarray(chi2), 5.991))
    _close(trob.huber_cost(torch.from_numpy(chi2), 5.991),
           jba._huber_cost(jnp.asarray(chi2), 5.991))
