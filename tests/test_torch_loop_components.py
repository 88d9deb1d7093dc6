"""Loop-closing components of the port against the JAX package on identical
inputs: Sim(3) on the Lie group, Horn, the Sim3 RANSAC (the JAX package's
own draws handed in) and the GN refit. Tolerances: poses atol 1e-4 (POSE),
inlier masks and counts exact. The pose graph is in
tests/test_torch_loop_graph.py, the global BA and the database in
tests/test_torch_loop_gba.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import lie as jlie
from rover_slam_tpu.optim import sim3_solver as jsim3
from rover_slam_tpu_torch.geometry import lie as tlie
from rover_slam_tpu_torch.optim import sim3_solver as tsim3

from torch_parity import CAM, POSE, _np


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def _close(t_out, j_out, tol):
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# Sim(3)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rot, scale", [(0.5, 0.2), (1e-7, 0.2), (0.5, 1e-7), (0.0, 0.0)],
                         ids=["generic", "small_theta", "small_sigma", "identity"])
def test_sim3_exp_log_compose_inverse(rot, scale):
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(16, 7)).astype(np.float32)
    xi[:, 3:6] *= rot
    xi[:, 6] *= scale
    sj, Rj, tj = jlie.sim3_exp(jnp.asarray(xi))
    st, Rt, tt = tlie.sim3_exp(torch.from_numpy(xi))
    _close((st, Rt, tt), (sj, Rj, tj), POSE)
    _close((tlie.sim3_log(st, Rt, tt),), (jlie.sim3_log(sj, Rj, tj),), POSE)
    np.testing.assert_allclose(tlie.sim3_log(st, Rt, tt).numpy(), xi, atol=1e-4)
    b = slice(8, None)
    comp_t = tlie.sim3_compose(st[:8], Rt[:8], tt[:8], st[b], Rt[b], tt[b])
    comp_j = jlie.sim3_compose(sj[:8], Rj[:8], tj[:8], sj[b], Rj[b], tj[b])
    _close(comp_t, comp_j, POSE)
    _close(tlie.sim3_inverse(st, Rt, tt), jlie.sim3_inverse(sj, Rj, tj), POSE)
    X = rng.normal(size=(16, 3)).astype(np.float32)
    _close((tlie.sim3_apply(st, Rt, tt, torch.from_numpy(X)),),
           (jlie.sim3_apply(sj, Rj, tj, jnp.asarray(X)),), POSE)


# --------------------------------------------------------------------------
# Sim3 estimation
# --------------------------------------------------------------------------

def _sim3_scene(M=300, seed=0, outliers=60):
    """Points in camera 1, their images under a known Sim3 S21 in camera 2,
    with pixel noise and gross outliers."""
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 12, M)],
                  1).astype(np.float32)
    s = np.float32(1.3)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02], jnp.float32)))
    t = np.asarray([0.2, -0.1, 0.4], np.float32)
    X2 = (s * X1 @ R.T + t).astype(np.float32)
    X2 += rng.normal(0, 0.01, X2.shape).astype(np.float32)
    X2[:outliers] += rng.uniform(-1, 1, (outliers, 3)).astype(np.float32)

    def proj(X):
        return (X[:, :2] / X[:, 2:] * CAM[:2] + CAM[2:4]).astype(np.float32)

    uv1 = proj(X1) + rng.normal(0, 0.5, (M, 2)).astype(np.float32)
    uv2 = proj(X2) + rng.normal(0, 0.5, (M, 2)).astype(np.float32)
    return rng, X1, X2, uv1, uv2, (s, R, t)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3(fix_scale):
    rng, X1, X2, _, _, _ = _sim3_scene(outliers=0)
    w = rng.uniform(0, 1, X1.shape[0]).astype(np.float32)
    for ww in (None, w):
        out_j = jsim3.horn_sim3(*_j(X1, X2), None if ww is None else jnp.asarray(ww),
                                fix_scale=fix_scale)
        out_t = tsim3.horn_sim3(*_t(X1, X2), None if ww is None else torch.from_numpy(ww),
                                fix_scale=fix_scale)
        _close(out_t, out_j, POSE)
    # Batched over hypotheses, as the RANSAC calls it.
    idx = rng.integers(0, X1.shape[0], (5, 3))
    out_t = tsim3.horn_sim3(*_t(X1[idx], X2[idx]), fix_scale=fix_scale)
    for h in range(5):
        _close([x[h] for x in out_t], jsim3.horn_sim3(*_j(X1[idx[h]], X2[idx[h]]),
                                                      fix_scale=fix_scale), POSE)


def _draws(key, both, n_hyp=300):
    """jax.random.choice as sim3_ransac draws its [300, 3] samples."""
    p = jnp.asarray(both, jnp.float32) / max(int(np.sum(both)), 1)
    return np.asarray(jax.random.choice(key, len(both), shape=(n_hyp, 3), replace=True, p=p))


@pytest.mark.parametrize("one_sided", [False, True])
def test_sim3_ransac_with_injected_draws(one_sided):
    rng, X1, X2, uv1, uv2, (s, R, t) = _sim3_scene()
    M = X1.shape[0]
    mask = rng.uniform(size=M) > 0.05
    has1 = has2 = None
    both = mask
    if one_sided:
        has1 = rng.uniform(size=M) > 0.3
        has2 = rng.uniform(size=M) > 0.3
        both = mask & has1 & has2
    key = jax.random.PRNGKey(5)
    kw = dict(min_inliers=20, chi2_px=9.21)
    hj = {} if has1 is None else dict(has1=jnp.asarray(has1), has2=jnp.asarray(has2))
    ht = {} if has1 is None else dict(has1=torch.from_numpy(has1), has2=torch.from_numpy(has2))
    rj = jsim3.sim3_ransac(*_j(X1, X2, mask, uv1, uv2, CAM), key, **kw, **hj)
    rt = tsim3.sim3_ransac(*_t(X1, X2, mask, uv1, uv2, CAM), **kw, **ht,
                           samples=torch.from_numpy(_draws(key, both)))
    assert bool(rt.success) == bool(rj.success) is True
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    _close((rt.s, rt.R, rt.t), (rj.s, rj.R, rj.t), POSE)
    assert abs(float(rt.s) - s) < 0.02
    # The generator path draws its own samples and finds the same Sim3.
    rg = tsim3.sim3_ransac(*_t(X1, X2, mask, uv1, uv2, CAM), torch.Generator().manual_seed(0),
                           **kw, **ht)
    np.testing.assert_allclose(float(rg.s), s, atol=0.02)


def test_sim3_gn_refine_with_backward_and_3d_terms():
    rng, X1, X2, uv1, uv2, (s, R, t) = _sim3_scene(outliers=30)
    M = X1.shape[0]
    w_f = rng.uniform(size=M) > 0.1
    w_b = rng.uniform(size=M) > 0.2
    w3 = (rng.uniform(size=M) > 0.5).astype(np.float32) * 40.0
    s0 = np.float32(s * 1.05)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.06, -0.08, 0.0], jnp.float32))) @ np.eye(
        3, dtype=np.float32)
    t0 = np.asarray([0.25, -0.05, 0.3], np.float32)
    for fix_scale in (False, True):
        kw = dict(iters=8, fix_scale=fix_scale, chi2_px=9.21)
        out_j = jsim3.sim3_gn_refine(*_j(X1, uv2, w_f, s0, R0, t0, CAM), **kw,
                                     X_bwd=jnp.asarray(X2), uv_bwd=jnp.asarray(uv1),
                                     w_bwd=jnp.asarray(w_b), X_src3=jnp.asarray(X1),
                                     X_dst3=jnp.asarray(X2), w_3d=jnp.asarray(w3))
        out_t = tsim3.sim3_gn_refine(*_t(X1, uv2, w_f, s0, R0, t0, CAM), **kw,
                                     X_bwd=torch.from_numpy(X2), uv_bwd=torch.from_numpy(uv1),
                                     w_bwd=torch.from_numpy(w_b), X_src3=torch.from_numpy(X1),
                                     X_dst3=torch.from_numpy(X2), w_3d=torch.from_numpy(w3))
        _close(out_t[:3], out_j[:3], POSE)
        assert int(out_t[3]) == int(out_j[3])
        if not fix_scale:
            assert abs(float(out_t[0]) - s) < 0.02
