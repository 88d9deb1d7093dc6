"""The essential-graph optimizer and landmark correction of the port against
the JAX package on one random Sim3 graph (chain, skip and one loop edge,
noisy measurements, an invalid edge, two fixed vertices). Tolerances: poses
atol 1e-4 (POSE), points atol 1e-3 (POINT), the cost history rtol 1e-4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import lie as jlie
from rover_slam_tpu.optim import pose_graph as jpg
from rover_slam_tpu_torch.optim import pose_graph as tpg

from torch_parity import POINT, POSE, _np


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def _close(t_out, j_out, tol):
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# Pose graph
# --------------------------------------------------------------------------

def _graph(K=12, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(K, 7)).astype(np.float32) * 0.3
    xi[:, 6] *= 0.2
    s, R, t = (np.asarray(a) for a in jax.vmap(jlie.sim3_exp)(jnp.asarray(xi)))
    ei = np.concatenate([np.arange(K - 1), np.arange(K - 2), [K - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, K), np.arange(2, K), [0]]).astype(np.int32)
    meas = jax.vmap(jpg.relative_sim3)(*_j(s[ei], R[ei], t[ei], s[ej], R[ej], t[ej]))
    noise = jax.vmap(jlie.sim3_exp)(jnp.asarray(
        rng.normal(size=(len(ei), 7)).astype(np.float32) * 0.02))
    sm, Rm, tm = (np.asarray(a) for a in jax.vmap(jlie.sim3_compose)(*noise, *meas))
    valid = np.ones(len(ei), bool)
    valid[3] = False
    opt = np.ones(K, bool)
    opt[[0, 5]] = False
    return dict(s=s, R=R, t=t, opt_mask=opt, e_i=ei, e_j=ej, e_s=sm, e_R=Rm, e_t=tm,
                e_valid=valid, e_weight=rng.uniform(0.5, 10, len(ei)).astype(np.float32))


@pytest.mark.parametrize("fix_scale", [False, True], ids=["sim3", "se3"])
def test_optimize_essential_graph(fix_scale):
    g = _graph()
    pj = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in g.items()})
    pt = tpg.PoseGraphProblem(**{k: torch.from_numpy(v) for k, v in g.items()})
    out_j = jpg.optimize_essential_graph(pj, iters=5, fix_scale=fix_scale)
    out_t = tpg.optimize_essential_graph(pt, iters=5, fix_scale=fix_scale)
    _close(out_t[:3], out_j[:3], POSE)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]), rtol=1e-4, atol=1e-7)
    assert float(out_t[3][-1]) < float(out_t[3][0])


def test_optimize_pose_graph_4dof():
    """The inertial maps' 4-DoF graph (yaw + translation; the scales and the
    measurements' scales ignored) on the same random graph: poses POSE, the
    cost history rtol 1e-4."""
    g = _graph(seed=3)
    pj = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in g.items()})
    pt = tpg.PoseGraphProblem(**{k: torch.from_numpy(v) for k, v in g.items()})
    out_j = jpg.optimize_pose_graph_4dof(pj, iters=5)
    out_t = tpg.optimize_pose_graph_4dof(pt, iters=5)
    _close(out_t[:2], out_j[:2], POSE)
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), rtol=1e-4, atol=1e-7)
    assert float(out_t[2][-1]) < float(out_t[2][0])
    # As in the JAX package the yaw left-multiplies R_cw, a turn about each
    # camera's own z axis: row 2 of R_cw (that axis in world coordinates)
    # stays (ROADMAP.md, section C).
    np.testing.assert_allclose(out_t[0].numpy()[:, 2, :], g["R"][:, 2, :], atol=1e-5)


def test_correct_landmarks_and_sim3_to_se3():
    g = _graph(K=12, seed=1)
    rng = np.random.default_rng(2)
    L = 200
    lm = rng.normal(size=(L, 3)).astype(np.float32) * 5
    ref = rng.integers(0, 12, L).astype(np.int32)
    mask = rng.uniform(size=L) > 0.2
    xi = rng.normal(size=(12, 7)).astype(np.float32) * 0.05
    s_new, R_new, t_new = (np.asarray(a) for a in jax.vmap(jlie.sim3_exp)(jnp.asarray(xi)))
    args = (lm, ref, np.ones(12, np.float32), g["R"], g["t"], s_new, R_new, t_new, mask)
    _close((tpg.correct_landmarks(*_t(*args)),), (jpg.correct_landmarks(*_j(*args)),), POINT)
    _close(tpg.sim3_to_se3(*_t(s_new, R_new, t_new)),
           jpg.sim3_to_se3(*_j(s_new, R_new, t_new)), POSE)
