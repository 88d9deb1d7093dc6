"""The loop closer's correction programs of the port against the JAX
package, on the ring-orbit map of tests/test_torch_loop_kernels.py at its
revisit: the essential-graph edge set, the loop correction (pose graph,
landmark transfer, SE3 recovery, the new loop edge) in the sim3, se3 and
4dof modes, and the fusion of duplicated landmarks after it. The Sim3 is the
port's fire-time solve of the revisit pair; both sides get the same one.
Tolerances: edges exact, poses atol 1e-4 (POSE), points atol 1e-3 (POINT),
the cost history (a sum over some 800 edges) rtol 1e-3, fused tables
exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.map import map_state as jms
from rover_slam_tpu.slam import loop_closing as jlc
from rover_slam_tpu_torch.map import keyframe_database as tkdb, map_state as tms
from rover_slam_tpu_torch.slam import loop_closing as tlc

from torch_parity import (CAM, POINT, POSE, _np, from_jax_state, ring_orbit_state,
                          to_jax_state)


@pytest.fixture(scope="module")
def loop():
    st = ring_orbit_state()
    q = int(st.n_kf) - 1
    db = tkdb.db_build_from_state(tkdb.empty_db(64, st.K, seed=3), st.kf_desc,
                                  st.kf_kpt_valid, st.kf_active & (torch.arange(st.K) < q))
    c = int(tlc._detect_and_add_kernel(st, db, q, 4, 10)[1][0])    # the best candidate
    ok, _, s, R, t, n_proj = tlc._sim3_pair_guided(st, q, c, torch.from_numpy(CAM),
                                                   torch.Generator().manual_seed(0), 0, False)
    assert bool(ok) and int(n_proj) >= 40 and q - c > 10
    return st, to_jax_state(st), q, c, (s, R, t)


def test_essential_edges(loop):
    st, st_j, _, _, _ = loop
    out_t = tlc._essential_edges(st, tms.covisibility(st), 20)
    out_j = jlc._essential_edges(st_j, jms.covisibility(st_j), 20)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert int(out_t[2].sum()) > 2 * int(st.n_kf)


def test_correct_loop_then_fuse(loop):
    """The monocular (sim3) correction; the se3 graph's scale lock is held
    in tests/test_torch_loop_graph.py."""
    st, st_j, q, c, sim3 = loop
    sj = tuple(jnp.asarray(x.numpy()) for x in sim3)
    out_j, costs_j = jlc._correct_loop_kernel(st_j, jnp.asarray(q, jnp.int32),
                                              jnp.asarray(c, jnp.int32), *sj,
                                              jnp.asarray(20, jnp.int32), 3)
    out_t, costs_t = tlc._correct_loop_kernel(st, q, c, *sim3, 20, 3)
    act = np.asarray(st_j.kf_active)
    np.testing.assert_allclose(out_t.kf_R_cw.numpy()[act], np.asarray(out_j.kf_R_cw)[act], **POSE)
    np.testing.assert_allclose(out_t.kf_t_cw.numpy()[act], np.asarray(out_j.kf_t_cw)[act], **POSE)
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm], **POINT)
    np.testing.assert_array_equal(out_t.kf_loop_edges.numpy(), np.asarray(out_j.kf_loop_edges))
    assert bool(out_t.kf_loop_edges[q, c]) and bool(out_t.kf_loop_edges[c, q])
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), rtol=1e-3)
    assert float(costs_t[-1]) < float(costs_t[0])
    # Fusion on the corrected map (the JAX package's, so both start equal).
    corrected = from_jax_state(out_j)
    fused_j, n_j = jlc._fuse_after_loop_kernel(out_j, jnp.asarray(q, jnp.int32),
                                               jnp.asarray(c, jnp.int32), jnp.asarray(CAM), 0)
    fused_t, n_t = tlc._fuse_after_loop_kernel(corrected, q, c, torch.from_numpy(CAM), 0)
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_array_equal(fused_t.kf_landmark_idx.numpy(),
                                  np.asarray(fused_j.kf_landmark_idx))
    np.testing.assert_array_equal(fused_t.lm_active.numpy(), np.asarray(fused_j.lm_active))


def test_four_dof_mode_raises(loop):
    """mode="4dof", the inertial maps' correction (yaw + translation; until
    the inertial slice it raised NotImplementedError, hence the name): the
    same poses, points, loop edge and cost history as the JAX package's."""
    st, st_j, q, c, sim3 = loop
    sj = tuple(jnp.asarray(x.numpy()) for x in sim3)
    out_j, costs_j = jlc._correct_loop_kernel(st_j, jnp.asarray(q, jnp.int32),
                                              jnp.asarray(c, jnp.int32), *sj,
                                              jnp.asarray(20, jnp.int32), 2, mode="4dof")
    out_t, costs_t = tlc._correct_loop_kernel(st, q, c, *sim3, 20, 2, mode="4dof")
    act = np.asarray(st_j.kf_active)
    np.testing.assert_allclose(out_t.kf_R_cw.numpy()[act], np.asarray(out_j.kf_R_cw)[act], **POSE)
    np.testing.assert_allclose(out_t.kf_t_cw.numpy()[act], np.asarray(out_j.kf_t_cw)[act], **POSE)
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm], **POINT)
    np.testing.assert_array_equal(out_t.kf_loop_edges.numpy(), np.asarray(out_j.kf_loop_edges))
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), rtol=1e-3)
