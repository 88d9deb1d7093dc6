"""The global BA with a mesh (maintenance.global_ba(mesh=), the loop
closer's distributed back end) in the port against the JAX package, on the
ring-orbit map the port builds (torch_parity.ring_orbit_state, tables 64 /
512 / 8192): the landmark-sharded solver on the whole padded table.

Tolerances: the port's and the JAX package's mesh results differ in f32
reduction order only (measured at 3 iterations: rotations within 1.4e-6,
translations within 2.5e-6, active landmarks within 1.1e-5); MESH_POSE and
MESH_POINT hold them at 1e-5 and 1e-4. The port's mesh result is held to
its own single-device result as tests/test_sharded_ba.py::
TestLiveLoopShardedGBA holds the JAX package's: active keyframe
translations within 5e-3 (measured 1.0e-3), the median active landmark
within 5e-3 (measured 2.0e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rover_slam_tpu.map import maintenance as jmnt
from rover_slam_tpu.parallel import sharded_ba as jsh
from rover_slam_tpu_torch.map import maintenance as tmnt
from rover_slam_tpu_torch.parallel import sharded_ba as tsh

from torch_parity import CAM, ring_orbit_state, to_jax_state

MESH_POSE = dict(atol=1e-5, rtol=0)
MESH_POINT = dict(atol=1e-4, rtol=0)
ITERS = 3


@pytest.fixture(scope="module")
def scene():
    st = ring_orbit_state()
    assert int(st.n_kf) >= 4
    return st, to_jax_state(st)


@pytest.fixture(scope="module")
def port_mesh_result(scene):
    st, _ = scene
    return tmnt.global_ba(st, torch.from_numpy(CAM), iters=ITERS,
                          mesh=tsh.make_mesh(8, device="cpu"))


def test_mesh_global_ba_matches_jax(scene, port_mesh_result):
    st, st_j = scene
    out_j = jmnt.global_ba(st_j, jnp.asarray(CAM), iters=ITERS, mesh=jsh.make_mesh(8))
    out_t = port_mesh_result
    act = st.kf_active.numpy()
    for f in ("kf_R_cw", "kf_t_cw"):
        np.testing.assert_allclose(getattr(out_t, f).numpy()[act],
                                   np.asarray(getattr(out_j, f))[act], err_msg=f, **MESH_POSE)
    lm = st.lm_active.numpy()
    np.testing.assert_allclose(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm],
                               **MESH_POINT)
    # The mesh path drops no outlier: the observation table is untouched.
    assert torch.equal(out_t.kf_landmark_idx, st.kf_landmark_idx)
    np.testing.assert_array_equal(np.asarray(out_j.kf_landmark_idx),
                                  st.kf_landmark_idx.numpy())


def test_mesh_global_ba_matches_single_device(scene, port_mesh_result):
    """JAX TestLiveLoopShardedGBA's bounds on the port: the same program up
    to reduction order and the single-device path's outlier strip."""
    st, _ = scene
    out_1 = tmnt.global_ba(st, torch.from_numpy(CAM), iters=ITERS)
    out_8 = port_mesh_result
    act = st.kf_active.numpy()
    dt = np.abs(out_1.kf_t_cw.numpy() - out_8.kf_t_cw.numpy())
    assert dt[act].max() < 5e-3, dt[act].max()
    dl = np.abs(out_1.lm_pos.numpy() - out_8.lm_pos.numpy())
    assert np.median(dl[st.lm_active.numpy()]) < 5e-3


def test_mesh_of_one_takes_the_single_path(scene):
    """A mesh of one shard is the single-device global BA, to the bit
    (level included)."""
    st, _ = scene
    mesh = tsh.make_mesh(1, device="cpu")
    cam = torch.from_numpy(CAM)
    for level in (None, 1):
        a = tmnt.global_ba(st, cam, iters=1, mesh=mesh, level=level)
        b = tmnt.global_ba(st, cam, iters=1, level=level)
        for f in ("kf_R_cw", "kf_t_cw", "lm_pos", "kf_landmark_idx"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (level, f)
