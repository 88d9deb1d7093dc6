"""The merge's essential-graph propagation of the port against the JAX
package, on the warped two-session scene of tests/test_torch_loop_merge.py:
the port welds, fuses and runs the welding BA (whose parity that file
holds), then both packages propagate the seam correction from the same
state, measured from the poses before the welding BA, with the former
active map, both weld windows and keyframe 0 fixed. Tolerances: map ids and
observation tables exact, poses atol 1e-4 (POSE), points atol 1e-3 (POINT),
the cost history rtol 1e-3."""
import numpy as np
import jax.numpy as jnp
import torch

from rover_slam_tpu.slam import loop_closing as jlc
from rover_slam_tpu_torch.slam import loop_closing as tlc

from torch_parity import CAM, POINT, POSE, merge_scene, to_jax_state

WINDOW = 12        # the drift test's weld window


def test_merge_propagate():
    st, q, c, sim3, in_old = merge_scene()
    cam = torch.from_numpy(CAM)
    st = tlc._merge_maps_kernel(st, q, c, *sim3)
    st, _ = tlc._fuse_after_loop_kernel(st, q, c, cam, 0, prefer_query=True)
    P0_R, P0_t = st.kf_R_cw, st.kf_t_cw
    st = tlc._welding_ba_kernel(st, q, c, cam, 0, 2, WINDOW, in_old)
    out_j, costs_j = jlc._merge_propagate_kernel(
        to_jax_state(st), jnp.asarray(q, jnp.int32), jnp.asarray(c, jnp.int32),
        jnp.asarray(P0_R.numpy()), jnp.asarray(P0_t.numpy()), jnp.asarray(in_old.numpy()),
        jnp.asarray(20, jnp.int32), 4, WINDOW)
    out_t, costs_t = tlc._merge_propagate_kernel(st, q, c, P0_R, P0_t, in_old, 20, 4, WINDOW)
    act = np.asarray(out_j.kf_active)
    np.testing.assert_allclose(out_t.kf_R_cw.numpy()[act], np.asarray(out_j.kf_R_cw)[act], **POSE)
    np.testing.assert_allclose(out_t.kf_t_cw.numpy()[act], np.asarray(out_j.kf_t_cw)[act], **POSE)
    lm = np.asarray(out_j.lm_active)
    np.testing.assert_allclose(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm], **POINT)
    np.testing.assert_array_equal(out_t.kf_landmark_idx.numpy(), np.asarray(out_j.kf_landmark_idx))
    np.testing.assert_allclose(costs_t.numpy(), np.asarray(costs_j), rtol=1e-3)
    # The fixed side did not move; the absorbed interior did.
    fixed = (~in_old).numpy() & act
    np.testing.assert_array_equal(out_t.kf_t_cw.numpy()[fixed], st.kf_t_cw.numpy()[fixed])
    assert np.abs(out_t.kf_t_cw.numpy() - st.kf_t_cw.numpy())[act].max() > 0
