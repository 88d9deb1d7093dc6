"""Pipeline mode's fused per-frame program (`_track_and_map_body`) against the
JAX package's `_track_and_map_kernel`, one call on a mid-sequence map: with
the keyframe insert firing, with it not firing, and firing with the windowed
BA gated off (ba_every=2, first insert). Tolerances: flags and the policy
carry exact, R and t within 1e-4, the frame's landmark ids equal on >= 99 %
of keypoints, the maps as in the keyframe-insert parity test."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu_torch.map import map_state as tms
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import CAM, POSE, assert_states_match, synthetic_frames, to_jax_state


@pytest.fixture(scope="module")
def scene():
    """A map the port built over 12 frames, frame 12 and its prediction."""
    world, frames, _ = synthetic_frames(14)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 4096), desc_dim=64,
                         device="cpu")
    for f in frames[:12]:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 3
    R0, t0 = slam._predict_pose()
    return slam, frames[12], R0, t0


def _args(slam, f, R0, t0):
    cfg = slam.cfg
    prev = slam.last_frame
    frame = (prev.desc, prev.valid, prev.landmark_idx, *(torch.from_numpy(a) for a in (
        f.kpts, f.rays, f.desc, f.valid)), R0, t0)
    statics = (cfg.cam_kind, cfg.image_hw, cfg.min_matches_motion, cfg.min_inliers_track,
               cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2)
    policy_cfg = (float(cfg.kf_tracked_ratio), float(cfg.kf_min_interval),
                  float(cfg.kf_max_interval))
    window = (cfg.local_window, cfg.fixed_window, cfg.ba_iters)
    return frame, statics, policy_cfg, window


@pytest.mark.parametrize("fs,ba_every,inserts", [(10.0, 1, True), (0.0, 1, False),
                                                 (10.0, 2, True)])
def test_track_and_map(scene, fs, ba_every, inserts):
    slam, f, R0, t0 = scene
    frame, statics, policy_cfg, window = _args(slam, f, R0, t0)
    policy = np.asarray([fs, float(slam.ref_kf_tracked), 0.0], np.float32)
    st = slam.state
    mask = st.lm_active
    before = {k: getattr(st, k).clone() for k in tms.FIELDS}
    out_t = tT._track_and_map_body(st, torch.from_numpy(policy), mask, *frame, f.time,
                                   slam.cam_params, *statics, *policy_cfg, *window,
                                   local_map_only=True, ba_every=ba_every)
    # The program writes nothing in place: pending frames and the caller's
    # previous state still hold these tensors.
    for k, v in before.items():
        assert torch.equal(getattr(st, k), v), k
    out_j = jT._track_and_map_kernel(
        to_jax_state(st), jnp.asarray(policy), jnp.asarray(mask.numpy()),
        *(jnp.asarray(a.numpy()) for a in frame), jnp.asarray(f.time, jnp.float32),
        jnp.asarray(CAM), *statics, *(jnp.asarray(x, jnp.float32) for x in policy_cfg),
        *window, local_map_only=True, ba_every=ba_every)
    st_t, pol_t, mask_t, R_t, t_t, lm_t, flags_t = out_t
    st_j, pol_j, mask_j, R_j, t_j, lm_j, flags_j = out_j
    np.testing.assert_array_equal(flags_t.numpy(), np.asarray(flags_j))
    assert bool(flags_t[5]) is inserts and bool(flags_t[0])
    np.testing.assert_array_equal(pol_t.numpy(), np.asarray(pol_j))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), **POSE)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), **POSE)
    assert (lm_t.numpy() == np.asarray(lm_j)).mean() >= 0.99
    assert int(st_t.n_kf) == int(st_j.n_kf) == int(st.n_kf) + inserts
    assert int(st_t.n_lm) == int(st_j.n_lm)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert_states_match(st_t, st_j)
    if inserts:
        # lm_idx is the new keyframe's row: the insert's triangulations are in it.
        assert torch.equal(lm_t, st_t.kf_landmark_idx[int(st.n_kf)])
        assert int((lm_t >= 0).sum()) > int(flags_t[1])
