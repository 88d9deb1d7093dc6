"""pipeline=True (fused track+map, flags read four frames late) in the port
against the JAX package on tests/test_e2e_mono.py's pipeline scene: both
end OK, their ATEs within 1 cm of each other and under that test's 5 cm,
keyframe counts within 30 %. The scene makes about five keyframes, so both
systems leave synchronous warm-up after three (the default waits for eight)
and most frames go through the fused program."""
import pytest

from rover_slam_tpu_torch.slam import tracking as tT

from torch_parity import ate, both_systems, feed, synthetic_frames

WARMUP_KFS = 3


@pytest.fixture(scope="module")
def runs():
    world, frames, gt = synthetic_frames(30, seed=3)
    systems = both_systems(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                           pipeline=True)
    out = {}
    for name, slam in systems.items():
        slam.pipeline_warmup_kfs = WARMUP_KFS
        states = feed(slam, frames)
        slam.flush()
        out[name] = (slam, states, ate(slam, *gt))
    return out


def test_pipeline_tracks_like_the_reference(runs):
    (slam_j, _, ate_j), (slam_t, _, ate_t) = runs["jax"], runs["torch"]
    assert slam_t.tracking_state == slam_j.tracking_state == tT.OK
    assert ate_t < 0.05 and abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)
    assert abs(slam_t.n_kf - slam_j.n_kf) <= 0.3 * slam_j.n_kf, (slam_t.n_kf, slam_j.n_kf)
    assert len(slam_t.trajectory) == len(slam_j.trajectory)


def test_pipeline_runs_fused_and_late(runs):
    """Frames past warm-up return queued for four frames, then each returns
    the frame four back; the device inserted keyframes the host counted."""
    slam_t, states, _ = runs["torch"]
    assert slam_t.pipeline_depth == 4 and not slam_t._pending
    assert slam_t.n_kf > WARMUP_KFS
    assert int(slam_t.state.n_kf) == slam_t.n_kf == int((slam_t._uid_of_slot >= 0).sum())
    assert states[-1] == tT.OK
