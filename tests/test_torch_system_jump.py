"""A timestamp jump in the port against the JAX package: 12 tracked frames,
then the same stream 5 s later. Both must finish the old timeline, discard
the young map (fewer than min_kfs_keep_map keyframes), start map 1 and
initialize and track in it; their ATEs after the jump within 1 cm of each
other and under 5 cm, keyframe counts within 30 %."""
import pytest

from rover_slam_tpu_torch.slam import tracking as tT

from torch_parity import _np, ate, both_systems, feed, synthetic_frames

JUMP = 5.0


@pytest.fixture(scope="module")
def runs():
    world, frames, (R_gt, t_gt, times) = synthetic_frames(24)
    out = {}
    for name, slam in both_systems(world.cam_params, map_capacity=(32, 512, 4096),
                                   desc_dim=64).items():
        before = feed(slam, frames[:12])
        n_kf0 = slam.n_kf
        after = feed(slam, frames[12:], dt=JUMP)
        st = slam.state
        out[name] = dict(
            slam=slam, before=before, after=after, n_kf0=n_kf0,
            map_id=int(st.active_map_id),
            old_kfs=int(_np(st.kf_active & (st.kf_map_id == 0)).sum()),
            new_kfs=int(_np(st.kf_active & (st.kf_map_id == 1)).sum()),
            ate=ate(slam, R_gt, t_gt, times + JUMP, t_min=times[12] + JUMP - 1e-3))
    return out


def test_timestamp_jump_starts_a_new_map(runs):
    for name in ("jax", "torch"):
        r = runs[name]
        assert r["before"][-1] == 2 and 2 <= r["n_kf0"] < 10, name
        assert r["after"][0] == 1, name          # the jump frame starts initialization
        assert r["map_id"] == 1 and r["old_kfs"] == 0, name   # young map discarded
        assert r["after"][-1] == 2 and r["new_kfs"] >= 2, name
    t, j = runs["torch"], runs["jax"]
    assert t["after"] == j["after"]
    assert t["ate"] < 0.05 and abs(t["ate"] - j["ate"]) < 0.01, (t["ate"], j["ate"])
    assert abs(t["new_kfs"] - j["new_kfs"]) <= max(1, 0.3 * j["new_kfs"])
    assert t["slam"].tracking_state == tT.OK
