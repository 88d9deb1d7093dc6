"""LOST and the Atlas in the port against the JAX package, on the scene of
tests/test_e2e_mono.py's test_lost_spawns_new_atlas_map, shortened: a map
grown past min_kfs_keep_map (a keyframe every other frame), unmatchable
frames past the 2 s RECENTLY_LOST window, then a new world. Both systems
must keep the mature map under id 0, start map 1, and initialize and track
in it; their ATEs over the new map's frames within 1 cm of each other and
under 5 cm, keyframe counts within 30 %."""
import pytest

from rover_slam_tpu_torch.slam import tracking as tT

from torch_parity import _np, ate, both_systems, feed, garbage_frames, synthetic_frames

CFG = dict(kf_min_interval=0, kf_tracked_ratio=1.0, kf_max_interval=2)


@pytest.fixture(scope="module")
def runs():
    world, frames, _ = synthetic_frames(24, seed=5)
    _, frames2, gt2 = synthetic_frames(10, seed=6)
    out = {}
    for name, slam in both_systems(world.cam_params, map_capacity=(96, 512, 16384),
                                   desc_dim=64, config=CFG).items():
        feed(slam, frames)
        r = dict(slam=slam, state0=slam.tracking_state, n_kf0=slam.n_kf)
        # Unmatchable frames 0.25 s apart: past the grace window in 9 frames.
        r["lost"] = feed(slam, garbage_frames(12, frames[-1].time + 0.25, seed=0, dt=0.25))
        r["map_id"] = int(slam.state.active_map_id)
        r["kept"] = int(_np(slam.state.kf_active & (slam.state.kf_map_id == 0)).sum())
        r["new"] = feed(slam, frames2, dt=100.0)
        r["new_kfs"] = int(_np(slam.state.kf_active & (slam.state.kf_map_id == 1)).sum())
        r["ate"] = ate(slam, gt2[0], gt2[1], gt2[2] + 100.0, t_min=99.0)
        out[name] = r
    return out


def test_lost_keeps_mature_map_and_starts_a_new_one(runs):
    for name in ("jax", "torch"):
        r = runs[name]
        assert r["state0"] == 2 and r["n_kf0"] >= 10, (name, r["n_kf0"])
        assert 0 in r["lost"] and r["map_id"] == 1, name    # NO_IMAGES_YET, map 1
        assert r["kept"] >= r["n_kf0"], name
        assert r["new"][-1] == 2 and r["new_kfs"] >= 2, name
    t, j = runs["torch"], runs["jax"]
    # (How many garbage frames pass as weak-band fits before the loss is
    # chaotic in both; the outcome is not.)
    assert abs(t["kept"] - j["kept"]) <= 0.3 * j["kept"], (t["kept"], j["kept"])
    assert t["ate"] < 0.05 and abs(t["ate"] - j["ate"]) < 0.01, (t["ate"], j["ate"])
    assert abs(t["n_kf0"] - j["n_kf0"]) <= 0.3 * j["n_kf0"]
    assert abs(t["new_kfs"] - j["new_kfs"]) <= max(1, 0.3 * j["new_kfs"])
    assert t["slam"].tracking_state == tT.OK
