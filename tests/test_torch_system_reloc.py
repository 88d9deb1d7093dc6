"""The kidnapped-robot scene of tests/test_e2e_mono.py through the port and
the JAX package: 20 tracked frames, 4 unmatchable ones, then frame 10's
view again. Both must go RECENTLY_LOST and come back OK through the global
relocalization (mutual NN against the landmark table, PnP RANSAC, guided
passes), at frame 10's logged position within that test's 5 cm; their ATEs
over the tracked stretch within 1 cm of each other, keyframe counts within
30 %."""
import numpy as np
import pytest

from rover_slam_tpu_torch.slam import tracking as tT

from torch_parity import ate, both_systems, feed, garbage_frames, synthetic_frames


def _centre(R, t):
    return -np.asarray(R).T @ np.asarray(t)


@pytest.fixture(scope="module")
def runs():
    world, frames, gt = synthetic_frames(30)
    out = {}
    for name, slam in both_systems(world.cam_params, map_capacity=(64, 512, 8192),
                                   desc_dim=64).items():
        feed(slam, frames[:20])
        tracked = slam.tracking_state
        lost = feed(slam, garbage_frames(4, 2.0, seed=99))
        f = frames[10]
        info = slam.track_frame(f.kpts, f.rays, f.desc, f.valid, 3.0)
        pos10 = _centre(*next(e for e in slam.trajectory if abs(e[0] - f.time) < 1e-6)[1:3])
        out[name] = dict(slam=slam, tracked=tracked, lost=lost, info=info, pos10=pos10,
                         ate=ate(slam, *gt, t_max=2.0))
    return out


def test_kidnap_relocalizes_like_the_reference(runs):
    for name in ("jax", "torch"):
        r = runs[name]
        assert r["tracked"] == 2, name                         # OK before the kidnap
        assert r["lost"][-1] == 3, name                        # RECENTLY_LOST
        assert r["info"]["state"] == 2, (name, "relocalization failed")
        pos = _centre(*r["info"]["pose"])
        assert np.linalg.norm(pos - r["pos10"]) < 0.05, name
    t, j = runs["torch"], runs["jax"]
    assert abs(t["ate"] - j["ate"]) < 0.01 and t["ate"] < 0.03, (t["ate"], j["ate"])
    n_t, n_j = t["slam"].n_kf, j["slam"].n_kf
    assert abs(n_t - n_j) <= 0.3 * n_j, (n_t, n_j)
    assert t["slam"].tracking_state == tT.OK and t["slam"]._lost_frames == 0
