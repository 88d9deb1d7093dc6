"""The port's MonocularSLAM with loop closing on, alone, on the loop scene of
tests/test_loop_closing_e2e.py cut to fit the CPU: the ring world, 70 frames
over the same 1.25 revolutions (the JAX test takes 100), 512 keypoints,
tables 128 / 512 / 8192 (the JAX test's landmark table is 16384),
LoopConfig(min_covis_weight=20), local_map_only, synchronous. The JAX test's
gates: a loop fires back to an early keyframe at a plausible scale, ATE
under 5 cm, and frames logged before the loop come out corrected."""
import numpy as np
import pytest

from rover_slam_tpu_torch.slam import tracking as T
from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.utils import trajectory

from torch_parity import ate, feed, ring_orbit_frames


@pytest.fixture(scope="module")
def loop_run():
    world, frames, gt = ring_orbit_frames()
    slam = MonocularSLAM(world.cam_params, map_capacity=(128, 512, 8192), desc_dim=64,
                         enable_loop_closing=True, config=T.TrackerConfig(local_map_only=True),
                         loop_config=LoopConfig(min_covis_weight=20), device="cpu")
    feed(slam, frames)
    slam.flush()
    return slam, gt


def test_loop_fires(loop_run):
    slam, _ = loop_run
    assert slam.tracking_state == T.OK and slam.n_kf > 10
    assert len(slam.loop_events) >= 1, "no loop closure fired"
    kf, info = slam.loop_events[0]
    assert info["loop"] and not info.get("merge")
    assert info["candidate"] < kf - 10
    assert 0.5 < info["scale"] < 2.0
    assert info["n_inliers"] >= LoopConfig().min_sim3_proj and info["n_fused"] > 0
    lc = slam.loop_closer
    # bench.py's loop_diag reads these logs.
    assert lc.score_log and lc.cand_log and lc.loops_closed == [(kf, info["candidate"])]
    assert lc._gba_pending == 0                # flush ran the deferred GBA chunks
    assert bool(slam.state.kf_loop_edges[kf, info["candidate"]])


def test_ate_after_loop(loop_run):
    slam, gt = loop_run
    assert ate(slam, *gt) < 0.05


def test_loop_corrects_logged_history(loop_run):
    """Frames logged before the loop fired are composed from their
    reference keyframe's corrected pose (tests/test_loop_closing_e2e.py)."""
    slam, (R_gt, t_gt, times) = loop_run
    loop_kf, _ = slam.loop_events[0]
    t_loop = float(slam.state.kf_time[min(loop_kf, slam.n_kf - 1)])
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])

    def ate_before(recon):
        est_t, est_R, est_tcw = slam.get_trajectory(reconstitute=recon)
        keep = np.nonzero(est_t <= t_loop)[0]
        est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in keep])
        pairs = trajectory.associate_by_time(est_t[keep], times)
        e = np.stack([est_pos[i] for i, _ in pairs])
        g = np.stack([gt_pos[j] for _, j in pairs])
        return trajectory.ate_rmse(e, g, with_scale=True)[0]

    rmse_recon, rmse_abs = ate_before(True), ate_before(False)
    assert rmse_recon <= rmse_abs * 1.02
    assert rmse_recon < rmse_abs * 0.9 or rmse_recon < 0.05
