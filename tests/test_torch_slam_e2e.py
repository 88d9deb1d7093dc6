"""The port's slice as a whole against the JAX package: one synthetic
sequence (made with the JAX package's synthetic module) through both
MonocularSLAMs on the default configuration (mutual-NN matching, pipeline 0,
loop closing off), scored with the same scale-aligned ATE."""
import numpy as np
import pytest

from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu.slam.system import MonocularSLAM as JaxSLAM
from rover_slam_tpu.utils import synthetic, trajectory
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.system import MonocularSLAM as TorchSLAM

N_FRAMES = 20
CAPACITY = (32, 512, 4096)


def _ate(slam, R_gt, t_gt, times):
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    pairs = trajectory.associate_by_time(est_t, times)
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return trajectory.ate_rmse(e, g, with_scale=True)[0]


@pytest.fixture(scope="module")
def runs():
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=0)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=N_FRAMES, dt=0.1, speed=0.6,
                                                     yaw_rate=0.04)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512,
                                       pix_noise=0.4, desc_noise=0.05)
    out = {}
    for name, cls, kw in (("jax", JaxSLAM, {}), ("torch", TorchSLAM, {"device": "cpu"})):
        slam = cls(world.cam_params, map_capacity=CAPACITY, desc_dim=64, **kw)
        states = [slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)["state"]
                  for f in frames]
        out[name] = (slam, states, _ate(slam, R_gt, t_gt, times))
    return out


def test_both_track_after_init(runs):
    for name, T in (("jax", jT), ("torch", tT)):
        slam, states, _ = runs[name]
        assert T.OK in states, name
        first_ok = states.index(T.OK)
        assert all(s == T.OK for s in states[first_ok:]), name


def test_ate_matches_reference(runs):
    ate_t, ate_j = runs["torch"][2], runs["jax"][2]
    assert ate_t < 0.03, ate_t
    assert abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)


def test_keyframes_and_map_size_match(runs):
    slam_t, slam_j = runs["torch"][0], runs["jax"][0]
    n_t, n_j = slam_t.n_kf, slam_j.n_kf
    assert abs(n_t - n_j) <= 0.3 * n_j, (n_t, n_j)
    assert int(slam_t.state.n_lm) > 100
    assert "lm_track" in slam_t.timers.summary() and "new_kf" in slam_t.timers.summary()
