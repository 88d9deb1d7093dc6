"""The port's utilities against the JAX package: synthetic worlds and
frames (same numpy seeds -> same data), checkpoint reading, ATE helpers and
stage timers."""
import os

import numpy as np
import pytest

from rover_slam_tpu.training import checkpoints as jckpt
from rover_slam_tpu.utils import synthetic as jsyn, trajectory as jtraj
from rover_slam_tpu.utils.timing import StageTimers as JaxTimers
from rover_slam_tpu_torch.training import checkpoints as tckpt
from rover_slam_tpu_torch.utils import synthetic as tsyn, trajectory as ttraj
from rover_slam_tpu_torch.utils.timing import StageTimers

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rover_slam_tpu", "assets")
TOL = dict(rtol=1e-5, atol=1e-5)


def test_worlds_identical():
    wj, wt = jsyn.make_world(500, desc_dim=64, seed=3), tsyn.make_world(500, desc_dim=64, seed=3)
    np.testing.assert_array_equal(wt.landmarks, wj.landmarks)
    np.testing.assert_array_equal(wt.desc, wj.desc)
    np.testing.assert_array_equal(wt.cam_params, np.asarray(wj.cam_params))
    pj = jsyn.make_photo_world(200, patch=11, seed=1, layout="ring", ring_orbit_radius=5.0)
    pt = tsyn.make_photo_world(200, patch=11, seed=1, layout="ring", ring_orbit_radius=5.0)
    for a, b in zip(pt, pj):
        if a is not None and not isinstance(a, (int, tuple)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,kw", [("forward_trajectory", dict(n_frames=30, speed=0.6)),
                                     ("orbit_trajectory", dict(n_frames=40, revs=1.1))])
def test_trajectories(name, kw):
    for a, b in zip(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw)):
        np.testing.assert_allclose(a, b, **TOL)


def test_oracle_frames():
    world = jsyn.make_world(2000, desc_dim=64, seed=0)
    R, t, times = jsyn.forward_trajectory(n_frames=4, speed=0.6)
    fj = jsyn.render_sequence(world, R, t, times, n_kpts=256)
    ft = tsyn.render_sequence(tsyn.make_world(2000, desc_dim=64, seed=0), R, t, times,
                              n_kpts=256)
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.lm_id, b.lm_id)
        np.testing.assert_allclose(a.kpts, b.kpts, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(a.rays, b.rays, **TOL)
        np.testing.assert_array_equal(a.desc, b.desc)


def test_photo_frames():
    world = jsyn.make_photo_world(400, patch=11, seed=2, image_hw=(120, 160))
    R, t, _ = jsyn.orbit_trajectory(n_frames=3)
    for i in range(3):
        np.testing.assert_array_equal(tsyn.render_photo_frame(world, R[i], t[i]),
                                      jsyn.render_photo_frame(world, R[i], t[i]))


def test_checkpoint_reader():
    path = os.path.join(ASSETS, "superpoint_synth.npz")
    tj, tt = jckpt.load_params(path), tckpt.load_params(path)
    assert tt.keys() == tj.keys()
    np.testing.assert_array_equal(tt["convPb"]["kernel"], np.asarray(tj["convPb"]["kernel"]))
    assert tt["conv1a"]["conv"]["bias"].dtype == np.float32


def test_ate_helpers_and_timers():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    est = 0.5 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0 \
        + rng.normal(0, 0.01, (50, 3))
    for a, b in zip(ttraj.horn_align(est, gt), jtraj.horn_align(est, gt)):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert ttraj.ate_rmse(est, gt)[0] == pytest.approx(jtraj.ate_rmse(est, gt)[0])
    t_est = np.arange(20) * 0.1 + 0.003
    t_gt = np.arange(25) * 0.1
    assert ttraj.associate_by_time(t_est, t_gt) == jtraj.associate_by_time(t_est, t_gt)
    timers, jtimers = StageTimers(), JaxTimers()
    for tm in (timers, jtimers):
        tm.add("lm_track", 2.0)
        tm.add("lm_track", 4.0)
        with tm.stage("new_kf"):
            pass
    assert timers.summary()["lm_track"] == jtimers.summary()["lm_track"]
    assert timers.summary()["new_kf"]["count"] == 1
