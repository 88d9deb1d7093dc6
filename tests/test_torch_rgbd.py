"""RGB-D of the port against the JAX package: tests/test_map_extras.py's
TestRGBD scene (20 frames, 512 keypoints, 64-D, the true depth at the
keypoints plus 1 cm of seeded noise) through both packages' RGBDSLAMs, held
as tests/test_torch_stereo.py holds its stereo scene (_assert_systems_agree:
equal tracking states, the maps whole through SNAP["rgbd"] frames, keyframe
counts within one after, the metric path length within 8 % of the truth on
both). A file of its own so that each stays under a minute alone."""
import numpy as np

from rover_slam_tpu.slam import stereo as jst
from rover_slam_tpu.utils import synthetic
from rover_slam_tpu_torch.slam import stereo as tst

from test_torch_stereo import (SNAP, _assert_systems_agree, _path_error, _snapshot,
                               _systems, _true_depth)


def test_rgbd_metric_tracking():
    """TestRGBD's scene: the true depth at the keypoints plus 1 cm of noise."""
    world = synthetic.make_world(n_landmarks=4000, desc_dim=64, seed=4)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=20, dt=0.1, speed=0.5)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512, pix_noise=0.4,
                                       desc_noise=0.05)
    runs = {}
    for name, slam in _systems(jst.RGBDSLAM, tst.RGBDSLAM, world.cam_params,
                               depth_factor=1.0).items():
        states, snap = [], None
        for i, f in enumerate(frames):
            depth = _true_depth(world, f).astype(np.float32)
            depth += np.random.default_rng(1).normal(0, 0.01, depth.shape)
            states.append(int(slam.track_rgbd_frame(f.kpts, f.rays, f.desc, f.valid, depth,
                                                    f.time)["state"]))
            if i == SNAP["rgbd"]:
                snap = _snapshot(slam.state)
        runs[name] = dict(slam=slam, states=states, snap=snap,
                          err=_path_error(slam, (R_gt, t_gt, times)))
    _assert_systems_agree(runs)
