"""Fisheye on a ported system: tests/test_fisheye_inertial.py's scene (the
TUM-VI KannalaBrandt8 intrinsics and IMU noise, a 1600-landmark ring world,
orbit_with_imu at dt 0.1, 512 keypoints, tinit_s 1.5) through both
MonocularInertialSLAMs, the port's two-view init on the JAX package's draws.
Cut from 50 to N_FRAMES frames so the file runs under 90 s alone (the JAX
system's compile takes most of it); the IMU initializes at frame 15.
Held: equal tracking states on every frame, the IMU initialized at the same
frame, both metric ATEs (Horn without scale, frames after the init) under
the JAX test's 0.5 m and within 1 cm of each other, camera centres within
3 cm (the synchronous scene's bound, tests/test_torch_inertial_system.py)."""
import numpy as np
import jax.numpy as jnp
import pytest

from rover_slam_tpu.geometry import cameras as jcam
from rover_slam_tpu.imu import preintegration as jpre
from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu.slam.inertial_system import MonocularInertialSLAM as JaxVI
from rover_slam_tpu_torch.geometry import cameras as tcam
from rover_slam_tpu_torch.imu import preintegration as tpre
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM as TorchVI
from rover_slam_tpu_torch.utils import synthetic, trajectory

from torch_parity import InitDraws

N_FRAMES = 30
KB8 = np.asarray(jcam.make_kb8(190.978, 190.973, 254.932, 256.897, 0.00348238, 0.000715034,
                               -0.00205323, 0.000202936))
NOISE = dict(sigma_g=0.00016 * np.sqrt(200.0), sigma_a=0.0028 * np.sqrt(200.0),
             walk_g=0.000022 / np.sqrt(200.0), walk_a=0.00086 / np.sqrt(200.0))


@pytest.fixture(scope="module")
def runs():
    base = synthetic.ring_world(n_landmarks=1600, desc_dim=64, seed=2)
    world = synthetic.SyntheticWorld(landmarks=base.landmarks, desc=base.desc, cam_params=KB8,
                                     cam_kind=tcam.KANNALA_BRANDT8, image_hw=(512, 512))
    R_gt, t_gt, times, _, imu = synthetic.orbit_with_imu(n_frames=N_FRAMES,
                                                         revs=0.5 * N_FRAMES / 50, dt=0.1)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512, pix_noise=0.5,
                                       desc_noise=0.05)
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(N_FRAMES)])
    calib_j = jpre.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3),
                            **{k: jnp.float32(v) for k, v in NOISE.items()})
    calib_t = tpre.ImuCalib(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                            *(np.float32(NOISE[k]) for k in ("sigma_g", "sigma_a", "walk_g",
                                                             "walk_a")))
    draws = InitDraws()
    out = {}
    for name, cls, T, calib, side, kw in (
            ("jax", JaxVI, jT, calib_j, draws.jax_side, {}),
            ("torch", TorchVI, tT, calib_t, draws.torch_side, dict(device="cpu"))):
        with side():
            slam = cls(KB8, calib, tinit_s=1.5,
                       config=T.TrackerConfig(cam_kind=tcam.KANNALA_BRANDT8, image_hw=(512, 512)),
                       map_capacity=(96, 512, 16384), desc_dim=64, **kw)
            states, ready = [], None
            for i, f in enumerate(frames):
                if i > 0:
                    for a, g, t in zip(*imu[i - 1]):
                        slam.feed_imu(a, g, t)
                states.append(slam.track_frame(f.kpts, f.rays, f.desc, f.valid,
                                               f.time)["state"])
                if slam.imu_ready and ready is None:
                    ready = i
        est_t, est_R, est_tcw = slam.get_trajectory()
        pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
        pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times)
                 if ready is not None and j > ready]
        e = np.stack([pos[i] for i, _ in pairs])
        g = np.stack([gt_pos[j] for _, j in pairs])
        out[name] = dict(states=states, ready=ready, pos=pos, final=slam.tracking_state,
                         ate=trajectory.ate_rmse(e, g, with_scale=False)[0])
    return out


def test_fisheye_inertial_parity(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["states"] == j["states"]
    assert t["final"] == j["final"] == tT.OK
    assert t["ready"] == j["ready"] is not None
    assert j["ate"] < 0.5 and t["ate"] < 0.5
    assert abs(t["ate"] - j["ate"]) < 0.01
    np.testing.assert_allclose(t["pos"], j["pos"], atol=0.03)
