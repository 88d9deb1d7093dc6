"""The monocular-inertial system with bf=None, the other side of the stereo
wiring of slam/inertial_system.py: the port's MonocularInertialSLAM on
tests/test_stereo_inertial.py's scene without its right eye, through the IMU
init (frame 10, with its full-window VI-BA) and MONO_FRAMES frames: bf stays
None, and no problem of its VI refinements or VI-BAs carries a stereo
field, so its solves are the monocular ones (the port's mono-inertial parity
tests and chip_smoke.py's path G digest hold those to the bit)."""
from rover_slam_tpu_torch.imu import preintegration as tpre
from rover_slam_tpu_torch.optim import pose_inertial as tpio, vi_ba as tvib
from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM

from test_torch_stereo_inertial import _Spy, si_scene
from torch_parity import IMU_CALIB

MONO_FRAMES = 14


def test_mono_inertial_keeps_mono_problems(monkeypatch):
    """bf=None: the monocular-inertial system builds every VI problem with
    no stereo field, as before the stereo inputs were wired in."""
    world, frames, _, imu = si_scene(MONO_FRAMES)
    poses = _Spy(monkeypatch, tpio, "PoseInertialProblem", ("invd", "bf"))
    vibas = _Spy(monkeypatch, tvib, "VIBAProblem", ("e_invd", "bf"))
    calib = tpre.ImuCalib(**IMU_CALIB)
    slam = MonocularInertialSLAM(world.cam_params, calib, tinit_s=1.0,
                                 map_capacity=(64, 512, 16384), desc_dim=64, device="cpu")
    for i, f in enumerate(frames):
        if i > 0:
            for a, g, t in zip(*imu[i - 1]):
                slam.feed_imu(a, g, t)
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.bf is None and slam._bf_arr() is None and slam.imu_ready
    assert slam.vi_refines > 0 and slam.vi_ba_runs > 0
    assert len(poses.seen) >= slam.vi_refines and len(vibas.seen) == slam.vi_ba_runs
    assert all(x is None for seen in (poses.seen, vibas.seen) for pair in seen for x in pair)
