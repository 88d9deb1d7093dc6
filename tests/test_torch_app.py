"""The port's EuRoC app (rover_slam_tpu_torch.apps.run_euroc --device cpu)
against the JAX package's (rover_slam_tpu.apps.run_euroc) on one small tree
from write_euroc_sequence: path G's ring photo world at 240x320 with 512
keypoints, orbit_with_imu at 20 Hz (50 frames, so tinit_s = 2 s puts the IMU
init at frame 40) with its IMU at 200 Hz, both apps monocular-inertial with
the shipped synth weights as official-layout checkpoints, the port's
two-view init on the JAX package's RANSAC draws.

The scene amplifies rounding. The port's torch thread count follows the
host (tests/torch_parity.py: cpu_count // xdist workers), and at 1 and 8
threads SuperPoint already keeps a different keypoint on frame 0 (a top-k
near-tie) and LightGlue pairs 6 of 284 matches differently on frame 1 (C1 in
ROADMAP.md). Both packages then track every frame and agree on the keyframe
count through the IMU init at frame 40, but the inertial-only scale rests on
some 10 frames of alignment and parts: on world seed 0 it was 6.209 (JAX),
5.642 (port, 1 and 2 threads) and 5.503 (port, 8 threads). Measured app
ATEs (world seeds 0 / 1 / 2, same tree otherwise):
  JAX package: 28.25 / 48.38 / 22.74 cm (28.24 on seed 0 pinned to one core);
  port, 1 thread: 53.12 / 40.18 / 32.25 cm; 2 threads: 53.11 / 40.06 /
  32.16 cm; 8 threads: 39.57 / 38.80 / 37.13 cm.
Final keyframe counts part by at most 1 on seeds 0 and 1 and by 2 on seed 2
(whose two-view init lands a frame apart, the degenerate-sample RANSAC of
ROADMAP.md §C); the TUM quaternions part by up to 0.063 and the positions by
up to 1.04 m. So the test holds, on seed 0: each frame's (tracking state,
imu_ready, keyframe count) equal through the IMU init frame and the
tracking states on every frame, the init at the same frame, equal
--stats-out keys and frame, loop and readiness counts, final keyframe counts
within 2, equal TUM timestamps, quaternions within 0.07, and each app's
metric ATE against the truth under 60 cm (the largest reading, 53.12 cm,
plus an eighth). Then the edges: an image whose size differs from the
settings returns 1 in both apps, a stereo run on this tree's monocular
settings (no baseline) raises SettingsError in both (stereo trees:
tests/test_torch_app_stereo.py), and an atlas saved through System.SaveAtlasToFile is resumed through
System.LoadAtlasFromFile. The file takes 2-5 min alone: the JAX
MonocularInertialSLAM, SuperPoint and LightGlue compile for much of it, and
the port runs 50 frames at one torch thread under `-n 6` on 8 cores."""
import json
import os

import numpy as np
import pytest
import torch

from rover_slam_tpu.apps import run_euroc as japp
from rover_slam_tpu.utils import config as jcfg
from rover_slam_tpu_torch.apps import run_euroc as tapp
from rover_slam_tpu_torch.models import weights as W
from rover_slam_tpu_torch.utils import config as tcfg, synthetic, trajectory

from torch_parity import InitDraws, recording_app

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rover_slam_tpu", "assets")
HW = (240, 320)
N_FRAMES = 50


def settings_text(fx, extra=""):
    h, w = HW
    return (f'%YAML:1.0\nFile.version: "1.0"\nCamera.type: "PinHole"\n'
            f"Camera1.fx: {fx}\nCamera1.fy: {fx}\nCamera1.cx: {w / 2.0}\nCamera1.cy: {h / 2.0}\n"
            f"Camera.width: {w}\nCamera.height: {h}\nCamera.fps: 20.0\n"
            "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\nIMU.GyroWalk: 1.9e-5\n"
            "IMU.AccWalk: 3.0e-3\nIMU.Frequency: 200.0\nORBextractor.nFeatures: 512\n"
            "System.MapKeyFrames: 64\nSystem.MapLandmarks: 8192\nloopClosing: 1\n" + extra)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    h, w = HW
    fx = 458.0 * w / 640
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=HW,
                                       layout="ring", ring_orbit_radius=5.0)
    world = world._replace(cam_params=np.asarray([fx, fx, w / 2, h / 2, 0, 0, 0, 0],
                                                 np.float32))
    R, t, times, _, imu = synthetic.orbit_with_imu(n_frames=N_FRAMES, orbit_radius=5.0,
                                                   revs=1.1 * N_FRAMES / 160 * 1.5, dt=0.05)
    mav0, gt = synthetic.write_euroc_sequence(str(root / "mav0"), world, R, t, times, imu=imu)
    sp, lg = str(root / "sp.pth"), str(root / "lg.pth")
    torch.save(W.superpoint_state_dict(W.load_flat_npz(
        os.path.join(ASSETS, "superpoint_synth.npz"))), sp)
    torch.save(W.lightglue_official_state_dict(W.load_flat_npz(
        os.path.join(ASSETS, "lightglue_synth.npz"))), lg)
    settings = str(root / "settings.yaml")
    with open(settings, "w") as f:
        f.write(settings_text(fx))
    return dict(root=root, mav0=mav0, gt=gt, sp=sp, lg=lg, settings=settings, fx=fx)


@pytest.fixture(scope="module")
def runs(tree):
    draws = InitDraws()
    out = {}
    for name, app, side, extra in (("jax", japp, draws.jax_side, []),
                                   ("torch", tapp, draws.torch_side, ["--device", "cpu"])):
        traj, stats = str(tree["root"] / f"{name}_traj.txt"), str(tree["root"] / f"{name}.json")
        with side(), recording_app(app) as log:
            rc = app.main([tree["settings"], tree["mav0"], "--sensor", "monocular-inertial",
                           "--out", traj, "--gt", tree["gt"], "--stats-out", stats,
                           "--superpoint-ckpt", tree["sp"], "--lightglue-ckpt", tree["lg"],
                           *extra])
        with open(stats) as f:
            out[name] = dict(rc=rc, log=log, traj=trajectory.load_tum(traj), stats=json.load(f))
    return out


def test_apps_agree(runs):
    j, t = runs["jax"], runs["torch"]
    assert j["rc"] == t["rc"] == 0
    ready = [[i for i, e in enumerate(x["log"]) if e[1]][:1] for x in (j, t)]
    assert ready[0] == ready[1] and ready[0], ready
    init = ready[0][0]
    assert ([e[:3] for e in t["log"][:init + 1]] == [e[:3] for e in j["log"][:init + 1]])
    assert [e[0] for e in t["log"]] == [e[0] for e in j["log"]]
    assert t["stats"].keys() == j["stats"].keys()
    for k in ("frames", "n_loops", "imu_ready"):
        assert t["stats"][k] == j["stats"][k], k
    assert abs(t["stats"]["n_kf"] - j["stats"]["n_kf"]) <= 2
    for x in (j, t):
        assert x["stats"]["ate_cm"] < 60.0, x["stats"]["ate_cm"]
    (tt, _, qt), (tj, _, qj) = t["traj"], j["traj"]
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(qt * np.sign((qt * qj).sum(1))[:, None], qj, atol=0.07)


def test_image_size_mismatch_returns_1(tree, tmp_path):
    bad = str(tmp_path / "bad.yaml")
    with open(bad, "w") as f:
        f.write(settings_text(tree["fx"]).replace(f"Camera.width: {HW[1]}", "Camera.width: 300"))
    args = [bad, tree["mav0"], "--out", str(tmp_path / "t.txt"), "--max-frames", "2"]
    assert tapp.main(args + ["--device", "cpu"]) == 1
    assert japp.main(args) == 1


def test_stereo_sensor_raises(tree, tmp_path):
    """Settings with neither Camera.bf nor Stereo.T_c1_c2: both apps refuse
    the stereo sensors before reading a frame."""
    for sensor in ("stereo", "stereo-inertial"):
        for app, err, extra in ((tapp, tcfg.SettingsError, ["--device", "cpu"]),
                                (japp, jcfg.SettingsError, [])):
            with pytest.raises(err, match="Camera.bf or Stereo.T_c1_c2"):
                app.main([tree["settings"], tree["mav0"], "--sensor", sensor,
                          "--out", str(tmp_path / "t.txt"), *extra])


def test_atlas_save_and_resume(tree, tmp_path):
    """tests/test_run_euroc_app.py::test_atlas_save_load_via_settings on the
    port: session 1 saves the atlas through the settings, session 2 resumes
    it through System.LoadAtlasFromFile (its frame log counts the loaded
    keyframes), build_system resumes it too, and the JAX package loads the
    port's file."""
    from rover_slam_tpu.map import atlas as jat
    atlas_path = str(tmp_path / "atlas.npz")
    s1, s2 = str(tmp_path / "save.yaml"), str(tmp_path / "load.yaml")
    with open(s1, "w") as f:
        f.write(settings_text(tree["fx"], f'System.SaveAtlasToFile: "{atlas_path}"\n'))
    with open(s2, "w") as f:
        f.write(settings_text(tree["fx"], f'System.LoadAtlasFromFile: "{atlas_path}"\n'))
    common = ["--device", "cpu", "--sensor", "monocular", "--superpoint-ckpt", tree["sp"],
              "--lightglue-ckpt", tree["lg"]]
    stats = str(tmp_path / "s1.json")
    assert tapp.main([s1, tree["mav0"], "--out", str(tmp_path / "t1.txt"), "--max-frames",
                      "8", "--stats-out", stats, *common]) == 0
    with open(stats) as f:
        n_kf = json.load(f)["n_kf"]
    assert n_kf >= 2 and int(jat.load_atlas(atlas_path).n_kf) == n_kf
    flog = str(tmp_path / "frames.json")
    assert tapp.main([s2, tree["mav0"], "--out", str(tmp_path / "t2.txt"), "--max-frames",
                      "4", "--frame-log", flog, *common]) == 0
    with open(flog) as f:
        assert json.load(f)["n_kf_loaded"] == n_kf
    slam = tcfg.build_system(tcfg.load_settings(s2), device="cpu")
    assert slam.n_kf == int(slam.state.n_kf) == n_kf
    assert int(slam.state.active_map_id) == 1
