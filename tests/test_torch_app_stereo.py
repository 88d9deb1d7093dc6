"""The port's EuRoC app with the stereo sensors (rover_slam_tpu_torch.apps.
run_euroc --sensor stereo | stereo-inertial --device cpu) against the JAX
package's app on one small rectified stereo tree from write_euroc_sequence
(baseline > 0): the ring photo world at 240x320 with 512 keypoints,
orbit_with_imu at 20 Hz over N_FRAMES frames with its IMU at 200 Hz, the
settings' rig from Stereo.T_c1_c2 (the right camera 0.11 m along x,
chip_smoke.py's path J1 rig), the shipped synth SuperPoint weights as an
official-layout checkpoint and mutual-NN matching (no LightGlue: the JAX
LightGlue compile would add a minute).

SuperPoint keeps a few different keypoints on the two runtimes (top-k
near-ties, ROADMAP.md §C), so the stereo matches and the tracked inliers part
from frame 0 (149 against 154 on frame 1) and the keyframe decisions part by
one now and then. Held, for both sensors: both apps return 0 and track every
frame, the keyframe counts within 2 on every frame, equal --stats-out keys,
frame and loop counts and IMU readiness, the stereo-inertial IMU init at
the same frame (INIT_FRAME), each app's ATE equal to the one recomputed
from its TUM file (scale-aligned for plain stereo and metric with the IMU,
as the JAX app scores them) and under ATE_BOUND_CM (measured, JAX / port:
stereo 10.47 / 31.71 cm, stereo-inertial 10.13 / 5.98 cm; the bounds are
the larger reading plus about 40 %), and the port's --frame-log carries the
right eye's read time. A raw rig (radtan coefficients in the settings): both
apps remap both eyes through the rectification maps and track RAW_FRAMES
frames, the last frame's stereo points within 5 %. A tree without cam1/:
both apps return 1. The file takes about 100 s alone at one torch thread,
over the 60 s of the other parity files: the JAX app's compiles (SuperPoint,
StereoSLAM and StereoInertialSLAM) and 2 x 2 x 30 CPU SuperPoint pairs."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rover_slam_tpu.apps import run_euroc as japp
from rover_slam_tpu_torch.apps import run_euroc as tapp
from rover_slam_tpu_torch.models import weights as W
from rover_slam_tpu_torch.utils import synthetic, trajectory

from torch_parity import recording_app

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rover_slam_tpu", "assets")
HW = (240, 320)
N_FRAMES = 30
BASELINE = 0.11
INIT_FRAME = 20       # tinit_s 1.0 at 20 Hz
RAW_FRAMES = 4
ATE_BOUND_CM = {"stereo": 45.0, "stereo-inertial": 15.0}


def settings_text(fx):
    h, w = HW
    T = np.eye(4)
    T[0, 3] = BASELINE
    data = ", ".join(repr(float(x)) for x in T.reshape(-1))
    return (f'%YAML:1.0\nFile.version: "1.0"\nCamera.type: "PinHole"\n'
            f"Camera1.fx: {fx}\nCamera1.fy: {fx}\nCamera1.cx: {w / 2.0}\nCamera1.cy: {h / 2.0}\n"
            f"Camera.width: {w}\nCamera.height: {h}\nCamera.fps: 20.0\n"
            "IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\nIMU.GyroWalk: 1.9e-5\n"
            "IMU.AccWalk: 3.0e-3\nIMU.Frequency: 200.0\nORBextractor.nFeatures: 512\n"
            "System.MapKeyFrames: 64\nSystem.MapLandmarks: 8192\nloopClosing: 0\n"
            f"Stereo.T_c1_c2:\n  rows: 4\n  cols: 4\n  dt: f\n  data: [{data}]\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("app_stereo")
    h, w = HW
    fx = 458.0 * w / 640
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=HW,
                                       layout="ring", ring_orbit_radius=5.0)
    world = world._replace(cam_params=np.asarray([fx, fx, w / 2, h / 2, 0, 0, 0, 0],
                                                 np.float32))
    R, t, times, _, imu = synthetic.orbit_with_imu(n_frames=N_FRAMES, orbit_radius=5.0,
                                                   revs=1.1 * N_FRAMES / 160, dt=0.05)
    mav0, gt = synthetic.write_euroc_sequence(str(root / "mav0"), world, R, t, times,
                                              baseline=BASELINE, imu=imu)
    sp = str(root / "sp.pth")
    torch.save(W.superpoint_state_dict(W.load_flat_npz(
        os.path.join(ASSETS, "superpoint_synth.npz"))), sp)
    settings = str(root / "settings.yaml")
    with open(settings, "w") as f:
        f.write(settings_text(fx))
    return dict(root=root, mav0=mav0, gt=gt, sp=sp, settings=settings)


def run_both(tree, sensor, settings=None, max_frames=None):
    """Both apps over the tree; each run's frame log (recording_app, plus
    the stereo points of each frame), its stats and trajectory, and for the
    port its --frame-log."""
    out = {}
    for name, app, extra in (("jax", japp, []), ("torch", tapp, ["--device", "cpu"])):
        tag = f"{name}_{sensor}_{max_frames}"
        stats, traj = (str(tree["root"] / f"{tag}.{e}") for e in ("json", "txt"))
        if name == "torch":
            extra = extra + ["--frame-log", str(tree["root"] / f"{tag}_frames.json")]
        if max_frames:
            extra = extra + ["--max-frames", str(max_frames)]
        with recording_app(app, "track_stereo_frame") as log:
            rc = app.main([settings or tree["settings"], tree["mav0"], "--sensor", sensor,
                           "--out", traj, "--gt", tree["gt"], "--stats-out", stats,
                           "--superpoint-ckpt", tree["sp"], *extra])
            n_stereo = int((np.asarray(log.slam._stereo_depth) > 0).sum())
        with open(stats) as f:
            out[name] = dict(rc=rc, log=log, stats=json.load(f), traj=traj, n_stereo=n_stereo,
                             slam=log.slam)
        if name == "torch":
            with open(str(tree["root"] / f"{tag}_frames.json")) as f:
                out[name]["frames"] = json.load(f)["frames"]
    return out


def _ate_from_file(run, gt, with_scale):
    t_e, p_e, _ = trajectory.load_tum(run["traj"])
    t_g, p_g, _ = trajectory.load_tum(gt)
    pairs = trajectory.associate_by_time(t_e, t_g)
    return 100.0 * trajectory.ate_rmse(np.stack([p_e[i] for i, _ in pairs]),
                                       np.stack([p_g[j] for _, j in pairs]),
                                       with_scale=with_scale)[0]


@pytest.mark.parametrize("sensor", ["stereo", "stereo-inertial"])
def test_stereo_apps_agree(tree, sensor):
    r = run_both(tree, sensor)
    j, t = r["jax"], r["torch"]
    assert j["rc"] == t["rc"] == 0
    assert [e[0] for e in t["log"]] == [e[0] for e in j["log"]] == [2] * N_FRAMES
    assert max(abs(a[2] - b[2]) for a, b in zip(t["log"], j["log"])) <= 2
    assert t["stats"].keys() == j["stats"].keys()
    for k in ("frames", "n_loops", "imu_ready"):
        assert t["stats"][k] == j["stats"][k], k
    if sensor == "stereo-inertial":
        ready = [[i for i, e in enumerate(x["log"]) if e[1]][:1] for x in (j, t)]
        assert ready[0] == ready[1] == [INIT_FRAME], ready
    inertial = "inertial" in sensor
    for x in (j, t):
        # The app's ATE: scale-aligned for plain stereo, metric with the IMU.
        assert abs(_ate_from_file(x, tree["gt"], not inertial) - x["stats"]["ate_cm"]) < 1e-3
        assert x["stats"]["ate_cm"] < ATE_BOUND_CM[sensor], x["stats"]["ate_cm"]
    assert all("read_r_ms" in f for f in t["frames"]) and len(t["frames"]) == N_FRAMES


def test_raw_rig_app(tree, tmp_path):
    """Settings with radtan coefficients make the rig raw: both apps remap
    both eyes through the settings' rectification before extraction and
    track in the rectified frame (same states, stereo points of the last
    frame within 5 %)."""
    raw = str(tmp_path / "raw.yaml")
    with open(tree["settings"]) as f, open(raw, "w") as g:
        g.write(f.read() + "Camera1.k1: -0.01\nCamera2.k1: -0.01\n")
    r = run_both(tree, "stereo", settings=raw, max_frames=RAW_FRAMES)
    j, t = r["jax"], r["torch"]
    assert j["rc"] == t["rc"] == 0
    assert [e[0] for e in t["log"]] == [e[0] for e in j["log"]] == [2] * RAW_FRAMES
    for x in (j, t):
        assert x["slam"].rectification is not None
    assert abs(t["n_stereo"] - j["n_stereo"]) <= 0.05 * j["n_stereo"] and j["n_stereo"] > 100


def test_stereo_without_cam1_returns_1(tree, tmp_path):
    """A tree with no right eye: both apps return 1 before any frame."""
    mav0 = tmp_path / "mav0"
    shutil.copytree(tree["mav0"], str(mav0), ignore=shutil.ignore_patterns("cam1"))
    for app, extra in ((japp, []), (tapp, ["--device", "cpu"])):
        assert app.main([tree["settings"], str(mav0), "--sensor", "stereo-inertial",
                         "--out", str(tmp_path / "t.txt"), *extra]) == 1
