"""Settings and build_system of the port against the JAX package
(rover_slam_tpu/utils/config.py): every settings file the tests write,
each case of tests/test_config.py among them, gives equal Settings fields (intrinsics and IMU sigmas
rtol 1e-6); build_system hands the systems equal TrackerConfigs,
LoopConfigs, capacities and descriptor widths for the monocular and
monocular-inertial sensors and a KannalaBrandt8 camera. The stereo,
stereo-inertial and RGB-D sensors: the same YAML through both packages'
load_settings and build_system gives the same system class with equal
arguments (camera parameters rtol 1e-6, the baseline, bf or extrinsic, the
IMU calibration) and equal rectification maps (within 2e-3 px, as
tests/test_torch_rectify.py holds them), on a rectified pinhole rig (Camera.bf;
a toed-in rig with Stereo.T_c1_c2 and no distortion, which both take as
rectified), a raw pinhole rig (distortion coefficients: the rectified
K_new and bf), a KB8 rig (the fisheye classes) and RGB-D; both refuse a
stereo file with neither Camera.bf nor Stereo.T_c1_c2, and an
rgbd-inertial sensor, with SettingsError."""
import dataclasses
import importlib

import numpy as np
import pytest
import yaml

import chip_smoke
from rover_slam_tpu.utils import config as jcfg
from rover_slam_tpu_torch.utils import config as tcfg

from test_config import EUROC_YAML, TUMVI_YAML

APP_SETTINGS = {   # tests/test_run_euroc_app.py's settings, dumped by yaml.safe_dump
    "Camera.type": "PinHole", "Camera1.fx": 100.0, "Camera1.fy": 100.0,
    "Camera1.cx": 80.0, "Camera1.cy": 60.0, "Camera.width": 160, "Camera.height": 120,
    "Camera.fps": 20.0, "Camera.bf": 10.0, "ORBextractor.nFeatures": 128, "loopClosing": 0}
CV_MATRIX = """%YAML:1.0
---
# A reference-style file: nested maps, a multi-line opencv matrix.
Camera.type: "PinHole"
Camera1:
  fx: 458.654
  fy: 457.296
  cx: 367.215
  cy: 248.375
Camera.width: 752
Camera.height: 480
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.T_b_c1:
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
System.LocalMapOnly: 0
"""


def settings_texts():
    d = dict(APP_SETTINGS)
    out = {"euroc": EUROC_YAML, "tumvi": TUMVI_YAML, "cv_matrix": CV_MATRIX,
           "app": yaml.safe_dump(d),
           "app_save": yaml.safe_dump({**d, "System.SaveAtlasToFile": "/tmp/x/atlas.npz"}),
           "app_load": yaml.safe_dump({**d, "System.LoadAtlasFromFile": "/tmp/x/atlas.npz"}),
           "path_h": chip_smoke.path_h_settings('System.SaveAtlasToFile: "/tmp/h/atlas.npz"')}
    return out


@pytest.mark.parametrize("text", ["a: [1, 2", "a: b: c", "x: 1\n  y: 2", "- 1\n- 2",
                                  "just a string"])
def test_unreadable_settings_raise(tmp_path, text):
    """Malformed YAML, and a document that is not a mapping, raise
    SettingsError (the port reads with yaml.safe_load)."""
    p = tmp_path / "s.yaml"
    p.write_text("%YAML:1.0\n" + text)
    with pytest.raises(tcfg.SettingsError):
        tcfg.load_settings(str(p))


def assert_settings_equal(st, sj):
    assert st.cam_kind == sj.cam_kind and st.image_hw == sj.image_hw
    np.testing.assert_allclose(st.cam_params, np.asarray(sj.cam_params), rtol=1e-6)
    for f in ("fps", "sensor", "stereo_th_depth", "imu_freq", "n_features", "th_far_points",
              "load_atlas", "save_atlas", "loop_closing", "baseline"):
        assert getattr(st, f) == getattr(sj, f), f
    assert (st.imu is None) == (sj.imu is None)
    if st.imu is not None:
        for f in st.imu._fields:
            np.testing.assert_allclose(np.asarray(getattr(st.imu, f)),
                                       np.asarray(getattr(sj.imu, f)), rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("name,sensor", [("euroc", "monocular"), ("tumvi", "monocular"),
                                         ("euroc", "monocular-inertial"),
                                         ("cv_matrix", "monocular-inertial"),
                                         ("app", "monocular"), ("app_save", "monocular"),
                                         ("app_load", "monocular"),
                                         ("path_h", "monocular-inertial")])
def test_load_settings(tmp_path, name, sensor):
    p = tmp_path / "s.yaml"
    p.write_text(settings_texts()[name])
    assert_settings_equal(tcfg.load_settings(str(p), sensor=sensor),
                          jcfg.load_settings(str(p), sensor=sensor))


def test_settings_dict_cases():
    """tests/test_config.py's version gate, missing key and resize."""
    bad = {"File.version": "2.0", "Camera.fx": 1.0, "Camera.fy": 1, "Camera.cx": 0,
           "Camera.cy": 0, "Camera.width": 10, "Camera.height": 10}
    for mod in (tcfg, jcfg):
        with pytest.raises(mod.SettingsError, match="version"):
            mod.load_settings(bad)
        with pytest.raises(mod.SettingsError, match="missing"):
            mod.load_settings({"Camera.type": "PinHole"})
    resize = {"Camera.type": "PinHole", "Camera.fx": 400.0, "Camera.fy": 400.0,
              "Camera.cx": 320.0, "Camera.cy": 240.0, "Camera.width": 640,
              "Camera.height": 480, "Camera.newWidth": 320, "Camera.newHeight": 240}
    assert_settings_equal(tcfg.load_settings(resize), jcfg.load_settings(resize))


IMU_KEYS = ("IMU.NoiseGyro: 1.6e-4\nIMU.NoiseAcc: 2.8e-3\nIMU.GyroWalk: 2.2e-5\n"
            "IMU.AccWalk: 8.6e-4\n")


@pytest.mark.parametrize("sensor", ["stereo", "stereo-inertial", "rgbd"])
def test_stereo_sensors_raise(tmp_path, sensor):
    """What both packages refuse: a stereo sensor with neither Camera.bf nor
    Stereo.T_c1_c2, and the RGB-D sensor with an IMU, which the JAX package
    does not serve."""
    p = tmp_path / "s.yaml"
    if sensor == "rgbd":
        p.write_text(EUROC_YAML)
        for mod in (tcfg, jcfg):
            st = mod.load_settings(str(p), sensor="rgbd-inertial")
            with pytest.raises(mod.SettingsError, match="unsupported sensor"):
                mod.build_system(st, **({"device": "cpu"} if mod is tcfg else {}))
        return
    p.write_text(EUROC_YAML.replace("Camera.bf:", "Camera.other:"))
    for mod in (tcfg, jcfg):
        with pytest.raises(mod.SettingsError, match="Camera.bf or Stereo.T_c1_c2"):
            mod.load_settings(str(p), sensor=sensor)


class _Recorder:
    """Stands in for a SLAM system: records what build_system hands it."""

    def __init__(self, cam_params, *args, **kw):
        self.cam_params, self.args, self.kw = np.asarray(cam_params), args, kw


def _built(mod, names, settings, monkeypatch, **kw):
    # Import every module before patching any: a module first imported while
    # MonocularSLAM is patched would subclass _Recorder for good.
    for modname, _ in names:
        importlib.import_module(modname)
    for modname, cls in names:
        monkeypatch.setattr(f"{modname}.{cls}", _Recorder)
    return mod.build_system(settings, **kw)


@pytest.mark.parametrize("name,sensor", [("euroc", "monocular"), ("euroc", "monocular-inertial"),
                                         ("tumvi", "monocular"), ("tumvi", "monocular-inertial"),
                                         ("app", "monocular"), ("cv_matrix", "monocular")])
def test_build_system(tmp_path, monkeypatch, name, sensor):
    text = settings_texts()[name]
    if "inertial" in sensor and "IMU.NoiseGyro" not in text:
        text += "IMU.NoiseGyro: 1.6e-4\nIMU.NoiseAcc: 2.8e-3\nIMU.GyroWalk: 2.2e-5\n" \
                "IMU.AccWalk: 8.6e-4\n"
    p = tmp_path / "s.yaml"
    p.write_text(text)
    rt = _built(tcfg, [("rover_slam_tpu_torch.slam.system", "MonocularSLAM"),
                       ("rover_slam_tpu_torch.slam.inertial_system", "MonocularInertialSLAM")],
                tcfg.load_settings(str(p), sensor=sensor), monkeypatch, device="cpu")
    rj = _built(jcfg, [("rover_slam_tpu.slam.system", "MonocularSLAM"),
                       ("rover_slam_tpu.slam.inertial_system", "MonocularInertialSLAM")],
                jcfg.load_settings(str(p), sensor=sensor), monkeypatch)
    assert rt.kw.pop("device") == "cpu"
    np.testing.assert_allclose(rt.cam_params, rj.cam_params, rtol=1e-6)
    assert len(rt.args) == len(rj.args) == (1 if "inertial" in sensor else 0)
    cfg_t, cfg_j = rt.kw.pop("config"), rj.kw.pop("config")
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    lc_t, lc_j = rt.kw.pop("loop_config", None), rj.kw.pop("loop_config", None)
    assert (lc_t is None) == (lc_j is None)
    if lc_t is not None:
        assert dataclasses.asdict(lc_t) == dataclasses.asdict(lc_j)
    assert rt.kw == rj.kw          # map_capacity, desc_dim, enable_loop_closing, matcher
    assert rt.kw["desc_dim"] == 256


def _opencv_matrix(name, m):
    data = ", ".join(repr(float(x)) for x in np.asarray(m, np.float64).reshape(-1))
    return f"{name}:\n  rows: 4\n  cols: 4\n  dt: f\n  data: [{data}]\n"


def _rig_yaml(kind):
    """A stereo settings file: rectified (Camera.bf), toed-in (Stereo.T_c1_c2
    rotated, no distortion: still rectified), raw (T_c1_c2 and radtan
    coefficients on both eyes) or a KB8 rig (T_c1_c2)."""
    from test_rectify import D1, D2, K2, R_21, T_21
    T_12 = np.eye(4)
    T_12[:3, :3] = np.asarray(R_21).T
    T_12[:3, 3] = -np.asarray(R_21).T @ T_21
    if kind == "rectified":
        return EUROC_YAML
    if kind == "kb8":
        return TUMVI_YAML + IMU_KEYS + _opencv_matrix("Stereo.T_c1_c2", T_12)
    text = EUROC_YAML.replace("Camera.bf: 47.90639384423901\n", "") + \
        _opencv_matrix("Stereo.T_c1_c2", T_12)
    if kind == "raw":
        text += "".join(f"Camera1.{k}: {v}\n" for k, v in zip(("k1", "k2", "p1", "p2"), D1))
        text += "".join(f"Camera2.{k}: {v}\n" for k, v in
                        zip(("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"),
                            list(K2) + list(D2)))
    return text


STEREO_CASES = [("rectified", "stereo"), ("rectified", "stereo-inertial"),
                ("rectified", "rgbd"), ("toed_in", "stereo"), ("raw", "stereo"),
                ("raw", "stereo-inertial"), ("kb8", "stereo"), ("kb8", "stereo-inertial"),
                ("path_j", "stereo-inertial")]
STEREO_CLASSES = [("stereo", "StereoSLAM"), ("stereo", "RGBDSLAM"),
                  ("stereo", "FisheyeStereoSLAM"), ("stereo_inertial", "StereoInertialSLAM"),
                  ("stereo_inertial", "FisheyeStereoInertialSLAM")]


def _assert_same_args(a, b, what):
    """Arguments equal up to the array types: numbers rtol 1e-6, tuples and
    NamedTuples (ImuCalib, the (R_rl, t_rl) extrinsic) field by field."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_args(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-6, atol=1e-9, err_msg=what)


def _class_recorders(monkeypatch, pkg):
    """Patch the stereo classes of one package with recorders that remember
    which class build_system picked."""
    for modname, cls in STEREO_CLASSES:
        importlib.import_module(f"{pkg}.slam.{modname}")
    for modname, cls in STEREO_CLASSES:
        monkeypatch.setattr(f"{pkg}.slam.{modname}.{cls}",
                            type(cls, (_Recorder,), {"cls_name": cls}))


@pytest.mark.parametrize("rig,sensor", STEREO_CASES)
def test_stereo_settings_and_systems(tmp_path, monkeypatch, rig, sensor):
    text = chip_smoke.path_j_settings() if rig == "path_j" else _rig_yaml(rig)
    p = tmp_path / "s.yaml"
    p.write_text(text)
    st, sj = (mod.load_settings(str(p), sensor=sensor) for mod in (tcfg, jcfg))
    assert_settings_equal(st, sj)
    assert (st.rectification is None) == (sj.rectification is None) == (rig != "raw")
    if rig == "raw":
        for f in ("map1", "map2"):
            np.testing.assert_allclose(getattr(st.rectification, f),
                                       getattr(sj.rectification, f), rtol=0, atol=2e-3)
        for f in ("K_new", "R1", "R2"):
            np.testing.assert_allclose(getattr(st.rectification, f),
                                       getattr(sj.rectification, f), rtol=0, atol=1e-6)
        assert abs(st.rectification.bf_px - sj.rectification.bf_px) < 1e-6 * sj.rectification.bf_px
    for pkg in ("rover_slam_tpu_torch", "rover_slam_tpu"):
        _class_recorders(monkeypatch, pkg)
    rt = tcfg.build_system(st, device="cpu")
    rj = jcfg.build_system(sj)
    expected = {"rgbd": "RGBDSLAM"}.get(sensor) or (
        ("FisheyeStereoInertialSLAM" if "inertial" in sensor else "FisheyeStereoSLAM")
        if rig == "kb8" else
        ("StereoInertialSLAM" if "inertial" in sensor else "StereoSLAM"))
    assert rt.cls_name == rj.cls_name == expected
    assert rt.kw.pop("device") == "cpu"
    _assert_same_args(tuple(rt.cam_params), tuple(rj.cam_params), "cam_params")
    _assert_same_args(rt.args, rj.args, "args")
    cfg_t, cfg_j = rt.kw.pop("config"), rj.kw.pop("config")
    assert dataclasses.asdict(cfg_t) == {k: v for k, v in dataclasses.asdict(cfg_j).items()
                                         if k in dataclasses.asdict(cfg_t)}
    lc_t, lc_j = rt.kw.pop("loop_config", None), rj.kw.pop("loop_config", None)
    assert (lc_t is None) == (lc_j is None)
    if lc_t is not None:
        assert dataclasses.asdict(lc_t) == dataclasses.asdict(lc_j) and lc_t.fix_scale
    assert rt.kw.keys() == rj.kw.keys()
    for k in rt.kw:
        _assert_same_args(rt.kw[k], rj.kw[k], k)
    assert (getattr(rt, "rectification", None) is None) == (rig != "raw")
    if rig == "raw":
        assert rt.rectification is st.rectification
        np.testing.assert_allclose(rt.cam_params[:4], st.rectification.K_new, rtol=1e-6)
