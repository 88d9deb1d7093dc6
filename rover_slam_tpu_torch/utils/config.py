"""Settings: the reference's YAML configuration surface, and session set-up.

Counterpart of rover_slam_tpu/utils/config.py: `Settings`, `SettingsError`,
`load_settings`, `build_system` and `resume_atlas`. The same keys
(Camera.type, Camera1.fx..., IMU.*, ORBextractor.nFeatures, System.*,
loopClosing) map onto the port's TrackerConfig, camera parameters and
ImuCalib, for every sensor the JAX package serves: monocular, stereo and
RGB-D, with or without the IMU for the first two. A raw (distorted) pinhole
stereo rig gets its rectification maps (geometry/rectify.py), and the system
runs in the rectified frame.

The file is read with PyYAML's safe loader once the cv::FileStorage
`%YAML:1.0` header is stripped, as the JAX package reads it; a file it cannot
read, or whose document is not a mapping, raises SettingsError.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import yaml

from ..geometry import cameras, rectify
from ..imu import preintegration as preint
from ..map import atlas
from ..map import keyframe_database as kdb


class SettingsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------

@dataclass
class Settings:
    cam_kind: int
    cam_params: np.ndarray          # [8]
    image_hw: tuple
    fps: float
    sensor: str                     # monocular | stereo | rgbd (+ -inertial)
    baseline: Optional[float] = None
    stereo_th_depth: float = 40.0
    imu: Optional[preint.ImuCalib] = None
    imu_freq: float = 200.0
    n_features: int = 1024
    th_far_points: Optional[float] = None
    load_atlas: Optional[str] = None
    save_atlas: Optional[str] = None
    loop_closing: bool = True
    # The rectification (geometry/rectify.StereoRectification) of a raw
    # pinhole stereo rig: the app remaps both eyes through it before the
    # extractor, and build_system runs the system on its K_new and bf
    # (reference Settings, src/Settings.cc:560-575; System::TrackStereo).
    rectification: Optional[object] = None
    raw: dict = field(default_factory=dict)


def _get(d: dict, key: str, required: bool = False, default=None):
    cur = d
    for part in key.split("."):
        if not isinstance(cur, dict) or part not in cur:
            if key in d:                 # flat "A.B" keys (cv::FileStorage)
                return d[key]
            if required:
                raise SettingsError(f"missing required setting: {key}")
            return default
        cur = cur[part]
    return cur


def _get_any(d: dict, keys, required: bool = False, default=None):
    """First present key wins (Camera1.fx falls back to Camera.fx)."""
    for k in keys:
        v = _get(d, k)
        if v is not None:
            return v
    if required:
        raise SettingsError(f"missing required setting: {keys[0]}")
    return default


def _matrix4(m) -> np.ndarray:
    return np.asarray(m.get("data", m) if isinstance(m, dict) else m,
                      np.float64).reshape(4, 4)


def load_settings(path_or_dict, sensor: str = "monocular") -> Settings:
    """Parse a reference-style YAML settings file (or a pre-parsed dict)."""
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        with open(path_or_dict) as f:
            text = f.read()
        # The reference files start with the cv::FileStorage "%YAML:1.0" tag.
        text = text.replace("%YAML:1.0", "").replace("%YAML 1.0", "")
        try:
            d = yaml.safe_load(text) or {}
        except yaml.YAMLError as e:
            raise SettingsError(f"{path_or_dict}: {e}") from e
        if not isinstance(d, dict):
            raise SettingsError(f"{path_or_dict}: the settings document is not a mapping")

    version = str(_get(d, "File.version", default="1.0"))
    if version not in ("1.0",):
        raise SettingsError(f"unsupported settings version {version} "
                            "(reference gate: File.version == '1.0')")
    cam_type = _get(d, "Camera.type", default="PinHole")
    fx = _get_any(d, ["Camera1.fx", "Camera.fx"], required=True)
    fy = _get_any(d, ["Camera1.fy", "Camera.fy"], required=True)
    cx = _get_any(d, ["Camera1.cx", "Camera.cx"], required=True)
    cy = _get_any(d, ["Camera1.cy", "Camera.cy"], required=True)
    if cam_type in ("PinHole", "Rectified"):
        kind = cameras.PINHOLE
        params = cameras.make_pinhole(fx, fy, cx, cy)
    elif cam_type == "KannalaBrandt8":
        kind = cameras.KANNALA_BRANDT8
        k = [_get_any(d, [f"Camera1.k{i}", f"Camera.k{i}"], default=0.0)
             for i in (1, 2, 3, 4)]
        params = cameras.make_kb8(fx, fy, cx, cy, *k)
    else:
        raise SettingsError(f"unknown Camera.type {cam_type}")
    params = params.numpy()

    w = int(_get(d, "Camera.width", required=True))
    h = int(_get(d, "Camera.height", required=True))
    nw, nh = _get(d, "Camera.newWidth"), _get(d, "Camera.newHeight")
    if nw and nh:
        # Resize semantics (reference Settings): intrinsics scale with the image.
        sx, sy = float(nw) / w, float(nh) / h
        params = params.copy()
        params[0] *= sx
        params[2] *= sx
        params[1] *= sy
        params[3] *= sy
        w, h = int(nw), int(nh)

    baseline, rectification = None, None
    if "stereo" in sensor:
        baseline, rectification = _stereo_rig(d, kind, (fx, fy, cx, cy), (h, w))

    imu = None
    freq = float(_get(d, "IMU.Frequency", default=200.0))
    if "inertial" in sensor:
        ng = float(_get(d, "IMU.NoiseGyro", required=True))
        na = float(_get(d, "IMU.NoiseAcc", required=True))
        wg = float(_get(d, "IMU.GyroWalk", required=True))
        wa = float(_get(d, "IMU.AccWalk", required=True))
        tbc = _get_any(d, ["IMU.T_b_c1", "Tbc"])
        m = _matrix4(tbc) if tbc is not None else np.eye(4)
        f32 = torch.float32
        # The reference scales noise by sqrt(freq), walk by 1/sqrt(freq)
        # (src/Tracking.cc:665-672).
        imu = preint.ImuCalib(
            Rbc=torch.tensor(m[:3, :3], dtype=f32), tbc=torch.tensor(m[:3, 3], dtype=f32),
            sigma_g=torch.tensor(ng * np.sqrt(freq), dtype=f32),
            sigma_a=torch.tensor(na * np.sqrt(freq), dtype=f32),
            walk_g=torch.tensor(wg / np.sqrt(freq), dtype=f32),
            walk_a=torch.tensor(wa / np.sqrt(freq), dtype=f32))

    return Settings(
        cam_kind=kind, cam_params=params, image_hw=(h, w),
        fps=float(_get(d, "Camera.fps", default=30.0)), sensor=sensor, baseline=baseline,
        stereo_th_depth=float(_get(d, "Stereo.ThDepth", default=40.0)),
        imu=imu, imu_freq=freq,
        n_features=int(_get(d, "ORBextractor.nFeatures", default=1024)),
        th_far_points=_get_any(d, ["System.thFarPoints", "thFarPoints"]),
        load_atlas=_get(d, "System.LoadAtlasFromFile"),
        save_atlas=_get(d, "System.SaveAtlasToFile"),
        loop_closing=bool(_get(d, "loopClosing", default=1)),
        rectification=rectification, raw=d)


def _stereo_rig(d: dict, kind: int, k1, image_hw):
    """(baseline, rectification or None) of a stereo rig: the baseline from
    Camera.bf / fx, else from |Stereo.T_c1_c2[:3, 3]|. The rig is raw, and
    gets the rectification maps, when the camera is pinhole, Stereo.T_c1_c2
    is given and a Camera1.* or Camera2.* distortion coefficient is non-zero
    (reference src/Settings.cc:560-575); T_c1_c2 is the right camera in the
    left one's frame, so x_2 = R_21 x_1 + t_21 with (R_21, t_21) its inverse."""
    fx, fy, cx, cy = k1
    baseline, rectification = None, None
    bf = _get(d, "Camera.bf")
    if bf is not None:
        baseline = float(bf) / float(fx)
    tlr = _get(d, "Stereo.T_c1_c2")
    if tlr is not None:
        m = _matrix4(tlr)
        if baseline is None:
            baseline = float(np.linalg.norm(m[:3, 3]))
        d1 = [_get_any(d, [f"Camera1.{k}", f"Camera.{k}"], default=0.0)
              for k in ("k1", "k2", "p1", "p2")]
        d2 = [_get(d, f"Camera2.{k}", default=0.0) for k in ("k1", "k2", "p1", "p2")]
        if kind == cameras.PINHOLE and any(abs(v) > 0 for v in d1 + d2):
            k2 = [_get(d, f"Camera2.{k}", default=v)
                  for k, v in zip(("fx", "fy", "cx", "cy"), k1)]
            R_12, t_12 = m[:3, :3], m[:3, 3]
            rectification = rectify.stereo_rectify_maps(
                np.array(k1, np.float64), np.asarray(d1), np.array(k2, np.float64),
                np.asarray(d2), R_12.T, -R_12.T @ t_12, image_hw)
    if baseline is None:
        raise SettingsError("stereo sensor needs Camera.bf or Stereo.T_c1_c2")
    return baseline, rectification


def _stereo_trl(settings: Settings):
    """The left camera's pose in the right camera's frame (R_rl, t_rl),
    float32, from Stereo.T_c1_c2 (the right camera in the left one's frame)."""
    tlr = _get(settings.raw, "Stereo.T_c1_c2")
    if tlr is None:
        raise SettingsError("fisheye stereo needs Stereo.T_c1_c2")
    m = _matrix4(tlr)
    R_rl = m[:3, :3].T
    t_rl = -R_rl @ m[:3, 3]
    return R_rl.astype(np.float32), t_rl.astype(np.float32)


def build_system(settings: Settings, **kw):
    """The SLAM system for the configured sensor (reference System ctor,
    src/System.cc:50-282), with the JAX package's sizing rules: N keypoint
    slots = ORBextractor.nFeatures, descriptor dim Extractor.descDim (256),
    K / L from System.MapKeyFrames / System.MapLandmarks, the tracker's and
    the loop closer's inlier gates scaled from the reference's 1024-feature
    constants, loopClosing honoured, and System.LoadAtlasFromFile resumed.
    A KB8 stereo rig gets the fisheye classes, a raw pinhole rig runs on the
    rectified K_new and bf (slam.rectification set), stereo and RGB-D lock
    the loop closer's Sim3 scale. kwargs override (device among them)."""
    from ..slam import stereo, stereo_inertial
    from ..slam.inertial_system import MonocularInertialSLAM
    from ..slam.system import MonocularSLAM
    from ..slam.tracking import TrackerConfig

    sensor = settings.sensor
    if sensor not in ("monocular", "monocular-inertial", "stereo", "stereo-inertial", "rgbd"):
        raise SettingsError(f"unsupported sensor {sensor}")
    n_feat = int(settings.n_features)
    raw = settings.raw
    cfg = kw.pop("config", None)
    if cfg is None:
        cfg = TrackerConfig(
            cam_kind=settings.cam_kind, image_hw=settings.image_hw,
            th_far_points=float(settings.th_far_points or 100.0),
            min_init_matches=max(20, min(100, n_feat // 10)),
            min_inliers_local_map=max(10, min(30, n_feat * 30 // 1024)),
            min_inliers_track=max(6, min(10, n_feat * 10 // 1024)),
            kf_cull_every=4,
            local_map_only=bool(_get(raw, "System.LocalMapOnly", default=1)),
            insert_kfs_when_lost=bool(_get(raw, "IMU.InsertKFsWhenLost", default=0)))
    kw.setdefault("desc_dim", int(_get(raw, "Extractor.descDim", default=256)))
    K_cap = int(_get(raw, "System.MapKeyFrames", default=512))
    L_cap = int(_get(raw, "System.MapLandmarks", default=max(8192, 16 * n_feat)))
    kw.setdefault("map_capacity", (K_cap, n_feat, L_cap))
    kw.setdefault("enable_loop_closing", settings.loop_closing)
    if kw.get("enable_loop_closing") and "loop_config" not in kw:
        from ..slam.loop_closing import LoopConfig
        kw["loop_config"] = LoopConfig(
            cam_kind=settings.cam_kind,
            fix_scale="inertial" in sensor or sensor in ("stereo", "rgbd"),
            min_covis_weight=max(20, min(100, n_feat * 100 // 1024)),
            min_proj_verify=max(25, min(200, n_feat * 200 // 1024)),
            min_bow_matches=max(15, min(20, n_feat * 20 // 1024)),
            min_sim3_inliers=max(15, min(20, n_feat * 20 // 1024)))
    cam, imu = settings.cam_params, settings.imu
    inertial = "inertial" in sensor
    rr = settings.rectification
    if sensor == "monocular":
        slam = MonocularSLAM(cam, config=cfg, **kw)
    elif sensor == "monocular-inertial":
        slam = MonocularInertialSLAM(cam, imu, config=cfg, **kw)
    elif sensor == "rgbd":
        slam = stereo.RGBDSLAM(cam, depth_factor=float(_get(raw, "RGBD.DepthMapFactor",
                                                            default=1.0)), config=cfg, **kw)
    elif settings.cam_kind == cameras.KANNALA_BRANDT8:
        # Fisheye rigs are not rectified: the general-extrinsic stereo.
        if inertial:
            slam = stereo_inertial.FisheyeStereoInertialSLAM(cam, imu, _stereo_trl(settings),
                                                             config=cfg, **kw)
        else:
            slam = stereo.FisheyeStereoSLAM(cam, _stereo_trl(settings), config=cfg, **kw)
    else:
        # A raw rig runs in the rectified frame (K_new, bf); the app remaps
        # the images through settings.rectification before the extractor.
        if rr is not None:
            cam = cameras.make_pinhole(*rr.K_new)
        baseline = float(rr.bf_px / rr.K_new[0]) if rr is not None else settings.baseline
        if inertial:
            slam = stereo_inertial.StereoInertialSLAM(cam, imu, baseline, config=cfg, **kw)
        else:
            slam = stereo.StereoSLAM(cam, baseline, config=cfg, **kw)
        if rr is not None:
            slam.rectification = rr
    if settings.load_atlas:
        resume_atlas(slam, atlas.load_atlas(settings.load_atlas, device=slam.device))
    return slam


def resume_atlas(slam, state):
    """Continue from a stored map state (reference LoadAtlas,
    src/System.cc:156-206): its keyframes get uids and enter the
    place-recognition database, and tracking starts a fresh Atlas map, which
    a cross-map detection later welds to the stored ones. With an IMU the
    preintegration chain restarts at the new map's first keyframe (raw IMU
    history is not checkpointed)."""
    slam.state = atlas.create_new_map(state)
    slam.n_kf = int(slam.state.n_kf)
    act = slam.state.kf_active.cpu().numpy()
    for s in np.nonzero(act[:slam.n_kf])[0]:
        slam._assign_uid(int(s))
    if slam.loop_closer is not None:
        st = slam.state
        slam.loop_closer.db = kdb.db_build_from_state(slam.loop_closer.db, st.kf_desc,
                                                      st.kf_kpt_valid, st.kf_active)
    if hasattr(slam, "_kf_preints"):
        slam._kf_preints = []
        slam._kf_base = slam.n_kf
    return slam
