"""Stereo-inertial SLAM (the reference's IMU_STEREO mode): metric from the
stereo depth of the first frame, gravity and biases from the IMU.

Counterpart of rover_slam_tpu/slam/stereo_inertial.py. The IMU init and its
refinements run the inertial-only estimator with the scale fixed at 1
(reference InertialOptimization with the scale vertex fixed;
LocalMapping::InitializeIMU's stereo branch, mTinit = 1 s): stereo depth is
already metric. The rectified and fisheye stereo front ends of
slam/stereo.py sit on MonocularInertialSLAM.
"""
from __future__ import annotations

import torch

from ..imu import preintegration as preint
from ..optim import inertial_init as ii
from . import tracking as T
from .inertial_system import (MonocularInertialSLAM, _apply_alignment_kernel,
                              _body_from_camera)
from .stereo import FisheyeStereoMixin, StereoFrontEnd, fisheye_baseline


class StereoInertialSLAM(StereoFrontEnd, MonocularInertialSLAM):
    """Stereo + IMU: metric from frame 0, gravity and biases from the IMU
    init with the scale fixed at 1."""

    def __init__(self, cam_params, imu_calib: preint.ImuCalib, baseline: float,
                 tinit_s: float = 1.0, **kw):
        super().__init__(cam_params, imu_calib, tinit_s=tinit_s, **kw)
        self._init_stereo(cam_params, baseline)

    def _after_stereo_depth(self, kpts_l, rays_l, desc_l, valid_l, depth, time) -> dict:
        initializing = self.tracking_state in (T.NO_IMAGES_YET, T.NOT_INITIALIZED)
        info = super()._after_stereo_depth(kpts_l, rays_l, desc_l, valid_l, depth, time)
        if initializing:
            # The IMU window restarts at the init frame.
            info["imu_ready"] = self.imu_ready
            self._last_frame_time = float(time)
            self._imu_buf = []
        return info

    def _stereo_init(self, kpts, rays, desc, valid, depth, time) -> bool:
        """The stereo init, its landmarks first seen by the new keyframe's
        slot; the keyframe preintegration chain starts at that keyframe."""
        ok = super()._stereo_init(kpts, rays, desc, valid, depth, time,
                                  lm_kf=int(self.state.n_kf))
        if ok:
            self._kf_preints = []
            self._kf_base = self.n_kf - 1
            self._preint_since_kf = None
        return ok

    def _initialize_imu(self):
        """Gravity and biases only over the last keyframes (at least 4), the
        map rotated by Rwg at scale 1."""
        K = min(self.n_kf, len(self._kf_preints) + 1)
        if K < 4:
            return
        idx = list(range(self.n_kf - K, self.n_kf))
        segs = self._kf_preints[-(K - 1):]
        res = ii.inertial_only_optimization(self._build_init_problem(idx, segs),
                                            prior_g=1e2, prior_a=1e6, fix_scale=True)
        dev = self.device
        v_full = torch.zeros((self.state.K, 3), device=dev)
        v_full[torch.tensor(idx, device=dev)] = res.v_wb[:len(idx)]
        self.state = _apply_alignment_kernel(self.state, res.Rwg, torch.tensor(1.0, device=dev),
                                             v_full, res.bg, res.ba, self.calib.Rbc,
                                             self.calib.tbc)
        self.bg, self.ba = res.bg, res.ba
        lf = self.last_frame
        if lf is not None and lf.R_cw is not None:
            lf.R_cw = lf.R_cw @ res.Rwg
        self.velocity = None
        # The body state at the last frame, not at the last keyframe.
        k_last = self.n_kf - 1
        if lf is not None and lf.R_cw is not None:
            self.R_wb, self.p_wb = _body_from_camera(lf.R_cw, lf.t_cw, self.calib.Rbc,
                                                     self.calib.tbc)
        else:
            self.R_wb, self.p_wb = self.state.kf_R_wb[k_last], self.state.kf_p_wb[k_last]
        self.v_wb = self.state.kf_v_wb[k_last]
        self.imu_ready = True
        self.imu_init_time = lf.time if lf is not None else None

    def _refine_scale(self, max_window: int = 30):
        """The scale is metric: refine gravity and biases only, over at
        least 5 segments."""
        W = min(max_window, self.n_kf - self._kf_base)
        lo = self.n_kf - W
        segs = self._kf_preints[lo - self._kf_base:self.n_kf - 1 - self._kf_base]
        if len(segs) < 5:
            return
        res = ii.inertial_only_optimization(
            self._build_init_problem(list(range(lo, self.n_kf)), segs),
            prior_g=1e2, prior_a=1e6, fix_scale=True)
        self.bg, self.ba = res.bg, res.ba


class FisheyeStereoInertialSLAM(FisheyeStereoMixin, StereoInertialSLAM):
    """Fisheye stereo + IMU (the reference's TUM-VI 512 stereo-inertial
    configuration: KannalaBrandt8 cameras, Stereo.T_c1_c2 extrinsic)."""

    def __init__(self, cam_params, imu_calib, T_rl, **kw):
        super().__init__(cam_params, imu_calib, baseline=fisheye_baseline(T_rl), **kw)
        self._init_fisheye(T_rl)
