"""Stereo and RGB-D SLAM: left/right matching on rectified pairs, landmarks
at measured depth, metric from the first frame.

Counterpart of rover_slam_tpu/slam/stereo.py without its fisheye parts (the
reference's Frame::ComputeStereoMatches, Tracking::StereoInitialization and
the stereo landmark spawning of CreateNewKeyFrame). Matching is one masked
descriptor-distance matrix: a mutual nearest neighbour restricted to the
scanline with positive disparity under max_disp. It stays plain torch: the
NN kernel (B2) has no mask, and the [N, N] bf16 distance product is the one
the JAX package computes outside any Pallas kernel (`association.desc_dist2`).
Every keypoint's stereo inverse depth rides with the frame into every
solver's third residual row (bf = baseline*fx).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie
from ..map import map_state as ms
from ..ops import association as assoc
from . import tracking as T
from .system import MonocularSLAM


def stereo_match_kernel(kpts_l, desc_l, valid_l, kpts_r, desc_r, valid_r, baseline_fx,
                        row_tol: float = 2.0, max_disp: float = 192.0,
                        th_desc2: float = ((assoc.TH_HIGH + assoc.TH_LOW) / 2) ** 2):
    """Rectified stereo matching: mutual NN on the same scanline (within
    row_tol px) with disparity in (0.1, max_disp) and the descriptor gate.
    Returns (match_r [N] int32, depth [N], disparity [N]); depth =
    baseline_fx / disparity, -1 where unmatched."""
    d2 = assoc.desc_dist2(desc_l, desc_r)
    drow = torch.abs(kpts_l[:, None, 1] - kpts_r[None, :, 1])
    disp = kpts_l[:, None, 0] - kpts_r[None, :, 0]
    ok = (valid_l[:, None] & valid_r[None, :] & (drow <= row_tol)
          & (disp > 0.1) & (disp < max_disp) & (d2 <= th_desc2))
    big = 1e9
    d2m = torch.where(ok, d2, big)
    best_r = torch.argmin(d2m, dim=1)
    best_l = torch.argmin(d2m, dim=0)
    has = torch.gather(d2m, 1, best_r[:, None])[:, 0] < big
    mutual = (best_l[best_r] == torch.arange(desc_l.shape[0], device=d2.device)) & has
    disp_sel = torch.gather(disp, 1, best_r[:, None])[:, 0]
    depth = torch.where(mutual, baseline_fx / torch.clamp(disp_sel, min=0.1), -1.0)
    return (torch.where(mutual, best_r, -1).to(torch.int32), depth,
            torch.where(mutual, disp_sel, -1.0))


def _spawn_stereo_landmarks_kernel(state: ms.MapState, kf_id, depth, max_depth):
    """Landmarks at stereo depth for the keyframe's keypoints that have none
    (depth in (0, max_depth); max_depth a float or a 0-dim tensor)."""
    N = state.N
    k = torch.as_tensor(kf_id, device=state.device).long()
    rays = state.kf_rays[k]
    free = (state.kf_kpt_valid[k] & (state.kf_landmark_idx[k] < 0)
            & (depth > 0) & (depth < max_depth))
    Xc = rays / torch.clamp(rays[:, 2:], min=1e-6) * depth[:, None]
    Ri, ti = lie.se3_inverse(state.kf_R_cw[k], state.kf_t_cw[k])
    Xw = lie.se3_apply(Ri, ti, Xc)
    nrm = Xw - ti
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-9)
    state, slots = ms.add_landmarks(state, Xw, state.kf_desc[k].float(), nrm,
                                    k.to(torch.int32).expand(N), free)
    li = torch.where(slots >= 0, slots, state.kf_landmark_idx[k])
    return state.replace(kf_landmark_idx=state.kf_landmark_idx.index_copy(
        0, k.reshape(1), li[None]))


class StereoSLAM(MonocularSLAM):
    """Rectified stereo SLAM, metric from the first frame:
    track_stereo_frame() takes both eyes' extractions; the stereo depth
    initializes the map and seeds landmarks at every keyframe."""

    def __init__(self, cam_params, baseline: float, **kw):
        super().__init__(cam_params, **kw)
        self.baseline = float(baseline)
        self.baseline_fx = self.baseline * float(np.asarray(cam_params)[0])
        self.bf = self.baseline_fx
        if self.loop_closer is not None:
            self.loop_closer.bf = self.baseline_fx

    def track_stereo_frame(self, kpts_l, rays_l, desc_l, valid_l, kpts_r, desc_r, valid_r,
                           time) -> dict:
        dev = self.device
        _, depth, _ = stereo_match_kernel(
            *(torch.as_tensor(x, device=dev) for x in (kpts_l, desc_l, valid_l,
                                                       kpts_r, desc_r, valid_r)),
            self._bf_arr())
        return self._after_stereo_depth(kpts_l, rays_l, desc_l, valid_l, depth, time)

    def _after_stereo_depth(self, kpts_l, rays_l, desc_l, valid_l, depth, time) -> dict:
        """Initialize on the first usable frame, else track as the monocular
        system does with the depth stashed for the keyframe's landmarks."""
        self._stereo_depth = depth
        if self.tracking_state in (T.NO_IMAGES_YET, T.NOT_INITIALIZED):
            ok = self._stereo_init(kpts_l, rays_l, desc_l, valid_l, depth, time)
            return {"state": self.tracking_state, "init": ok}
        return self.track_frame(kpts_l, rays_l, desc_l, valid_l, time)

    def _stereo_init(self, kpts, rays, desc, valid, depth, time) -> bool:
        """(reference StereoInitialization) The first frame with >= 100
        stereo points becomes a keyframe at the origin, with its landmarks
        at the measured depth."""
        dev = self.device
        kpts, rays, desc = (torch.as_tensor(x, device=dev).float() for x in (kpts, rays, desc))
        valid = torch.as_tensor(valid, device=dev).bool()
        has_depth = (depth > 0) & valid
        n_depth = int(has_depth.sum())
        if n_depth < 100:
            return False
        if not self._ensure_kf_capacity(need=1):
            return False
        X = rays / rays[:, 2:] * depth[:, None]
        state, slots = ms.add_landmarks(
            self.state, X, desc,
            X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-9),
            torch.zeros((self.state.N,), dtype=torch.int32, device=dev), has_depth)
        lm_idx = torch.where(slots >= 0, slots, -1)
        invd = torch.where(depth > 0, 1.0 / torch.clamp(depth, min=1e-6), -1.0)
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        state, kf_id = ms.add_keyframe(state, eye, zero, kpts, rays, desc, valid, lm_idx,
                                       float(time), parent=-1, kpt_invd=invd)
        self.state = state
        self._assign_uid(int(kf_id))
        self.n_kf = int(state.n_kf)
        frame = T.FrameData(kpts, rays, desc, valid, float(time), R_cw=eye, t_cw=zero,
                            landmark_idx=lm_idx)
        self.last_frame = frame
        self.tracking_state = T.OK
        self.ref_kf_tracked = n_depth
        self._last_n_inl = n_depth
        self._register_init_kf_in_db(int(kf_id))
        self._log_pose(frame)
        return True

    def _fused_mapping_ok(self) -> bool:
        # The stereo insert spawns depth-seeded landmarks after the insert.
        return False

    def _insert_keyframe(self, frame):
        """The monocular insert, then landmarks at stereo depth for the new
        keyframe's unmatched keypoints (far-point gate: 40 baselines, the
        reference's Stereo.ThDepth)."""
        super()._insert_keyframe(frame)
        depth = getattr(self, "_stereo_depth", None)
        if depth is None:
            return
        self.state = _spawn_stereo_landmarks_kernel(self.state, self.n_kf - 1, depth,
                                                    40.0 * self.baseline)


class RGBDSLAM(StereoSLAM):
    """RGB-D SLAM: per-keypoint depth from the sensor in place of the stereo
    disparity (the reference's RGBD Frame samples the depth map at the
    keypoints, scaled by RGBD.DepthMapFactor)."""

    def __init__(self, cam_params, depth_factor: float = 1.0, max_depth: float = 20.0, **kw):
        # The baseline only scales the far-point gate: max_depth sets it.
        super().__init__(cam_params, baseline=max_depth / 40.0, **kw)
        self.depth_factor = float(depth_factor)

    def track_rgbd_frame(self, kpts, rays, desc, valid, depth, time) -> dict:
        """depth: [N] sensor depth at each keypoint (<= 0: invalid)."""
        depth = torch.as_tensor(depth, dtype=torch.float32, device=self.device) / self.depth_factor
        self._stereo_depth = torch.where(depth > 0.05, depth, -1.0)
        if self.tracking_state in (T.NO_IMAGES_YET, T.NOT_INITIALIZED):
            ok = self._stereo_init(kpts, rays, desc, valid, self._stereo_depth, time)
            return {"state": self.tracking_state, "init": ok}
        return self.track_frame(kpts, rays, desc, valid, time)
