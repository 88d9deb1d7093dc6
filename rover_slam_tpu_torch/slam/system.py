"""System facade: the user-facing monocular SLAM API.

Counterpart of the synchronous path of rover_slam_tpu/slam/system.py
(`MonocularSLAM` with pipeline=0 and loop closing off): per frame one track
step and one flags fetch, then the host state machine and the keyframe
decision; a keyframe insert runs triangulation, fusion and the windowed
local BA on the device. Everything outside this slice raises
NotImplementedError naming the slice that brings it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry import two_view
from ..map import map_state as ms
from ..utils.timing import StageTimers
from . import tracking as T


def _later(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice of "
        "the PyTorch port (see ROADMAP.md)")


class MonocularSLAM:
    """Monocular visual SLAM (the reference's System(..., MONOCULAR) mode)."""

    def __init__(self, cam_params, config: Optional[T.TrackerConfig] = None,
                 map_capacity=(128, 512, 8192), desc_dim: int = 64,
                 enable_loop_closing: bool = False, loop_config=None,
                 pipeline=False, matcher=None, mesh=None, device=None):
        """matcher: optional learned frame-to-frame matcher called as
        matcher(kpts0, desc0, valid0, kpts1, desc1, valid1) -> [N] int32
        prev->cur indices (e.g. models.lightglue.LightGlueFrameMatcher);
        None means mutual-NN descriptor matching (kernel B2). The two-view
        RANSAC draws from a torch.Generator seeded with 7 (the JAX package's
        PRNGKey(7)). device None means cuda."""
        if enable_loop_closing or loop_config is not None:
            raise _later("Loop closing", "loop-closing")
        if pipeline:
            raise _later("pipeline=K (fused on-device track+map)", "pipelined tracking")
        if mesh is not None:
            raise _later("Multi-device map-scale BA (mesh=)", "multi-device")
        self.device = resolve_device(device)
        self.cfg = config or T.TrackerConfig()
        if self.cfg.kf_cull_every > 0:
            raise _later("Keyframe culling (kf_cull_every>0)",
                         "capacity compaction and keyframe culling")
        self.matcher = matcher
        self.cam_params = torch.tensor(np.asarray(cam_params, np.float32),
                                       device=self.device)
        K, N, L = map_capacity
        self.state = ms.empty_map(K=K, N=N, L=L, D=desc_dim, device=self.device)
        self.tracking_state = T.NO_IMAGES_YET
        self.velocity = None
        self.last_frame: Optional[T.FrameData] = None
        self.init_frame: Optional[T.FrameData] = None
        self.ref_kf_tracked = 0
        self.frames_since_kf = 0
        self.n_kf = 0
        self.timers = StageTimers()
        # Trajectory log: (time, R_cw, t_cw, state, ref_slot, R_cr, t_cr);
        # poses relative to the reference keyframe are recomposed at save
        # time so later map corrections reach the whole history. Keyframe
        # slots are stable identities until compaction (a later slice)
        # renumbers them.
        self.trajectory = []
        self._generator = torch.Generator().manual_seed(7)
        self._n_lm_used = 0
        self._local_mask = None
        self._kf_scalars = None
        self._force_kf = False
        self._last_n_inl = 0
        self._lost_frames = 0
        self._lost_since = 0.0
        self._last_full_ok = 0.0

    # ------------------------------------------------------------------
    def track_frame(self, kpts, rays, desc, valid, time) -> dict:
        """Process one frame (arrays shaped [N, ...]). Returns tracking info."""
        dev = self.device
        frame = T.FrameData(torch.as_tensor(kpts, device=dev).float(),
                            torch.as_tensor(rays, device=dev).float(),
                            torch.as_tensor(desc, device=dev).float(),
                            torch.as_tensor(valid, device=dev).bool(), float(time))
        if (self.cfg.timestamp_jump_s > 0 and self.last_frame is not None
                and self.tracking_state in (T.OK, T.RECENTLY_LOST)
                and (float(time) < self.last_frame.time - 1e-6
                     or float(time) - self.last_frame.time > self.cfg.timestamp_jump_s)):
            raise _later("A timestamp jump (new Atlas map)", "LOST/Atlas")
        if self.tracking_state == T.NO_IMAGES_YET:
            self.init_frame = frame
            self.tracking_state = T.NOT_INITIALIZED
            self.last_frame = frame
            return {"state": self.tracking_state}
        if self.tracking_state == T.NOT_INITIALIZED:
            ok = self._monocular_init(frame)
            if ok:
                self._log_pose(frame)
            return {"state": self.tracking_state, "init": ok}

        with self.timers.stage("lm_track"):
            R0, t0 = self._predict_pose()
            prev = self.last_frame
            prev_lidx = prev.landmark_idx if prev.landmark_idx is not None \
                else torch.full((self.state.N,), -1, dtype=torch.int32, device=dev)
            ext_matches = None
            if self.matcher is not None:
                ext_matches = self.matcher(prev.kpts, prev.desc, prev.valid,
                                           frame.kpts, frame.desc, frame.valid)
            cfg = self.cfg
            R2, t2, cur_lm, flags = T._track_step_body(
                self.state, prev.desc, prev.valid, prev_lidx,
                frame.kpts, frame.desc, frame.valid, R0, t0,
                self.cam_params, cfg.cam_kind, cfg.image_hw,
                cfg.min_matches_motion, cfg.min_inliers_track,
                cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2,
                ref_kf=torch.tensor(max(self.n_kf - 1, 0), dtype=torch.int32, device=dev),
                local_map_only=cfg.local_map_only, ext_matches=ext_matches,
                max_depth=cfg.th_far_points, min_matches_ref_kf=cfg.min_matches_ref_kf,
                motion_rounds=cfg.motion_rounds, motion_iters=cfg.motion_iters,
                local_rounds=cfg.local_rounds, local_iters=cfg.local_iters,
                local_mask=self._local_mask, min_inliers_weak=cfg.min_inliers_weak)
            frame.R_cw, frame.t_cw, frame.landmark_idx = R2, t2, cur_lm
        info = self._finish_track(frame, flags)
        self.last_frame = frame
        self.frames_since_kf += 1
        return info

    def _finish_track(self, frame: T.FrameData, flags) -> dict:
        """State machine and keyframe decision from the frame's flags."""
        with self.timers.stage("flags_fetch"):
            flags = flags.cpu().numpy()       # the one host sync per frame
        ok = bool(flags[0])
        self._last_n_inl = int(flags[1])
        weak = bool(flags[4])
        if ok:
            self._last_full_ok = frame.time
        if not ok and weak:
            # Weak band: keep the optimized pose, stay OK, insert urgently;
            # weak-only for the whole grace window counts as lost.
            ok = True
            self._force_kf = True
            if frame.time - self._last_full_ok > self.cfg.time_recently_lost_s:
                ok = False
                self._force_kf = False
        if not ok:
            self._lost_frames += 1
            if self.tracking_state != T.RECENTLY_LOST:
                self._lost_since = frame.time
            self.tracking_state = T.RECENTLY_LOST
            if (self._lost_frames >= 2 and self.n_kf >= 2
                    and self._lost_frames % max(self.cfg.reloc_every, 1) == 0):
                raise _later("Relocalization", "relocalization")
            if (frame.time - self._lost_since > self.cfg.time_recently_lost_s
                    or frame.time - self._last_full_ok > self.cfg.time_recently_lost_s):
                raise _later("LOST handling (reset or new Atlas map)", "LOST/Atlas")
        else:
            self._lost_frames = 0
            self.tracking_state = T.OK
            self._update_motion_model(frame)
        self._log_pose(frame)
        if ok and self._need_new_keyframe(frame):
            with self.timers.stage("new_kf"):
                self._insert_keyframe(frame)
        return {"state": self.tracking_state, "n_inliers": self._last_n_inl,
                "pose": (frame.R_cw, frame.t_cw)}

    # ------------------------------------------------------------------
    def _monocular_init(self, frame: T.FrameData) -> bool:
        """(reference MonocularInitialization)"""
        f0 = self.init_frame
        if self.matcher is not None:
            matches = self.matcher(f0.kpts, f0.desc, f0.valid,
                                   frame.kpts, frame.desc, frame.valid)
        else:
            matches, _ = T._match_prev(f0.desc, f0.valid, frame.desc, frame.valid)
        n_m = int(torch.sum(matches >= 0))
        if n_m < self.cfg.min_init_matches:
            # Restart only on match failure; on geometric failure keep f0 so
            # the baseline keeps growing.
            self.init_frame = frame
            self.last_frame = frame
            return False
        self._ensure_kf_capacity(need=2)
        x0, x1 = T._init_coords(f0.rays, frame.rays, matches)
        sigma_n = float(self.cfg.init_sigma_px) / float(self.cam_params[0])
        tv = two_view.reconstruct(x0, x1, matches >= 0, generator=self._generator,
                                  sigma_n=sigma_n,
                                  min_inliers=self.cfg.min_init_matches // 2)
        if not bool(tv.success):
            return False
        base = int(self.state.n_kf)
        self.state, _, _ = T._init_map_kernel(
            self.state, f0.kpts, f0.rays, f0.desc, f0.valid,
            frame.kpts, frame.rays, frame.desc, frame.valid,
            f0.time, frame.time, matches, tv.success, tv.R_21, tv.t_21,
            tv.points3d, tv.is_triangulated, self.cam_params, self.cfg.cam_kind)
        self.n_kf = base + 2
        # Init BA over the two keyframes (reference GlobalBundleAdjustemnt(20)).
        pad = self.cfg.local_window + self.cfg.fixed_window - 2
        dev = self.device
        window = torch.tensor([base, base + 1] + [-1] * pad, dtype=torch.int32, device=dev)
        opt_mask = torch.tensor([False, True] + [False] * pad, device=dev)
        self.state = T._local_ba_body(self.state, window, opt_mask, self.cam_params,
                                      self.cfg.cam_kind, iters=12)
        frame.R_cw = self.state.kf_R_cw[base + 1]
        frame.t_cw = self.state.kf_t_cw[base + 1]
        frame.landmark_idx = self.state.kf_landmark_idx[base + 1]
        f0.R_cw, f0.t_cw = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        self.tracking_state = T.OK
        self._last_full_ok = frame.time
        self.ref_kf_tracked = int(T._count_kf_obs(self.state, base + 1))
        self._last_n_inl = self.ref_kf_tracked
        self.velocity = None
        self.frames_since_kf = 0
        self.last_frame = frame
        return True

    def _predict_pose(self):
        """Constant-velocity motion model."""
        R1, t1 = self.last_frame.R_cw, self.last_frame.t_cw
        if self.velocity is None:
            return R1, t1
        dR, dt = self.velocity
        return T._compose_pose(dR, dt, R1, t1)

    def _update_motion_model(self, frame):
        self.velocity = T._relative_pose(self.last_frame.R_cw, self.last_frame.t_cw,
                                         frame.R_cw, frame.t_cw)

    # ------------------------------------------------------------------
    def _ensure_kf_capacity(self, need: int = 1):
        if self.n_kf + need > self.state.K:
            raise _later("Keyframe-table compaction (capacity full)",
                         "capacity compaction and keyframe culling")

    def _relieve_capacity(self):
        if self._n_lm_used >= self.state.L - (3 * self.state.N + 64):
            raise _later("Landmark-table compaction (capacity pressure)",
                         "capacity compaction and keyframe culling")
        self._ensure_kf_capacity(need=1)

    def _need_new_keyframe(self, frame) -> bool:
        """(reference NeedNewKeyFrame: the c1/c2 policy on the tracker's
        inlier decay from its peak since the last insert)."""
        if self._kf_scalars is not None:
            self._n_lm_used = int(self._kf_scalars.cpu()[5])
            self._kf_scalars = None
        self._relieve_capacity()
        if self._force_kf:
            self._force_kf = False
            return True
        if self.frames_since_kf < self.cfg.kf_min_interval:
            return False
        if self.frames_since_kf >= self.cfg.kf_max_interval:
            return True
        self.ref_kf_tracked = max(self.ref_kf_tracked, self._last_n_inl)
        return self._last_n_inl < self.cfg.kf_tracked_ratio * max(self.ref_kf_tracked, 1)

    def _insert_keyframe(self, frame):
        """Keyframe insert + the local-mapping work (triangulation, fusion,
        local BA) as one device program."""
        run_ba = self.cfg.ba_every <= 1 or self.n_kf % self.cfg.ba_every == 0
        ext_ids = ext_tri = None
        if (self.matcher is not None and self.n_kf >= 2
                and hasattr(self.matcher, "match_batch")):
            # Learned triangulation matches: the top-2 covisible neighbours,
            # then ONE batched match for both pairs.
            ids = T._top_covis_for_frame(self.state, frame.landmark_idx,
                                         frame.valid, n=2).cpu().numpy()
            if (ids >= 0).any():
                jid = torch.as_tensor(np.clip(ids, 0, self.state.K - 1),
                                      device=self.device).long()
                B = len(ids)
                ext_tri = self.matcher.match_batch(
                    frame.kpts.expand(B, -1, -1), frame.desc.expand(B, -1, -1),
                    frame.valid.expand(B, -1), self.state.kf_kpts[jid],
                    self.state.kf_desc[jid].float(), self.state.kf_kpt_valid[jid])
                ext_ids = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        self.state, scalars, self._local_mask = T._insert_keyframe_body(
            self.state, frame.R_cw, frame.t_cw, frame.kpts, frame.rays,
            frame.desc, frame.valid, frame.landmark_idx, frame.time,
            self.n_kf - 1, self.cam_params, self.cfg.cam_kind,
            self.cfg.local_window, self.cfg.fixed_window, self.cfg.ba_iters,
            run_ba=run_ba, ext_tri_ids=ext_ids, ext_tri_matches=ext_tri)
        self.n_kf += 1
        self.frames_since_kf = 0
        self.ref_kf_tracked = max(self._last_n_inl, 20)
        # Read by the next keyframe decision (n_lm for the capacity check).
        self._kf_scalars = scalars

    # ------------------------------------------------------------------
    def _log_pose(self, frame):
        ref_slot, R_cr, t_cr = -1, None, None
        if self.n_kf >= 1 and frame.R_cw is not None:
            ref_slot = self.n_kf - 1
            R_cr, t_cr = T._rel_to_kf(self.state, frame.R_cw, frame.t_cw, ref_slot)
        self.trajectory.append((frame.time, frame.R_cw, frame.t_cw,
                                self.tracking_state, ref_slot, R_cr, t_cr))

    def get_trajectory(self, reconstitute: bool = True):
        """Final trajectory (times, R_cw [F,3,3], t_cw [F,3]) as numpy arrays.
        reconstitute=True composes each frame's logged pose relative to its
        reference keyframe with that keyframe's current pose."""
        if not self.trajectory:
            return np.zeros((0,)), np.zeros((0, 3, 3)), np.zeros((0, 3))
        times = np.array([e[0] for e in self.trajectory])
        Rs = np.stack([e[1].cpu().numpy() for e in self.trajectory])
        ts = np.stack([e[2].cpu().numpy() for e in self.trajectory])
        if not reconstitute:
            return times, Rs, ts
        kf_R = self.state.kf_R_cw.cpu().numpy()
        kf_t = self.state.kf_t_cw.cpu().numpy()
        for i, (_, _, _, _, s, R_cr, t_cr) in enumerate(self.trajectory):
            if s < 0 or R_cr is None:
                continue
            R_cr = R_cr.cpu().numpy()
            Rs[i] = R_cr @ kf_R[s]
            ts[i] = R_cr @ kf_t[s] + t_cr.cpu().numpy()
        return times, Rs, ts
