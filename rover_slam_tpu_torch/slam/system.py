"""System facade: the user-facing monocular SLAM API.

Counterpart of rover_slam_tpu/slam/system.py (`MonocularSLAM`): per frame
one track step and one flags fetch, then the host state machine (OK,
RECENTLY_LOST with relocalization, LOST with a new Atlas map) and the
keyframe decision; a keyframe insert runs triangulation, fusion and the
windowed local BA on the device. With pipeline=K the keyframe decision and
insert run inside the frame's device program (`_track_and_map_body`) and the
host reads each frame's flags K frames later; a subclass that keeps its
inserts on the host (`_fused_mapping_ok`, the inertial system) defers the
whole finish, its keyframe decision and insert included. The hooks
`_prepare_frame`, `_on_frame_finish`, `_post_track_refine`, `_on_map_merged`
and `_on_compaction` are where the JAX package calls them. Keyframe slots
carry host-side uids so that culling and compaction, which recycle slots,
keep the trajectory whole. With enable_loop_closing every keyframe goes through the loop closer
(`slam/loop_closing.py`) and every finished frame polls it; with a mesh its
post-loop global BA runs sharded (parallel/sharded_ba.py).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry import two_view
from ..map import atlas
from ..map import maintenance
from ..map import keyframe_database as kdb
from ..map import map_state as ms
from ..ops import _build
from ..utils import profiling
from ..utils.timing import StageTimers
from . import tracking as T
from .host_copy import HostCopy
from .loop_closing import LoopCloser


class MonocularSLAM:
    """Monocular visual SLAM (the reference's System(..., MONOCULAR) mode)."""

    def __init__(self, cam_params, config: Optional[T.TrackerConfig] = None,
                 map_capacity=(128, 512, 8192), desc_dim: int = 64,
                 enable_loop_closing: bool = False, loop_config=None,
                 pipeline=False, matcher=None, mesh=None, device=None):
        """matcher: optional learned frame-to-frame matcher called as
        matcher(kpts0, desc0, valid0, kpts1, desc1, valid1) -> [N] int32
        prev->cur indices (e.g. models.lightglue.LightGlueFrameMatcher);
        None means mutual-NN descriptor matching (kernel B2).

        pipeline=K (int, True means 4): once the map holds
        pipeline_warmup_kfs keyframes, each frame runs as one fused device
        program (track, keyframe decision, insert) and its flags are read
        K frames later; the state machine lags K frames. Call flush() before
        reading final results.

        enable_loop_closing: place recognition, Sim3 verification, loop
        correction with global BA and map merging (loop_config: a
        loop_closing.LoopConfig); the loop closer uses the matcher too.

        The RANSAC draws (init, relocalization) come from a torch.Generator
        seeded with 7 (the JAX package's PRNGKey(7)). device None means
        cuda.

        mesh: a parallel.sharded_ba.Mesh; the loop closer's global BA then
        shards over it (landmark-sharded, map scale)."""
        self.device = resolve_device(device)
        self.cfg = config or T.TrackerConfig()
        self.matcher = matcher
        self.pipeline_depth = 4 if pipeline is True else int(pipeline)
        self.pipeline = self.pipeline_depth > 0
        # Synchronous until the map has bootstrapped: right after init each
        # frame's tracking needs the previous frame's triangulations.
        self.pipeline_warmup_kfs = 8
        self._pending = deque()       # FIFO of (frame, HostCopy of its flags)
        self.cam_params = torch.tensor(np.asarray(cam_params, np.float32),
                                       device=self.device)
        # baseline*fx (the stereo and RGBD systems set it): adds the stereo
        # residual row to every solver.
        self.bf = None
        self._bf_cache = (None, None)
        K, N, L = map_capacity
        self.state = ms.empty_map(K=K, N=N, L=L, D=desc_dim, device=self.device)
        self.loop_closer = None
        self.mesh = mesh
        if enable_loop_closing:
            self.loop_closer = LoopCloser(self.cam_params, K, desc_dim, config=loop_config,
                                          matcher=matcher, mesh=mesh, device=self.device)
        self.loop_events = []         # (query kf, info) of every fired loop
        self.tracking_state = T.NO_IMAGES_YET
        self.velocity = None
        self.last_frame: Optional[T.FrameData] = None
        self.init_frame: Optional[T.FrameData] = None
        self.ref_kf_tracked = 0
        self.frames_since_kf = 0
        self.n_kf = 0
        self.timers = StageTimers()
        # Trajectory log: (time, R_cw, t_cw, state, ref_uid, R_cr, t_cr); the
        # pose relative to the reference keyframe is recomposed at save time
        # so later map corrections reach the whole history.
        self.trajectory = []
        self._generator = torch.Generator().manual_seed(7)
        # Keyframe identity across slot recycling: _uid_of_slot maps a live
        # slot to its uid; _kf_redirect holds, for every culled keyframe, its
        # pose relative to its surviving spanning-tree ancestor at cull time.
        self._next_uid = 0
        self._uid_of_slot = np.full((K,), -1, np.int64)
        self._kf_redirect = {}        # uid -> (parent_uid, R_cp, t_cp)
        self._pending_cull_red = None  # HostCopy of the cull redirect arrays
        self._n_lm_used = 0
        self._kf_compact_guard = 0    # back-off (frames) after a relief
        self._lm_compact_guard = 0    # attempt that freed nothing
        self._local_mask = None       # [L] local-map search mask
        self._kf_scalars = None       # HostCopy of the last insert's scalars
        # Pipeline mode: the device policy carry; compaction waits for a
        # flush boundary because it renumbers slots in-flight frames hold.
        self._policy = None
        self._compact_requested = False
        self._finishing_frame = None
        # Lifecycle counters, for the caller's statistics.
        self.reloc_attempts = 0
        self.reloc_successes = 0
        self.compactions = 0
        self._force_kf = False
        self._last_n_inl = 0
        self._lost_frames = 0
        self._lost_since = 0.0
        self._last_full_ok = 0.0

    # ------------------------------------------------------------------
    def track_frame(self, kpts, rays, desc, valid, time) -> dict:
        """Process one frame (arrays shaped [N, ...]). Returns tracking info
        (in pipeline mode, of the frame finished now, K frames back). The
        spans the frame opens, the loop closer's included, keep their host
        samples in self.timers.samples."""
        with profiling.frame_sink(self.timers.samples):
            return self._track_frame(kpts, rays, desc, valid, time)

    def _track_frame(self, kpts, rays, desc, valid, time) -> dict:
        dev = self.device
        frame = T.FrameData(torch.as_tensor(kpts, device=dev).float(),
                            torch.as_tensor(rays, device=dev).float(),
                            torch.as_tensor(desc, device=dev).float(),
                            torch.as_tensor(valid, device=dev).bool(), float(time))
        sd = getattr(self, "_stereo_depth", None)
        if sd is not None and self.bf is not None:
            # Stereo observation: inverse depth per keypoint (the reference
            # keeps mvuRight / mvDepth on the Frame).
            frame.invd = torch.where(sd > 0, 1.0 / torch.clamp(sd, min=1e-6), -1.0)
        # Subclass hook: per-frame context that the (possibly deferred)
        # finish needs, stashed at dispatch.
        self._prepare_frame(frame)
        # Timestamp gap or step back: finish the old timeline, then continue
        # in a fresh Atlas map (reference CreateMapInAtlas on a dt jump).
        if (self.cfg.timestamp_jump_s > 0 and self.last_frame is not None
                and self.tracking_state in (T.OK, T.RECENTLY_LOST)
                and (float(time) < self.last_frame.time - 1e-6
                     or float(time) - self.last_frame.time > self.cfg.timestamp_jump_s)):
            self.flush()
            if self.tracking_state in (T.OK, T.RECENTLY_LOST):
                self._on_tracking_lost(frame)
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

        if self._compact_requested:
            self.flush()
            self._compact_requested = False
            self._relieve_capacity()

        # Past warm-up a pipelined frame finishes K frames later; its keyframe
        # decision and insert run inside its device program only where the
        # system allows it (_fused_mapping_ok), else on the host at finish.
        deferred = self.pipeline and self.n_kf >= self.pipeline_warmup_kfs
        fused = deferred and self._fused_mapping_ok()
        with self.timers.stage("lm_track"):
            R0, t0 = self._predict_pose()
            prev = self.last_frame
            prev_lidx = prev.landmark_idx if prev.landmark_idx is not None \
                else torch.full((self.state.N,), -1, dtype=torch.int32, device=dev)
            ext_matches = None
            if self.matcher is not None:
                with profiling.span("track.match"):
                    ext_matches = self.matcher(prev.kpts, prev.desc, prev.valid,
                                               frame.kpts, frame.desc, frame.valid)
            cfg = self.cfg
            if fused:
                if self._policy is None:
                    self._policy = torch.tensor(
                        [float(self.frames_since_kf), float(self.ref_kf_tracked), 0.0],
                        device=dev)
                mask = self._local_mask if self._local_mask is not None \
                    else self.state.lm_active
                (self.state, self._policy, self._local_mask,
                 R2, t2, cur_lm, flags) = self._dispatch_fused(
                    self.state, self._policy, mask, prev, prev_lidx, frame, R0, t0,
                    ext_matches, self._bf_arr())
                frame.fused = True
            else:
                R2, t2, cur_lm, flags = T._track_step_body(
                    self.state, prev.desc, prev.valid, prev_lidx,
                    frame.kpts, frame.desc, frame.valid, R0, t0,
                    self.cam_params, cfg.cam_kind, cfg.image_hw,
                    cfg.min_matches_motion, cfg.min_inliers_track,
                    cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2,
                    ref_kf=torch.tensor(max(self.n_kf - 1, 0), dtype=torch.int32,
                                        device=dev),
                    local_map_only=cfg.local_map_only, ext_matches=ext_matches,
                    max_depth=cfg.th_far_points, min_matches_ref_kf=cfg.min_matches_ref_kf,
                    motion_rounds=cfg.motion_rounds, motion_iters=cfg.motion_iters,
                    local_rounds=cfg.local_rounds, local_iters=cfg.local_iters,
                    local_mask=self._local_mask, min_inliers_weak=cfg.min_inliers_weak,
                    cur_invd=frame.invd, bf=self._bf_arr())
            frame.R_cw, frame.t_cw, frame.landmark_idx = R2, t2, cur_lm
        flags = HostCopy(flags)

        if deferred:
            # The flags ride to the host behind the queued work and are read
            # K frames later; the motion model takes the device values now.
            self._pending.append((frame, flags))
            self._update_motion_model(frame)
            self.last_frame = frame
            self.frames_since_kf += 1
            info_prev = None
            while len(self._pending) > self.pipeline_depth:
                info_prev = self._finish_track(*self._pending.popleft())
            return info_prev if info_prev is not None else \
                {"state": self.tracking_state, "queued": True}

        info = self._finish_track(frame, flags)
        self.last_frame = frame
        self.frames_since_kf += 1
        return info

    def _finish_track(self, frame: T.FrameData, flags: HostCopy) -> dict:
        """State machine, relocalization and keyframe decision from the
        frame's flags."""
        # A compaction fired from the keyframe decision must remap this
        # frame's landmark ids too: it is in neither _pending nor last_frame.
        self._finishing_frame = frame
        self._on_frame_finish(frame)
        with self.timers.stage("flags_fetch"):
            flags = flags.numpy()
        ok = bool(flags[0])
        self._last_n_inl = int(flags[1])
        weak = bool(flags[4])
        if ok:
            # Only a fully tracked frame resets the survival clock.
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
                ok = self._relocalize(frame)
            if (not ok and self.tracking_state == T.RECENTLY_LOST
                    and (frame.time - self._lost_since > self.cfg.time_recently_lost_s
                         or frame.time - self._last_full_ok > self.cfg.time_recently_lost_s)):
                # Grace window over: LOST, then reset or a new Atlas map.
                self.tracking_state = T.LOST
                self._on_tracking_lost(frame)
        else:
            self._lost_frames = 0
            self.tracking_state = T.OK
            self._post_track_refine(frame)
            if not self.pipeline:
                self._update_motion_model(frame)

        self._log_pose(frame)
        if frame.fused:
            # The device already decided and ran the insert; reconcile.
            self._force_kf = False
            if ok and flags[5]:
                self._on_fused_insert(int(flags[1]))
            self._n_lm_used = int(flags[7])
            self._check_capacity_pressure(int(flags[6]))
        elif ok and self._need_new_keyframe(frame):
            with self.timers.stage("new_kf"):
                self._insert_keyframe(frame)
        self._finishing_frame = None
        self._poll_loop_closer()
        return {"state": self.tracking_state, "n_inliers": self._last_n_inl,
                "pose": (frame.R_cw, frame.t_cw)}

    def _relocalize(self, frame: T.FrameData) -> bool:
        """Global relocalization (reference Relocalization after the
        RECENTLY_LOST grace): with a learned matcher, PnP over one batched
        match against candidate keyframes, else a mutual-NN match against
        the whole landmark table. Only a strong result (min_reloc_inliers)
        is accepted: a spurious one poisons the motion model."""
        self.reloc_attempts += 1
        with self.timers.stage("reloc"):
            ext = self._reloc_candidates_matches(frame)
            if ext is not None:
                Rr, tr, lm_r, ok_r, n_r = T._reloc_from_kf_matches(
                    self.state, *ext, frame.kpts, frame.desc, frame.valid,
                    self.cam_params, self._generator, self.cfg.cam_kind)
            else:
                Rr, tr, lm_r, ok_r, n_r = T._relocalize_kernel(
                    self.state, frame.kpts, frame.desc, frame.valid, self.cam_params,
                    self._generator, self.cfg.cam_kind)
            if not (bool(ok_r) and int(n_r) >= self.cfg.min_reloc_inliers):
                return False
        self.reloc_successes += 1
        frame.R_cw, frame.t_cw, frame.landmark_idx = Rr, tr, lm_r
        self.tracking_state = T.OK
        self._last_full_ok = frame.time
        self._last_n_inl = int(n_r)
        self.velocity = None
        self._lost_frames = 0
        return True

    def _reloc_candidates_matches(self, frame, n_cand: int = 3):
        """With a learned matcher that batches: n_cand candidate keyframes
        (place recognition when loop closing is on, else the most recent
        ones), padded with the first to a fixed batch, and ONE batched match
        of the lost frame against them. Returns (cand_ids [B], matches
        [B, N]) or None (global landmark-table relocalization)."""
        if self.matcher is None or not hasattr(self.matcher, "match_batch"):
            return None
        if self.loop_closer is not None and self.n_kf >= 1:
            db = self.loop_closer.db
            tf = kdb.bow_transform(db.vocab, frame.desc, frame.valid)
            none_conn = torch.zeros((self.state.K,), dtype=torch.bool, device=self.device)
            ids, _ = kdb.detect_candidates(db, tf, self.n_kf - 1, none_conn, n_best=n_cand)
            ids = [int(i) for i in ids.cpu().numpy() if 0 <= i < self.n_kf]
        else:
            ids = [i for i in range(self.n_kf - 1, self.n_kf - 1 - n_cand, -1) if i >= 0]
        if not ids:
            return None
        ids += [ids[0]] * (n_cand - len(ids))
        idc = torch.tensor(ids, dtype=torch.int32, device=self.device)
        jc = idc.long()
        st = self.state
        B = len(ids)
        ext = self.matcher.match_batch(
            st.kf_kpts[jc], st.kf_desc[jc].float(), st.kf_kpt_valid[jc],
            frame.kpts.expand(B, -1, -1), frame.desc.expand(B, -1, -1),
            frame.valid.expand(B, -1))
        return idc, ext

    def _on_tracking_lost(self, frame):
        """LOST after the grace window: a young active map (fewer than
        min_kfs_keep_map keyframes) is discarded, a mature one is kept in the
        Atlas; either way tracking restarts in a fresh map. In-flight frames
        tracked the old map: their poses are logged, their state machine is
        skipped."""
        st = self.state
        in_map = st.kf_active & (st.kf_map_id == st.active_map_id)
        in_map_np = in_map.cpu().numpy()
        if int(in_map_np.sum()) < self.cfg.min_kfs_keep_map:
            st = st.replace(kf_active=st.kf_active & ~in_map,
                            kf_landmark_idx=torch.where(in_map[:, None], -1,
                                                        st.kf_landmark_idx))
            st = ms.remove_landmarks(st, st.lm_active & (st.lm_map_id == st.active_map_id))
            # The discarded map's keyframe uids are dead: their frames keep
            # their absolute poses.
            self._resolve_cull_redirects()
            self._uid_of_slot[in_map_np] = -1
        self.state = atlas.create_new_map(st)
        self._local_mask = None
        self._policy = None
        self.tracking_state = T.NO_IMAGES_YET
        self.init_frame = None
        self.velocity = None
        self._lost_frames = 0
        for pf, _ in self._pending:
            self._log_pose(pf)
        self._pending.clear()
        self._kf_scalars = None

    def flush(self):
        """Finish every in-flight frame (pipeline mode). Call before reading
        final trajectories or state."""
        info = None
        while self._pending:
            info = self._finish_track(*self._pending.popleft())
        if self.loop_closer is not None and self.n_kf >= 2:
            self.state, linfo = self.loop_closer.finalize(self.state)
            if linfo is not None:
                self._handle_loop_info(linfo.get("query_kf", self.n_kf - 1), linfo)
        return info

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
        if not self._ensure_kf_capacity(need=2):
            return False
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
        self._assign_uid(base)
        self._assign_uid(base + 1)
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
        # The init keyframes bypass the insert path: add them to the
        # place-recognition database here.
        self._register_init_kf_in_db(base)
        self._register_init_kf_in_db(base + 1)
        return True

    def _register_init_kf_in_db(self, kf_id: int):
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.db = kdb.db_add(lc.db, kf_id, self.state.kf_desc[kf_id].float(),
                               self.state.kf_kpt_valid[kf_id])

    def _predict_pose(self):
        """Constant-velocity motion model."""
        R1, t1 = self.last_frame.R_cw, self.last_frame.t_cw
        if self.velocity is None:
            return R1, t1
        dR, dt = self.velocity
        return T._compose_pose(dR, dt, R1, t1)

    def _prepare_frame(self, frame):
        """Hook: attach per-frame context at dispatch, before the frame may
        enter the pipeline queue."""

    def _on_frame_finish(self, frame):
        """Hook: once per frame at finish, before the state machine."""

    def _post_track_refine(self, frame):
        """Hook: refine a tracked frame's pose before the motion model and
        the keyframe decision."""

    def _fused_mapping_ok(self) -> bool:
        """Whether pipeline mode may run the keyframe decision and insert
        inside the frame's device program."""
        return True

    def _on_map_merged(self, kf_id: int, info: dict):
        """Hook: a cross-map weld just happened (after the welding BA)."""

    def _on_compaction(self, kf_old2new: np.ndarray):
        """Hook: slot compaction renumbered the keyframes (kf_old2new [K],
        -1 for a dropped slot)."""

    def _update_motion_model(self, frame):
        self.velocity = T._relative_pose(self.last_frame.R_cw, self.last_frame.t_cw,
                                         frame.R_cw, frame.t_cw)

    # ------------------------------------------------------------------
    def _bf_arr(self):
        """bf as a float32 scalar tensor on the device (None for mono), made
        once per value."""
        if self._bf_cache[0] != self.bf:
            self._bf_cache = (self.bf, None if self.bf is None else
                              torch.tensor(self.bf, dtype=torch.float32, device=self.device))
        return self._bf_cache[1]

    def _dispatch_fused(self, state, policy, mask, prev, prev_lidx, frame, R0, t0,
                        ext_matches, bf=None):
        """The fused track+map program (shared by the product path and
        precompile)."""
        cfg = self.cfg
        return T._track_and_map_body(
            state, policy, mask, prev.desc, prev.valid, prev_lidx,
            frame.kpts, frame.rays, frame.desc, frame.valid, R0, t0, frame.time,
            self.cam_params, cfg.cam_kind, cfg.image_hw, cfg.min_matches_motion,
            cfg.min_inliers_track, cfg.min_inliers_local_map, cfg.proj_radius,
            cfg.desc_th2, float(cfg.kf_tracked_ratio), float(cfg.kf_min_interval),
            float(cfg.kf_max_interval), cfg.local_window, cfg.fixed_window, cfg.ba_iters,
            local_map_only=cfg.local_map_only, ext_matches=ext_matches,
            max_depth=cfg.th_far_points, min_matches_ref_kf=cfg.min_matches_ref_kf,
            motion_rounds=cfg.motion_rounds, motion_iters=cfg.motion_iters,
            local_rounds=cfg.local_rounds, local_iters=cfg.local_iters,
            min_inliers_weak=cfg.min_inliers_weak, ba_every=cfg.ba_every,
            cur_invd=frame.invd, bf=bf)

    def precompile(self):
        """Run the steady-state paths once on a copy of the state before a
        timed region: the kernel builds, cuBLAS/cuDNN plans and allocator
        pools of the fused track+map program (pipeline mode), of the loop
        closer's programs and of relocalization. Call after bootstrap (needs
        a tracked frame)."""
        if self.device.type == "cuda":
            _build.build()
            for name in _build.SOURCES:
                _build.load(name)
        prev = self.last_frame
        if prev is None or prev.R_cw is None:
            return
        state_c = ms.MapState(**{k: getattr(self.state, k).clone() for k in ms.FIELDS})
        prev_lidx = prev.landmark_idx if prev.landmark_idx is not None \
            else torch.full((self.state.N,), -1, dtype=torch.int32, device=self.device)
        if self.pipeline and self._fused_mapping_ok():
            policy = torch.tensor([0.0, float(self.ref_kf_tracked), 0.0], device=self.device)
            ext = None
            if self.matcher is not None:
                ext = self.matcher(prev.kpts, prev.desc, prev.valid,
                                   prev.kpts, prev.desc, prev.valid)
            self._dispatch_fused(state_c, policy, state_c.lm_active.clone(), prev, prev_lidx,
                                 prev, prev.R_cw, prev.t_cw, ext, self._bf_arr())
        if self.loop_closer is not None:
            self.loop_closer.precompile(state_c)
        if self.n_kf >= 2:
            gen = torch.Generator().manual_seed(0)   # leaves the run's draws alone
            ext = self._reloc_candidates_matches(prev)
            if ext is not None:
                T._reloc_from_kf_matches(state_c, *ext, prev.kpts, prev.desc, prev.valid,
                                         self.cam_params, gen, self.cfg.cam_kind)
            else:
                T._relocalize_kernel(state_c, prev.kpts, prev.desc, prev.valid,
                                     self.cam_params, gen, self.cfg.cam_kind)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_fused_insert(self, n_inl: int):
        """Host bookkeeping for a keyframe the device already inserted."""
        with self.timers.stage("new_kf"):
            self._assign_uid(self.n_kf)
            self.n_kf += 1
            self.frames_since_kf = 0
            self.ref_kf_tracked = max(n_inl, 20)
            self._post_insert_hooks(self.n_kf - 1)

    def _check_capacity_pressure(self, n_kf_dev: int):
        """Pipeline mode: ask for a compaction at the next flush boundary
        when the lagged device counters show table pressure (the device
        guard stops inserts before an overflow)."""
        if (self._n_lm_used >= self.state.L - (3 * self.state.N + 64)
                or n_kf_dev >= self.state.K - 2):
            self._compact_requested = True

    def _relieve_capacity(self):
        """Compaction and cull passes against table pressure (inline in sync
        mode, at flush boundaries in pipeline mode)."""
        lm_headroom = 3 * self.state.N + 64
        if self._lm_compact_guard > 0:
            self._lm_compact_guard -= 1
        if (self._n_lm_used >= self.state.L - lm_headroom
                and self._lm_compact_guard <= 0):
            self._compact_map()
            if self._n_lm_used >= self.state.L - lm_headroom:
                self.state = maintenance.cull_landmarks(
                    self.state, min_found_ratio=0.1, min_obs=2, min_age_kf=2)
                self._compact_map()
            if self._n_lm_used >= self.state.L - lm_headroom:
                self._lm_compact_guard = 20
        self._ensure_kf_capacity(need=1)

    def _need_new_keyframe(self, frame) -> bool:
        """(reference NeedNewKeyFrame: the c1/c2 policy on the tracker's
        inlier decay from its peak since the last insert)."""
        if self._kf_scalars is not None:
            self._n_lm_used = int(self._kf_scalars.numpy()[5])
            self._kf_scalars = None
        self._relieve_capacity()
        if self.n_kf >= self.state.K:
            return False
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
            with profiling.span("insert.tri_match"):
                # Learned triangulation matches: the top-2 covisible
                # neighbours, then ONE batched match for both pairs.
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
            run_ba=run_ba, ext_tri_ids=ext_ids, ext_tri_matches=ext_tri,
            kpt_invd=frame.invd, bf=self._bf_arr())
        self._assign_uid(self.n_kf)
        self.n_kf += 1
        self.frames_since_kf = 0
        self.ref_kf_tracked = max(self._last_n_inl, 20)
        # Read by the next keyframe decision (n_lm for the capacity check).
        self._kf_scalars = HostCopy(scalars)
        self._post_insert_hooks(self.n_kf - 1)

    def _post_insert_hooks(self, kf_id: int):
        """Per-keyframe follow-up of both insert paths: the cull cadence,
        then the loop closer."""
        if (self.cfg.kf_cull_every > 0 and self.n_kf >= 6
                and self.n_kf % self.cfg.kf_cull_every == 0):
            self.state, _, redirect = maintenance.cull_keyframes_ex(
                self.state, redundancy=self.cfg.kf_cull_redundancy)
            self._record_cull_redirects(redirect)
        if self.loop_closer is not None:
            with self.timers.stage("place_recog"):
                self.state, linfo = self.loop_closer.on_keyframe(self.state, kf_id)
            self._handle_loop_info(kf_id, linfo)

    def _handle_loop_info(self, kf_id: int, linfo):
        if linfo and linfo.get("loop"):
            # Landmarks moved and were fused: rebuild the search mask.
            self._local_mask = None
            self.loop_events.append((kf_id, linfo))
        if linfo and linfo.get("merge"):
            self._on_map_merged(kf_id, linfo)

    def _poll_loop_closer(self):
        """Per-frame progress of the loop closer; never waits on the card."""
        if self.loop_closer is None or self.n_kf < 2:
            return
        with self.timers.stage("place_recog"):
            self.state, linfo = self.loop_closer.poll(self.state)
        if linfo is not None:
            self._handle_loop_info(linfo.get("query_kf", self.n_kf - 1), linfo)

    # ------------------------------------------------------------------
    def _log_pose(self, frame):
        ref_uid, R_cr, t_cr = -1, None, None
        if self.n_kf >= 1 and frame.R_cw is not None:
            ref_slot = self.n_kf - 1
            ref_uid = int(self._uid_of_slot[ref_slot])
            R_cr, t_cr = T._rel_to_kf(self.state, frame.R_cw, frame.t_cw, ref_slot)
        self.trajectory.append((frame.time, frame.R_cw, frame.t_cw,
                                self.tracking_state, ref_uid, R_cr, t_cr))

    def get_trajectory(self, reconstitute: bool = True):
        """Final trajectory (times, R_cw [F,3,3], t_cw [F,3]) as numpy arrays.
        reconstitute=True composes each frame's logged pose relative to its
        reference keyframe with that keyframe's current pose, chaining
        through cull-time redirects for culled keyframes; a frame whose chain
        died (a discarded map) keeps its absolute logged pose."""
        self.flush()
        self._resolve_cull_redirects()
        if not self.trajectory:
            return np.zeros((0,)), np.zeros((0, 3, 3)), np.zeros((0, 3))
        times = np.array([e[0] for e in self.trajectory])
        Rs = np.stack([e[1].cpu().numpy() for e in self.trajectory])
        ts = np.stack([e[2].cpu().numpy() for e in self.trajectory])
        if not reconstitute:
            return times, Rs, ts
        kf_R = self.state.kf_R_cw.cpu().numpy()
        kf_t = self.state.kf_t_cw.cpu().numpy()
        slot_of_uid = {int(u): s for s, u in enumerate(self._uid_of_slot) if u >= 0}
        for i, (_, _, _, _, uid, R_cr, t_cr) in enumerate(self.trajectory):
            if uid < 0 or R_cr is None:
                continue
            R_cr = R_cr.cpu().numpy()
            t_cr = t_cr.cpu().numpy()
            depth = 0
            while uid >= 0 and uid not in slot_of_uid and depth < 256:
                red = self._kf_redirect.get(uid)
                if red is None:
                    uid = -1
                    break
                uid, R_rp, t_rp = red
                # T_cr' = T_cr * T_rp: chain through the culled keyframe.
                t_cr = R_cr @ t_rp + t_cr
                R_cr = R_cr @ R_rp
                depth += 1
            if uid < 0 or uid not in slot_of_uid:
                continue
            s = slot_of_uid[uid]
            Rs[i] = R_cr @ kf_R[s]
            ts[i] = R_cr @ kf_t[s] + t_cr
        return times, Rs, ts

    # ------------------------------------------------------------------
    # Keyframe identity and slot lifecycle
    # ------------------------------------------------------------------
    def _assign_uid(self, slot: int):
        self._uid_of_slot[slot] = self._next_uid
        self._next_uid += 1

    def _record_cull_redirects(self, redirect):
        """Start the redirect arrays' copy to the host; read at the next
        resolve (no blocking fetch on the cull cadence)."""
        self._resolve_cull_redirects()
        self._pending_cull_red = [HostCopy(a) for a in redirect]

    def _resolve_cull_redirects(self):
        if self._pending_cull_red is None:
            return
        cull, surv, R_cp, t_cp = [a.numpy() for a in self._pending_cull_red]
        self._pending_cull_red = None
        for s in np.nonzero(cull)[0]:
            uid = int(self._uid_of_slot[s])
            if uid < 0:
                continue
            p = int(surv[s])
            p_uid = int(self._uid_of_slot[p]) if p >= 0 else -1
            self._kf_redirect[uid] = (p_uid, R_cp[s].copy(), t_cp[s].copy())
            self._uid_of_slot[s] = -1

    def _ensure_kf_capacity(self, need: int = 1) -> bool:
        """Free keyframe slots when the table is near full: compact first;
        when that frees nothing, cull redundant keyframes, and when nothing
        is redundant shed the oldest ones (a fixed table must bound its
        working set; the reference's maps grow without bound). A failed
        attempt backs off 20 frames."""
        if self._kf_compact_guard > 0:
            self._kf_compact_guard -= 1
        K = self.state.K
        if self.n_kf + need <= K:
            return True
        if self._kf_compact_guard > 0:
            return False
        self._compact_map()
        if self.n_kf + need > K:
            st, n_c, redirect = maintenance.cull_keyframes_ex(
                self.state, redundancy=self.cfg.kf_cull_redundancy)
            if int(n_c) == 0:
                st, n_c, redirect = maintenance.cull_oldest_ex(
                    self.state, n_free=max(2, need, K // 8),
                    protect_recent=min(16, K // 2))
            if int(n_c) > 0:
                self.state = st
                self._record_cull_redirects(redirect)
                self._compact_map()
        if self.n_kf + need > K:
            self._kf_compact_guard = 20
            return False
        return True

    def _compact_map(self):
        """Pack live keyframe and landmark slots to the front of the tables
        and remap every host-side reference: the uid table, and the landmark
        ids held by in-flight, last and finishing frames."""
        self.compactions += 1
        self._resolve_cull_redirects()
        if self._kf_scalars is not None:
            self.ref_kf_tracked = int(self._kf_scalars.numpy()[3])
            self._kf_scalars = None
        st, kf_o2n, lm_o2n = ms.compact_map(self.state)
        kf_map = kf_o2n.cpu().numpy()
        self.state = st
        self._local_mask = None       # landmark ids were renumbered
        new_uid = np.full_like(self._uid_of_slot, -1)
        live = kf_map >= 0
        new_uid[kf_map[live]] = self._uid_of_slot[live]
        self._uid_of_slot = new_uid
        self.n_kf = int(live.sum())
        self._n_lm_used = int(st.n_lm)
        frames = [p[0] for p in self._pending] + [self.last_frame, self._finishing_frame]
        seen = set()
        for f in frames:
            if f is None or id(f) in seen or f.landmark_idx is None:
                continue
            seen.add(id(f))
            f.landmark_idx = ms.remap_landmark_refs(f.landmark_idx, lm_o2n)
        if self.loop_closer is not None:
            # The database rows and the open hypothesis follow the slots;
            # queued packs hold old slot ids and are dropped.
            lc = self.loop_closer
            olds = np.nonzero(live)[0]
            perm = np.zeros((self.state.K,), np.int64)
            perm[:len(olds)] = olds
            new_live = np.arange(self.state.K) < len(olds)
            lc.db = kdb.db_permute(lc.db, torch.as_tensor(perm, device=self.device),
                                   torch.as_tensor(new_live, device=self.device))
            lc.on_compaction()
            hyp = lc._hyp
            if hyp is not None:
                c, q = int(kf_map[hyp["cand"]]), int(kf_map[hyp["q_last"]])
                if c < 0 or q < 0:
                    lc._hyp = None
                else:
                    hyp["cand"], hyp["q_last"] = c, q
        self._on_compaction(kf_map)


def frame_inliers(frame) -> int:
    """Keypoints of a tracked frame associated with a landmark (0 before the
    frame has associations)."""
    return int((frame.landmark_idx >= 0).sum()) if frame.landmark_idx is not None else 0
