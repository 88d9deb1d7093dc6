"""Monocular-inertial SLAM (the reference's IMU_MONOCULAR mode).

Counterpart of rover_slam_tpu/slam/inertial_system.py
(`MonocularInertialSLAM`). Extends the port's MonocularSLAM: each frame's IMU
samples are preintegrated, the pose prediction propagates the IMU once it is
initialized, keyframes close preintegration segments, and after the
inertial initialization (gravity and metric scale, then the world aligned
and a full-window VI-BA) every tracked frame is refined jointly with its
velocity and biases (`optim/pose_inertial.py`) and every few keyframes a
temporal-window VI-BA runs (`optim/vi_ba.py`). Loop corrections switch to the
4-DoF pose graph once gravity is aligned.

Keyframe inserts stay on the host (`_fused_mapping_ok` is False): with
pipeline=K a frame's finish, its keyframe decision and insert included, runs
K frames after its dispatch, as in the JAX package. The preintegration
segment and the predicted velocity ride on the frame, so the finish-time
refinement and the keyframe chain see the frame's own IMU window. With
`bf` set (slam/stereo_inertial.py) the frame's and keyframes' stereo inverse
depths add the third residual row to both inertial solvers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry import lie
from ..imu import preintegration as preint
from ..map import map_state as ms
from ..ops import scatterless
from ..optim import inertial_init as ii
from ..optim import pose_inertial as pio
from ..optim import vi_ba as vi_ba_mod
from . import tracking as T
from .system import MonocularSLAM

MAX_IMU_PER_FRAME = 64
_SEG_FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt", "bg", "ba")


def _stack_segments(segs, n_pad: int):
    """The preintegration arrays of a window's segments (VIBAProblem's imu_*
    order), each with n_pad + 1 zero rows appended; the 9x9 informations with
    a non-finite one (a singular covariance) zeroed, since the solvers mask
    edges by multiplication; and the validity of each row's dt."""
    out = []
    for f in _SEG_FIELDS:
        rows = torch.stack([getattr(s, f) for s in segs])
        out.append(torch.cat([rows, torch.zeros((n_pad + 1,) + rows.shape[1:],
                                                dtype=rows.dtype, device=rows.device)]))
    info = preint.information_9(preint.PreintState(
        *(torch.stack([getattr(s, f) for s in segs]) for f in preint.PreintState._fields)))
    info = torch.where(torch.isfinite(info).all(dim=-1).all(dim=-1)[:, None, None], info, 0.0)
    info = torch.cat([info, torch.zeros((n_pad + 1, 9, 9), device=info.device)])
    return out, info, out[_SEG_FIELDS.index("dt")] > 1e-6


def _predict_imu_kernel(R_wb, p_wb, v_wb, state: preint.PreintState, bg, ba, R_bc, t_bc):
    """IMU propagation and the predicted camera pose T_cw = T_cb T_bw
    (reference PredictStateIMU)."""
    R1, p1, v1 = preint.predict_state(R_wb, p_wb, v_wb, state, bg, ba)
    R_cb, t_cb = lie.se3_inverse(R_bc, t_bc)
    R_cw = R_cb @ R1.T
    return R1, p1, v1, R_cw, -R_cw @ p1 + t_cb


def _body_from_camera(R_cw, t_cw, R_bc, t_bc):
    """Body pose T_wb from the camera pose T_cw and the extrinsic T_bc
    (batched over leading dims). Camera poses are the map's source of truth;
    body poses are derived whenever the IMU factors need them."""
    R_wb = torch.einsum("ij,...jl->...il", R_bc, R_cw).transpose(-1, -2)
    centers = -torch.einsum("...ji,...j->...i", R_cw, t_cw)
    return R_wb, centers - torch.einsum("...ij,j->...i", R_wb, t_bc)


def _set_body_state_kernel(state: ms.MapState, kf_id: int, R_cw, t_cw, R_bc, t_bc,
                           v_wb, bg, ba) -> ms.MapState:
    """Write one keyframe's body state (at insertion: the VI-BA window needs
    its velocity and bias snapshots)."""
    R_wb, p_wb = _body_from_camera(R_cw, t_cw, R_bc, t_bc)
    out = {}
    for name, val in (("kf_R_wb", R_wb), ("kf_p_wb", p_wb), ("kf_v_wb", v_wb),
                      ("kf_bg", bg), ("kf_ba", ba)):
        arr = getattr(state, name).clone()
        arr[kf_id] = val
        out[name] = arr
    return state.replace(**out)


def _apply_alignment_kernel(state: ms.MapState, Rwg, scale, v_all, bg, ba, R_bc, t_bc):
    """Rotate and scale the whole map after the IMU initialization
    (reference Map::ApplyScaledRotation + UpdateFrameIMU); body states are
    derived again from the aligned camera poses."""
    R_cw = torch.einsum("kij,jl->kil", state.kf_R_cw, Rwg)
    t_cw = scale * state.kf_t_cw
    R_wb, p_wb = _body_from_camera(R_cw, t_cw, R_bc, t_bc)
    K = state.K
    return state.replace(
        kf_R_cw=R_cw, kf_t_cw=t_cw, kf_R_wb=R_wb, kf_p_wb=p_wb,
        kf_v_wb=torch.einsum("ij,kj->ki", Rwg.T, v_all),
        kf_bg=bg[None].expand(K, 3).clone(), kf_ba=ba[None].expand(K, 3).clone(),
        lm_pos=scale * torch.einsum("ij,lj->li", Rwg.T, state.lm_pos))


class MonocularInertialSLAM(MonocularSLAM):
    """Monocular + IMU. Call `feed_imu(acc, gyro, t)` between frames."""

    def __init__(self, cam_params, imu_calib, tinit_s: float = 2.0, vi_ba_every: int = 4,
                 refine_every: int = 10, vi_ba_iters: int = 6,
                 vi_ba_reproj_info: float = 4.0, vi_ba_walk_scale: float = 0.01, **kw):
        """imu_calib: an ImuCalib (or any object with its fields, numpy
        arrays included). vi_ba_every: temporal-window VI-BA every N
        keyframes (0 = off). vi_ba_reproj_info: information (1/sigma_px^2)
        of the VI-BA's reprojection edges. vi_ba_walk_scale: scaling of the
        bias random-walk information. Other arguments as MonocularSLAM's."""
        super().__init__(cam_params, **kw)
        if self.cfg.time_recently_lost_s == T.TrackerConfig.time_recently_lost_s:
            # The IMU keeps predictions usable longer: the reference's
            # RECENTLY_LOST window is 5 s with an IMU against 2 s visual.
            self.cfg.time_recently_lost_s = 5.0
        self.vi_ba_every = vi_ba_every
        self.vi_ba_iters = vi_ba_iters
        self.vi_ba_reproj_info = vi_ba_reproj_info
        self.vi_ba_walk_scale = vi_ba_walk_scale
        self.refine_every = refine_every
        self.calib = preint.calib_from_numpy(imu_calib, self.device)
        # The random-walk information in Python doubles, as the JAX package
        # computes it.
        walk_g, walk_a = (float(preint.as_numpy(getattr(imu_calib, f)))
                          for f in ("walk_g", "walk_a"))
        self._walk_info = torch.tensor([1.0 / walk_g ** 2] * 3 + [1.0 / walk_a ** 2] * 3,
                                       dtype=torch.float32, device=self.device)
        self.tinit_s = tinit_s
        self.pre_init_kf_dt = 0.0   # min keyframe spacing (s) before the init
        self.viba1_dt = 5.0         # VIBA1 at t_init + 5 s, priors (1, 1e5)
        self.viba2_dt = 15.0        # VIBA2 at t_init + 15 s, priors (0, 0)
        self._init_stage = 0        # 0 no IMU, 1 init done, 2 VIBA1, 3 VIBA2
        self._t_imu_init = 0.0
        # Minimum time span of an inertial edge in the init problem: the
        # chain subsamples keyframes and merges the segments between picks.
        self.init_edge_dt = 0.25
        self.imu_ready = False
        self._imu_buf = []
        self._last_frame_time = None
        dev = self.device
        self.R_wb = torch.eye(3, device=dev)
        self.p_wb = torch.zeros(3, device=dev)
        self.v_wb = torch.zeros(3, device=dev)
        self.bg = torch.zeros(3, device=dev)
        self.ba = torch.zeros(3, device=dev)
        # _kf_preints[j] links keyframe (_kf_base + j) -> (_kf_base + j + 1);
        # the buffer restarts with each Atlas map.
        self._kf_preints: list = []
        self._kf_base = 0
        self._preint_since_kf: Optional[preint.PreintState] = None
        self.vi_ba_enabled = False
        self._last_refine_kf = 0
        # The frame-to-frame marginal prior; None right after a keyframe (the
        # next frame anchors on it, LastKeyFrame mode).
        self._vi_prior_H = None
        self._vi_refined = False
        self._cur_preint = None
        self._pred_body = None
        # Finish-side body state of the last finished frame (pipeline mode);
        # None = reseed from the next finished frame.
        self._fin_body = None
        # Counters for the caller's statistics.
        self.vi_refines = 0
        self.vi_ba_runs = 0
        self.imu_init_time = None   # time of the frame that saw the init
        self.scale_log = []         # ("init" or "refine", scale) of each alignment

    # ------------------------------------------------------------------
    def feed_imu(self, acc, gyro, t):
        self._imu_buf.append((np.asarray(acc, np.float32), np.asarray(gyro, np.float32),
                              float(t)))

    def _preintegrate_window(self):
        """Preintegrate the samples buffered since the last frame (reference
        PreintegrateIMU): at most MAX_IMU_PER_FRAME of them, the real ones
        only (the JAX package's masked padding leaves the state unchanged)."""
        buf = self._imu_buf[:MAX_IMU_PER_FRAME]
        self._imu_buf = []
        n = len(buf)
        accs = np.zeros((n, 3), np.float32)
        gyros = np.zeros((n, 3), np.float32)
        dts = np.zeros((n,), np.float32)
        t_prev = self._last_frame_time
        for i, (a, g, t) in enumerate(buf):
            accs[i], gyros[i] = a, g
            dts[i] = max(t - t_prev, 1e-6) if t_prev is not None else 1e-3
            t_prev = t
        dev = self.device
        return preint.integrate(torch.as_tensor(accs, device=dev),
                                torch.as_tensor(gyros, device=dev),
                                torch.as_tensor(dts, device=dev), None, self.calib,
                                bg=self.bg, ba=self.ba)

    # ------------------------------------------------------------------
    def track_frame(self, kpts, rays, desc, valid, time) -> dict:
        pre_seg = None
        if self._last_frame_time is not None and self._imu_buf:
            with self.timers.stage("imu_preint"):
                pre_seg = self._preintegrate_window()
        # The keyframe chain accumulates at finish (_on_frame_finish): with
        # pipeline=K the dispatch runs K frames ahead of the keyframes.
        self._cur_preint = pre_seg
        self._pred_body = None
        self._vi_refined = False
        info = super().track_frame(kpts, rays, desc, valid, time)
        if self.last_frame is not None:
            # _predict_pose ran inside super().track_frame, after _prepare_frame.
            self.last_frame.vi_pred_v = None if self._pred_body is None else self._pred_body[2]
        self._last_frame_time = float(time)
        if (self.imu_ready and not self._vi_refined and self._pred_body is not None
                and info.get("state") == T.OK):
            self.v_wb = self._pred_body[2]
        if info.get("state") == T.OK and self.last_frame.R_cw is not None:
            self.R_wb, self.p_wb = _body_from_camera(self.last_frame.R_cw,
                                                     self.last_frame.t_cw,
                                                     self.calib.Rbc, self.calib.tbc)
        if (not self.imu_ready and self.tracking_state == T.OK
                and self.n_kf - self._kf_base >= 6
                and len(self._kf_preints) >= self.n_kf - 1 - self._kf_base
                and self._elapsed_kf_time() >= self.tinit_s):
            self._initialize_imu()
        elif (self.imu_ready and self.tracking_state == T.OK and self._init_stage == 1
                and time - self._t_imu_init >= self.viba1_dt):
            # VIBA1 (reference @5 s, priors 1 / 1e5), then full-window VI-BA.
            self._refine_scale(prior_g=1.0, prior_a=1e5)
            self._run_vi_ba(window=self.n_kf - self._kf_base, iters=max(self.vi_ba_iters, 8))
            self._init_stage = 2
            self._last_refine_kf = self.n_kf
        elif (self.imu_ready and self.tracking_state == T.OK and self._init_stage == 2
                and time - self._t_imu_init >= self.viba2_dt):
            # VIBA2 (reference @15 s, priors 0 / 0).
            self._refine_scale(prior_g=0.0, prior_a=0.0)
            self._run_vi_ba(window=self.n_kf - self._kf_base, iters=max(self.vi_ba_iters, 8))
            self._init_stage = 3
            self._last_refine_kf = self.n_kf
        elif (self.imu_ready and self.tracking_state == T.OK and self.refine_every > 0
                and self.n_kf - self._last_refine_kf >= self.refine_every):
            # Periodic scale/gravity refinement (reference ScaleRefinement),
            # here so the alignment reaches the current frame's pose.
            self._refine_scale()
            self._last_refine_kf = self.n_kf
        # IMU.InsertKFsWhenLost: while RECENTLY_LOST with a live IMU, keep
        # inserting keyframes from the predicted pose.
        lf = self.last_frame
        if (self.cfg.insert_kfs_when_lost and self.imu_ready
                and self.tracking_state == T.RECENTLY_LOST
                and lf is not None and lf.R_cw is not None
                and self.frames_since_kf >= 2 and self._ensure_kf_capacity(1)):
            self._insert_keyframe(lf)
        info["imu_ready"] = self.imu_ready
        return info

    def _fused_mapping_ok(self) -> bool:
        # The insert closes preintegration segments and snapshots body
        # states on the host.
        return False

    def _prepare_frame(self, frame):
        frame.vi_seg = self._cur_preint
        frame.vi_pred_v = None    # set after _predict_pose (track_frame)

    def _on_frame_finish(self, frame):
        """The keyframe preintegration chain (reference
        mpImuPreintegratedFromLastKF), merged in finish order: in dispatch
        order in sync mode, and right under pipeline lag."""
        seg = frame.vi_seg
        if seg is None:
            return
        self._preint_since_kf = seg if self._preint_since_kf is None \
            else preint.merge(self._preint_since_kf, seg)

    def _post_track_refine(self, frame):
        """Per-frame VI motion-only optimization (reference
        PoseInertialOptimizationLastKeyFrame / LastFrame): the frame's pose,
        velocity and biases against its matches and the preintegrated factor
        to the previous frame, chaining a 15-dim marginal prior. Runs at
        finish with the frame's own segment; in pipeline mode the anchor is
        the last finished frame's refined body state (_fin_body)."""
        seg = frame.vi_seg
        if not self.imu_ready or seg is None or self._last_n_inl < 15:
            if self.pipeline and frame.R_cw is not None and self.imu_ready:
                self._seed_fin_body(frame)
            return
        if self.pipeline and self._fin_body is None:
            # First finish after the init or an alignment: reseed the chain
            # and restart the prior.
            self._seed_fin_body(frame)
            self._vi_prior_H = None
            return
        st = self.state
        li = frame.landmark_idx
        e_valid = (li >= 0) & frame.valid
        Xw = st.lm_pos[li.long().clamp(0, st.L - 1)]
        R1, p1 = _body_from_camera(frame.R_cw, frame.t_cw, self.calib.Rbc, self.calib.tbc)
        if self.pipeline:
            R0b, p0b, v0b = self._fin_body
            v1 = frame.vi_pred_v if frame.vi_pred_v is not None else v0b
        else:
            R0b, p0b, v0b = self.R_wb, self.p_wb, self.v_wb
            v1 = self._pred_body[2] if self._pred_body is not None else self.v_wb
        R_cb, t_cb = lie.se3_inverse(self.calib.Rbc, self.calib.tbc)
        anchor_fixed = self._vi_prior_H is None
        dev = self.device
        prior_H = torch.zeros((15, 15), device=dev) if anchor_fixed else self._vi_prior_H
        # Bias-walk information from the preintegrated covariance (reference
        # EdgeGyroRW / EdgeAccRW).
        walk_var = torch.diagonal(seg.C)[9:15]
        prob = pio.PoseInertialProblem(
            R_wb0=R0b, p_wb0=p0b, v_wb0=v0b, bg0=self.bg, ba0=self.ba,
            R_wb1=R1, p_wb1=p1, v_wb1=v1, bg1=self.bg, ba1=self.ba,
            prior_H=prior_H, prior_valid=torch.full((), not anchor_fixed, device=dev),
            imu_dR=seg.dR, imu_dV=seg.dV, imu_dP=seg.dP, imu_JRg=seg.JRg, imu_JVg=seg.JVg,
            imu_JVa=seg.JVa, imu_JPg=seg.JPg, imu_JPa=seg.JPa, imu_dt=seg.dt,
            imu_bg0=seg.bg, imu_ba0=seg.ba, imu_info=preint.information_9(seg),
            walk_info=1.0 / torch.clamp(walk_var, min=1e-12),
            Xw=Xw, uv=frame.kpts, e_valid=e_valid, e_info=torch.ones((st.N,), device=dev),
            R_cb=R_cb, t_cb=t_cb, cam_params=self.cam_params,
            invd=frame.invd if self.bf is not None else None, bf=self._bf_arr())
        with self.timers.stage("vi_pose"):
            res = pio.solve_pose_inertial(prob, cam_kind=self.cfg.cam_kind,
                                          anchor_fixed=anchor_fixed)
            n_inl = int(res.n_inliers)
        if n_inl < max(15, self._last_n_inl // 3):
            # Diverged (a bad segment, few edges): keep the visual pose and
            # restart the prior chain.
            self._vi_prior_H = None
            if self.pipeline:
                self._seed_fin_body(frame)
            return
        frame.R_cw, frame.t_cw = res.R_cw, res.t_cw
        frame.landmark_idx = torch.where(res.inliers, li, -1)
        self.v_wb, self.bg, self.ba = res.v_wb, res.bg, res.ba
        self._last_n_inl = n_inl
        self._vi_prior_H = res.marg_H
        self._vi_refined = True
        self.vi_refines += 1
        if self.pipeline:
            R1b, p1b = _body_from_camera(res.R_cw, res.t_cw, self.calib.Rbc, self.calib.tbc)
            self._fin_body = (R1b, p1b, res.v_wb)

    def _seed_fin_body(self, frame):
        Rb, pb = _body_from_camera(frame.R_cw, frame.t_cw, self.calib.Rbc, self.calib.tbc)
        self._fin_body = (Rb, pb, frame.vi_pred_v if frame.vi_pred_v is not None
                          else self.v_wb)

    def _need_new_keyframe(self, frame) -> bool:
        """Before the IMU init the cadence is time-based (reference: a
        keyframe every >= 0.1 s in mono-inertial mode; here
        pre_init_kf_dt, 0 = every tracked frame): the regular policy after."""
        if not self.imu_ready and self.n_kf >= 2 and self.last_frame is not None:
            dt = frame.time - float(self.state.kf_time[self.n_kf - 1])
            return not dt < self.pre_init_kf_dt - 1e-3
        return super()._need_new_keyframe(frame)

    def _elapsed_kf_time(self):
        if self.n_kf < 2:
            return 0.0
        t = self.state.kf_time[:self.n_kf].cpu().numpy()
        return float(t[-1] - t[0])

    def _predict_pose(self):
        if self.imu_ready and self._cur_preint is not None:
            R1, p1, v1, R_cw, t_cw = _predict_imu_kernel(
                self.R_wb, self.p_wb, self.v_wb, self._cur_preint, self.bg, self.ba,
                self.calib.Rbc, self.calib.tbc)
            self._pred_body = (R1, p1, v1)
            return R_cw, t_cw
        return super()._predict_pose()

    def _on_tracking_lost(self, frame):
        super()._on_tracking_lost(frame)
        self._fin_body = None
        self._vi_prior_H = None
        self._preint_since_kf = None

    def _monocular_init(self, frame):
        ok = super()._monocular_init(frame)
        self._fin_body = None
        if ok:
            # Keyframes 0 and 1 came from the init: the segment into the
            # second spans pre-init frames, so a placeholder (dt = 0, masked
            # in the init problem) stands for it; keyframe ids are global
            # while the buffer restarts per map.
            self._kf_preints = [preint.init_state(device=self.device)]
            self._preint_since_kf = None
            self._kf_base = self.n_kf - 2
        return ok

    def _insert_keyframe(self, frame):
        # Close the segment of the previous keyframe.
        if self.n_kf >= 1:
            seg = self._preint_since_kf
            self._kf_preints.append(seg if seg is not None
                                    else preint.init_state(device=self.device))
        self._preint_since_kf = None
        super()._insert_keyframe(frame)
        # The new keyframe's body state: velocity from the IMU propagation,
        # biases from the current estimate (the pose is derived from the
        # camera pose whenever needed).
        kf_id = self.n_kf - 1
        self.state = _set_body_state_kernel(
            self.state, kf_id, self.state.kf_R_cw[kf_id], self.state.kf_t_cw[kf_id],
            self.calib.Rbc, self.calib.tbc, self.v_wb, self.bg, self.ba)
        self._vi_prior_H = None
        if (self.vi_ba_every > 0 and self.imu_ready and self.n_kf >= 3
                and self.n_kf % self.vi_ba_every == 0):
            with self.timers.stage("vi_ba"):
                self._run_vi_ba()

    def _on_compaction(self, kf_old2new):
        """Slot compaction renumbered the keyframes: rebuild the chain,
        merging the segments over culled keyframes (exact, as the
        reference's MergePrevious)."""
        base = self._kf_base
        segs = self._kf_preints
        old_last = base + len(segs)
        olds = [k for k in range(base, old_last + 1)
                if 0 <= k < len(kf_old2new) and kf_old2new[k] >= 0]
        if len(olds) < 2:
            self._kf_preints = []
            self._kf_base = self.n_kf - 1 if self.n_kf > 0 else 0
            return
        new_segs = []
        for a, b in zip(olds[:-1], olds[1:]):
            seg = segs[a - base]
            for k in range(a + 1, b):
                seg = preint.merge(seg, segs[k - base])
            new_segs.append(seg)
        self._kf_preints = new_segs
        self._kf_base = int(kf_old2new[olds[0]])
        self._last_refine_kf = int(np.sum(
            np.asarray(kf_old2new[:max(self._last_refine_kf, 0)]) >= 0))

    def _on_map_merged(self, kf_id: int, info: dict):
        """After a cross-map weld (reference MergeLocal2 -> MergeInertialBA):
        a temporal VI-BA over the active side against the fused landmarks;
        the old side's keyframes act as fixed visual anchors."""
        if self.imu_ready and len(self._kf_preints) >= 3:
            with self.timers.stage("merge_viba"):
                self._run_vi_ba(window=min(12, len(self._kf_preints)))

    @staticmethod
    def _bucket(n: int, buckets=(4, 8, 12, 16, 24, 32, 48, 64, 96, 128)):
        """The JAX package's static window sizes; they also decide which
        keyframes a window holds (_run_vi_ba), so they are kept."""
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _run_vi_ba(self, window: int = 8, iters: Optional[int] = None):
        """Temporal-window VI-BA (reference LocalInertialBA; with window =
        the whole map, the FullInertialBA of the init). Padded to a bucket
        size: the pad rows repeat the last keyframe, masked, and only the
        real rows are written back."""
        iters = self.vi_ba_iters if iters is None else iters
        W = min(window, self.n_kf - self._kf_base)
        if W < 3:
            return
        Wp = self._bucket(W)
        if Wp > W and Wp > self.n_kf - self._kf_base:
            W = min(Wp, self.n_kf - self._kf_base)
        lo = self.n_kf - W
        segs = self._kf_preints[lo - self._kf_base:self.n_kf - 1 - self._kf_base]
        n_pad = Wp - W
        imu, infos, dt_ok = _stack_segments(segs, n_pad)
        dev = self.device
        jidx = torch.tensor(list(range(lo, self.n_kf)) + [self.n_kf - 1] * n_pad, device=dev)
        ar = torch.arange(Wp, device=dev)
        kf_valid = ar < W
        st = self.state
        N, L = st.N, st.L
        li = st.kf_landmark_idx[jidx]
        kv = st.kf_kpt_valid[jidx] & kf_valid[:, None]
        has = (li >= 0) & kv
        e_lm = torch.where(has, li, 0).clamp(0, L - 1).reshape(-1)
        e_valid = has.reshape(-1) & st.lm_active[e_lm.long()]
        e_kf = ar[:, None].expand(Wp, N).reshape(-1)
        lm_opt = scatterless.seg_any(e_lm, e_valid, L)
        R_cb, t_cb = lie.se3_inverse(self.calib.Rbc, self.calib.tbc)
        R_wb_w, p_wb_w = _body_from_camera(st.kf_R_cw[jidx], st.kf_t_cw[jidx],
                                           self.calib.Rbc, self.calib.tbc)
        prob = vi_ba_mod.VIBAProblem(
            R_wb=R_wb_w, p_wb=p_wb_w, v_wb=st.kf_v_wb[jidx], bg=st.kf_bg[jidx],
            ba=st.kf_ba[jidx], pose_opt_mask=(ar > 0) & kf_valid, kf_valid=kf_valid,
            R_cb=R_cb, t_cb=t_cb, cam_params=self.cam_params,
            **dict(zip(vi_ba_mod.IMU_FIELDS, imu)), imu_info=infos,
            imu_valid=(ar < W - 1) & dt_ok,
            walk_info=self._walk_info * self.vi_ba_walk_scale,
            lm_pos=st.lm_pos, lm_opt_mask=lm_opt, e_kf=e_kf.to(torch.int32),
            e_lm=e_lm.to(torch.int32), e_uv=st.kf_kpts[jidx].reshape(-1, 2), e_valid=e_valid,
            e_info=torch.full((Wp * N,), self.vi_ba_reproj_info, device=dev),
            e_invd=None if self.bf is None else st.kf_kpt_invd[jidx].reshape(-1),
            bf=self._bf_arr())
        R, p, v, bg, ba, X, _ = vi_ba_mod.solve_vi_ba(prob, cam_kind=self.cfg.cam_kind,
                                                      iters=iters)
        self.vi_ba_runs += 1
        R, p, v, bg, ba = R[:W], p[:W], v[:W], bg[:W], ba[:W]
        rows = jidx[:W]
        R_cw = torch.einsum("ij,kjl->kil", R_cb, R.transpose(-1, -2))   # T_cw = T_cb T_bw
        t_cw = -torch.einsum("kij,kj->ki", R_cw, p) + t_cb

        def put(arr, val):
            arr = arr.clone()
            arr[rows] = val
            return arr

        self.state = st.replace(
            kf_R_wb=put(st.kf_R_wb, R), kf_p_wb=put(st.kf_p_wb, p), kf_v_wb=put(st.kf_v_wb, v),
            kf_bg=put(st.kf_bg, bg), kf_ba=put(st.kf_ba, ba), kf_R_cw=put(st.kf_R_cw, R_cw),
            kf_t_cw=put(st.kf_t_cw, t_cw), lm_pos=X)
        self.R_wb, self.p_wb, self.v_wb, self.bg, self.ba = R[-1], p[-1], v[-1], bg[-1], ba[-1]

    def _refine_scale(self, max_window: int = 30, prior_g: float = 1e2,
                      prior_a: float = 1e6):
        """The inertial-only estimator over a longer window, its residual
        scale and gravity applied (reference ScaleRefinement; with the VIBA1
        / VIBA2 priors the staged InertialOptimization)."""
        idx, segs = self._init_chain()
        if len(idx) > max_window:
            idx = idx[-max_window:]
            segs = segs[-(len(idx) - 1):]
        if len(segs) < 4:
            return
        res = ii.inertial_only_optimization(self._build_init_problem(idx, segs),
                                            prior_g=prior_g, prior_a=prior_a)
        s = float(res.scale)
        if not np.isfinite(s) or not (0.25 < s < 4.0):
            return
        # In-flight frames were tracked in the pre-alignment world: finish
        # them there first.
        self.flush()
        self._fin_body = None
        self.scale_log.append(("refine", s))
        scale = torch.tensor(s, device=self.device)
        v_full = scale * self.state.kf_v_wb
        v_full[torch.tensor(idx, device=self.device)] = res.v_wb[:len(idx)]
        self.state = _apply_alignment_kernel(self.state, res.Rwg, scale, v_full, res.bg,
                                             res.ba, self.calib.Rbc, self.calib.tbc)
        self.bg, self.ba = res.bg, res.ba
        lf = self.last_frame
        if lf is not None and lf.R_cw is not None:
            lf.R_cw = lf.R_cw @ res.Rwg
            lf.t_cw = scale * lf.t_cw
        self.velocity = None
        self._vi_prior_H = None
        # The body state at the last frame, which is ahead of the last keyframe.
        if lf is not None and lf.R_cw is not None:
            self.R_wb, self.p_wb = _body_from_camera(lf.R_cw, lf.t_cw, self.calib.Rbc,
                                                     self.calib.tbc)
            self.v_wb = scale * (res.Rwg.T @ self.v_wb)
        else:
            k = self.n_kf - 1
            self.R_wb, self.p_wb = self.state.kf_R_wb[k], self.state.kf_p_wb[k]
            self.v_wb = self.state.kf_v_wb[k]

    def _build_init_problem(self, idx, segs):
        """The inertial-only problem over a keyframe chain, padded to a
        bucket size (kf_valid / imu_valid carry the real extent)."""
        K = len(idx)
        Kp = self._bucket(K)
        n_pad = Kp - K
        imu, infos, dt_ok = _stack_segments(segs, n_pad)
        dev = self.device
        jidx = torch.tensor(list(idx) + [idx[-1]] * n_pad, device=dev)
        R_wb, p_wb = _body_from_camera(self.state.kf_R_cw[jidx], self.state.kf_t_cw[jidx],
                                       self.calib.Rbc, self.calib.tbc)
        ar = torch.arange(Kp, device=dev)
        return ii.InertialInitProblem(
            R_wb=R_wb, p_wb=p_wb, kf_valid=ar < K, **dict(zip(vi_ba_mod.IMU_FIELDS, imu)),
            imu_info=infos, imu_valid=(ar < K - 1) & dt_ok)

    # ------------------------------------------------------------------
    def _init_chain(self):
        """The keyframe chain of the init problem: picks at least
        init_edge_dt apart (the segments between picks merged), so each
        edge's visual displacement clears the keyframe position noise.
        Starts past the placeholder segment of the map's first keyframe.
        Returns (idx, segs)."""
        K = min(self.n_kf, len(self._kf_preints) + 1)
        first = self.n_kf - K
        times = self.state.kf_time[first:self.n_kf].cpu().numpy()
        base_off = first - self._kf_base
        lo = 1 if base_off == 0 else 0
        picks = [lo]
        for j in range(lo + 1, K):
            if times[j] - times[picks[-1]] >= self.init_edge_dt - 1e-3:
                picks.append(j)
        if len(picks) < 3:
            picks = list(range(lo, K))
        idx = [first + j for j in picks]
        segs = []
        for a, b in zip(picks[:-1], picks[1:]):
            seg = self._kf_preints[base_off + a]
            for j in range(a + 1, b):
                seg = preint.merge(seg, self._kf_preints[base_off + j])
            segs.append(seg)
        return idx, segs

    def _initialize_imu(self):
        """(reference InitializeIMU: stage 1 with priors 1e2 / 1e10, the
        alignment, then the full-window inertial BA.)"""
        idx, segs = self._init_chain()
        res = ii.inertial_only_optimization(self._build_init_problem(idx, segs),
                                            prior_g=1e2, prior_a=1e10)
        scale = float(res.scale)
        # The reference aborts on an implausible scale; the visual map has
        # median depth 1, so the metric scale is about the median depth.
        if not (0.02 < scale < 100.0) or not np.isfinite(scale):
            return
        self.flush()
        self._fin_body = None
        self.scale_log.append(("init", scale))
        # Velocities of keyframes between the picks: forward-filled from the
        # nearest pick before them.
        v_np = np.zeros((self.state.K, 3), np.float32)
        v_est = res.v_wb.cpu().numpy()
        for j in range(idx[0], self.n_kf):
            p = int(np.searchsorted(np.asarray(idx), j, side="right")) - 1
            v_np[j] = v_est[max(p, 0)]
        dev = self.device
        s_t = torch.tensor(scale, device=dev)
        self.state = _apply_alignment_kernel(self.state, res.Rwg, s_t,
                                             torch.as_tensor(v_np, device=dev), res.bg,
                                             res.ba, self.calib.Rbc, self.calib.tbc)
        self.bg, self.ba = res.bg, res.ba
        lf = self.last_frame
        if lf is not None and lf.R_cw is not None:
            lf.R_cw = lf.R_cw @ res.Rwg
            lf.t_cw = s_t * lf.t_cw
        self.velocity = None
        k_last = self.n_kf - 1
        if lf is not None and lf.R_cw is not None:
            self.R_wb, self.p_wb = _body_from_camera(lf.R_cw, lf.t_cw, self.calib.Rbc,
                                                     self.calib.tbc)
        else:
            self.R_wb, self.p_wb = self.state.kf_R_wb[k_last], self.state.kf_p_wb[k_last]
        self.v_wb = self.state.kf_v_wb[k_last]
        self.imu_ready = True
        self.vi_ba_enabled = True
        self.imu_init_time = lf.time if lf is not None else None
        if self.loop_closer is not None:
            # Gravity is aligned: loop corrections keep roll, pitch and scale.
            self.loop_closer.use_4dof = True
        self._t_imu_init = float(self.state.kf_time[self.n_kf - 1])
        self._init_stage = 1
        self._run_vi_ba(window=self.n_kf - self._kf_base, iters=max(self.vi_ba_iters, 8))
        self.timers.add("imu_init", 0.0)
