"""Tracking and keyframe-insert programs over the device-resident map.

Counterpart of rover_slam_tpu/slam/tracking.py: `TrackerConfig`,
`FrameData`, the per-frame track step (frame-to-frame match -> motion-model
pose opt -> reference-keyframe fallback -> local-map projection track -> pose
opt), the keyframe insert (covisibility -> triangulation against the top-2
neighbours -> fusion -> descriptors -> windowed local BA -> statistics and
culling), the fused per-frame program of pipeline mode
(`_track_and_map_body`: track step, on-device keyframe policy, conditional
insert) and relocalization (`_relocalize_kernel` against the whole landmark
table, `_reloc_from_kf_matches` from learned keyframe matches). Each
`lax.cond` of the JAX package becomes a Python `if` on one fetched bool: one
host sync each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..geometry import lie, cameras, triangulation
from ..map import map_state as ms
from ..map import maintenance as mnt
from ..ops import association as assoc
from ..ops import scatterless
from ..optim import pose_opt, ba, pnp, robust
from ..utils import profiling

# Scale/view-adaptive projection-search gates (reference MapPoint::
# PredictScale distance band + isInFrustum viewing cos).
ADAPT_DEPTH_BAND = 2.5
ADAPT_COS_MIN = 0.35

# Tracking states (reference eTrackingState)
NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


@dataclass
class TrackerConfig:
    """Thresholds and schedules of the tracker: the JAX package's
    TrackerConfig fields that the monocular path reads, with the same names
    and defaults."""
    cam_kind: int = cameras.PINHOLE
    image_hw: tuple = (480, 640)
    min_matches_motion: int = 20
    min_matches_ref_kf: int = 15
    min_inliers_track: int = 10
    min_inliers_local_map: int = 30
    min_inliers_weak: int = 12
    min_init_matches: int = 80
    proj_radius: float = 15.0
    desc_th2: float = assoc.TH_HIGH ** 2
    local_map_only: bool = False
    kf_min_interval: int = 1
    kf_max_interval: int = 10
    kf_tracked_ratio: float = 0.75
    local_window: int = 8
    fixed_window: int = 8
    ba_iters: int = 2
    ba_every: int = 1
    kf_cull_every: int = 0
    kf_cull_redundancy: float = 0.9
    time_recently_lost_s: float = 2.0
    min_kfs_keep_map: int = 10
    min_reloc_inliers: int = 30
    reloc_every: int = 2
    timestamp_jump_s: float = 1.0
    insert_kfs_when_lost: bool = False   # with an IMU: keep inserting keyframes
                                         # from predicted poses while RECENTLY_LOST
    init_sigma_px: float = 1.0
    th_far_points: float = 100.0
    motion_rounds: int = 2
    motion_iters: int = 5
    local_rounds: int = 2
    local_iters: int = 6


@dataclass
class FrameData:
    """Per-frame bundle of device tensors."""
    kpts: torch.Tensor
    rays: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    time: float
    R_cw: Optional[torch.Tensor] = None
    t_cw: Optional[torch.Tensor] = None
    landmark_idx: Optional[torch.Tensor] = None
    fused: bool = False     # tracked (and maybe inserted) by _track_and_map_body
    invd: Optional[torch.Tensor] = None   # [N] stereo inverse depth (<= 0: none)
    # Inertial systems, stashed at dispatch for the finish-time refinement:
    # the frame's preintegration segment and its IMU-predicted velocity.
    vi_seg: Optional[object] = None
    vi_pred_v: Optional[torch.Tensor] = None


def _match_prev(desc0, valid0, desc1, valid1):
    """Mutual-NN with the Lowe ratio (kernel B2 on the card)."""
    return assoc.mutual_nn_match(desc0, valid0, desc1, valid1, ratio=0.8)


def _gather_lm(lidx, idx, n):
    """lidx[idx] where idx >= 0, else -1."""
    return torch.where(idx >= 0, lidx[idx.long().clamp(0, n - 1)], -1)


def _init_map_kernel(state: ms.MapState, f0_kpts, f0_rays, f0_desc, f0_valid,
                     f1_kpts, f1_rays, f1_desc, f1_valid, t0, t1, matches01,
                     tv_success, R_21, t_21, points3d, is_tri, cam_params, cam_kind):
    """The initial two-keyframe map from a two-view reconstruction, scaled so
    the median triangulated depth is 1."""
    N = f0_kpts.shape[0]
    depths = torch.where(is_tri, points3d[:, 2], torch.nan)
    med = torch.nanquantile(depths, 0.5)
    scale = torch.where(torch.isfinite(med) & (med > 1e-6), 1.0 / med,
                        torch.ones_like(med))
    X = points3d * scale
    t21s = t_21 * scale
    base = state.n_kf
    normals = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-9)
    state, slots = ms.add_landmarks(state, X, f0_desc, normals,
                                    base.expand(N).to(torch.int32), is_tri)
    lm_idx0 = torch.where(slots >= 0, slots, -1)
    eye = torch.eye(3, device=X.device)
    zero3 = torch.zeros(3, device=X.device)
    state, k0 = ms.add_keyframe(state, eye, zero3, f0_kpts, f0_rays, f0_desc,
                                f0_valid, lm_idx0, t0, parent=-1)
    inv01 = assoc.invert_matches(
        torch.where((matches01 >= 0) & (slots >= 0), matches01, -1), N)
    lm_idx1 = _gather_lm(slots, inv01, N)
    state, _ = ms.add_keyframe(state, R_21, t21s, f1_kpts, f1_rays, f1_desc,
                               f1_valid, lm_idx1, t1, parent=k0)
    return state, lm_idx1, scale


def _ba_window_args(state: ms.MapState, window_ids, opt_mask, cam_params, bf=None):
    """BAProblem over a keyframe window with every keypoint slot as a padded
    edge, keyframe-major (edge rows [k*N, (k+1)*N) belong to window kf k).
    With bf (stereo) the edges carry the keypoints' inverse depths."""
    Kw = window_ids.shape[0]
    N, L = state.N, state.L
    win = window_ids.long().clamp(0, state.K - 1)
    li = state.kf_landmark_idx[win]
    kv = state.kf_kpt_valid[win]
    win_ok = (window_ids >= 0)[:, None]
    has = (li >= 0) & kv & win_ok
    e_lm = torch.where(has, li, 0).reshape(-1).long().clamp(0, L - 1)
    e_valid = has.reshape(-1) & state.lm_active[e_lm]
    e_kf = torch.arange(Kw, device=state.device)[:, None].expand(Kw, N).reshape(-1)
    lm_opt = scatterless.seg_any(e_lm, e_valid & opt_mask[e_kf], L)
    return ba.BAProblem(
        R_cw=state.kf_R_cw[win], t_cw=state.kf_t_cw[win],
        pose_opt_mask=opt_mask & (window_ids >= 0),
        lm_pos=state.lm_pos, lm_opt_mask=lm_opt & state.lm_active,
        cam_params=cam_params, e_kf=e_kf, e_lm=e_lm,
        e_uv=state.kf_kpts[win].reshape(-1, 2), e_valid=e_valid,
        e_info=torch.ones((Kw * N,), dtype=torch.float32, device=state.device),
        e_invd=None if bf is None else state.kf_kpt_invd[win].reshape(-1), bf=bf)


def _write_rows_last(arr, idx, rows):
    """arr with arr[idx[i]] = rows[i]; where idx repeats (window padding
    clipped to keyframe 0) the last write wins, as the JAX package's scatter
    resolves it on the CPU."""
    n = idx.shape[0]
    last = torch.full((arr.shape[0],), -1, dtype=torch.long, device=arr.device)
    last = last.scatter_reduce(0, idx, torch.arange(n, device=arr.device), reduce="amax")
    return arr.index_copy(0, idx, rows[last[idx]])


def _local_ba_body(state: ms.MapState, window_ids, opt_mask, cam_params, cam_kind,
                   iters, bf=None):
    """Local BA over a keyframe window, written back into the map with the
    outlier observations removed."""
    prob = _ba_window_args(state, window_ids, opt_mask, cam_params, bf=bf)
    res = ba.solve_ba(prob, cam_kind=cam_kind, iters=iters, lm_cap=2048)
    win = window_ids.long().clamp(0, state.K - 1)
    write = opt_mask & (window_ids >= 0)
    new_R = torch.where(write[:, None, None], res.R_cw, state.kf_R_cw[win])
    new_t = torch.where(write[:, None], res.t_cw, state.kf_t_cw[win])
    bad = ((~res.e_inlier) & prob.e_valid).reshape(window_ids.shape[0], state.N)
    li_rows = torch.where(bad, -1, state.kf_landmark_idx[win])
    return state.replace(
        kf_R_cw=_write_rows_last(state.kf_R_cw, win, new_R),
        kf_t_cw=_write_rows_last(state.kf_t_cw, win, new_t),
        lm_pos=res.lm_pos,
        kf_landmark_idx=_write_rows_last(state.kf_landmark_idx, win, li_rows))


def _triangulate_pair_kernel_body(state: ms.MapState, kf_new, kf_nbr, cam_params,
                                  cam_kind, enabled, min_parallax_cos=0.9998,
                                  ext_matches=None):
    """New landmarks between a new keyframe and one covisible neighbour:
    match free keypoints (mutual NN, or the learned matcher's matches), gate
    epipolarly, triangulate, check reprojection in both views, register the
    observations. `enabled` (bool tensor) masks the whole update."""
    N, L = state.N, state.L
    d_new = state.kf_desc[kf_new].float()
    free_new = state.kf_kpt_valid[kf_new] & (state.kf_landmark_idx[kf_new] < 0)
    free_nbr = state.kf_kpt_valid[kf_nbr] & (state.kf_landmark_idx[kf_nbr] < 0)
    if ext_matches is not None:
        mc = ext_matches.long().clamp(0, N - 1)
        matches = torch.where((ext_matches >= 0) & free_new & free_nbr[mc],
                              ext_matches, -1).to(torch.int32)
    else:
        matches, _ = assoc.mutual_nn_match(d_new, free_new,
                                           state.kf_desc[kf_nbr].float(), free_nbr,
                                           th_desc2=assoc.TH_LOW ** 2, ratio=0.8)
    R0, t0 = state.kf_R_cw[kf_new], state.kf_t_cw[kf_new]
    R1, t1 = state.kf_R_cw[kf_nbr], state.kf_t_cw[kf_nbr]
    R1i, t1i = lie.se3_inverse(R1, t1)
    R01, t01 = lie.se3_compose(R0, t0, R1i, t1i)
    matches = assoc.epipolar_gate(state.kf_rays[kf_new], state.kf_rays[kf_nbr],
                                  matches, R01, t01, th=0.01)
    m = matches.long().clamp(0, N - 1)
    ray0 = state.kf_rays[kf_new]
    ray1 = state.kf_rays[kf_nbr][m]
    Xw, tri_ok = triangulation.triangulate_and_check(
        ray0, ray1, R0, t0, R1, t1, min_parallax_cos=min_parallax_cos)
    ok = tri_ok & (matches >= 0)
    uv0 = cameras.project(cam_kind, cam_params, lie.se3_apply(R0, t0, Xw))
    uv1 = cameras.project(cam_kind, cam_params, lie.se3_apply(R1, t1, Xw))
    e0 = torch.sum((uv0 - state.kf_kpts[kf_new]) ** 2, dim=-1)
    e1 = torch.sum((uv1 - state.kf_kpts[kf_nbr][m]) ** 2, dim=-1)
    ok = ok & (e0 < robust.CHI2_MONO * 4) & (e1 < robust.CHI2_MONO * 4) & enabled
    normals = Xw / torch.clamp(torch.linalg.norm(Xw, dim=-1, keepdim=True), min=1e-9)
    anchor = torch.as_tensor(kf_new, device=Xw.device).to(torch.int32).expand(N)
    state, slots = ms.add_landmarks(state, Xw, d_new, normals, anchor, ok)
    li_new = torch.where(slots >= 0, slots, state.kf_landmark_idx[kf_new])
    inv_nb = assoc.invert_matches(torch.where(slots >= 0, matches, -1), N)
    li_nbr = torch.where(inv_nb >= 0, slots[inv_nb.long().clamp(0, N - 1)],
                         state.kf_landmark_idx[kf_nbr])
    rows = state.kf_landmark_idx.index_copy(
        0, torch.as_tensor(kf_new, device=Xw.device).reshape(1).long(), li_new[None])
    rows = rows.index_copy(
        0, torch.as_tensor(kf_nbr, device=Xw.device).reshape(1).long(), li_nbr[None])
    # New landmarks start with their two registering observations.
    two = 2 * scatterless.seg_count(slots, L)
    state = state.replace(kf_landmark_idx=rows, lm_n_obs=state.lm_n_obs + two)
    return state, torch.sum(slots >= 0)


def _track_step_body(state: ms.MapState, prev_desc, prev_valid, prev_lidx,
                     cur_kpts, cur_desc, cur_valid, R_pred, t_pred,
                     cam_params, cam_kind, image_hw, min_matches_motion,
                     min_inliers_track, min_inliers_local_map, proj_radius,
                     desc_th2, ref_kf=None, local_map_only: bool = False,
                     ext_matches=None, max_depth=100.0, min_matches_ref_kf=15,
                     motion_rounds: int = 2, motion_iters: int = 5,
                     local_rounds: int = 2, local_iters: int = 6,
                     local_mask=None, min_inliers_weak=12, cur_invd=None, bf=None):
    """One frame: frame-to-frame match -> motion-model pose opt -> (on
    failure) reference-keyframe match + pose opt -> local-map projection
    match -> pose opt; with cur_invd/bf (stereo) every pose optimization has
    the stereo rows. Returns (R, t, cur_lm [N] int32, flags [5] int32 =
    [ok, n_inliers, stage1_ok, n_cand, weak])."""
    L, K = state.L, state.K
    N = cur_kpts.shape[0]
    dev = cur_kpts.device
    if ext_matches is None:
        with profiling.span("track.match"):
            matches, _ = assoc.mutual_nn_match(prev_desc, prev_valid, cur_desc,
                                               cur_valid, ratio=0.8)
    else:
        matches = ext_matches
    # --- motion-model stage ---
    with profiling.span("track.motion"):
        has = (matches >= 0) & (prev_lidx >= 0) & prev_valid
        inv_m = assoc.invert_matches(torch.where(has, matches, -1), N)
        cur_lm0 = _gather_lm(prev_lidx, inv_m, N)
        lm_c = cur_lm0.long().clamp(0, L - 1)
        cand_ok = (cur_lm0 >= 0) & state.lm_active[lm_c] & cur_valid
        res_m = pose_opt.pose_optimization(R_pred, t_pred, state.lm_pos[lm_c], cur_kpts,
                                           cand_ok, cam_params, cam_kind=cam_kind,
                                           rounds=motion_rounds,
                                           iters_per_round=motion_iters, check_cost=False,
                                           invd=cur_invd, bf=bf)
        n_cand = torch.sum(cand_ok, dtype=torch.int32)
        motion_ok = (n_cand >= min_matches_motion) & (res_m.n_inliers >= min_inliers_track)
        motion_ok_host = bool(motion_ok)

    # --- reference-keyframe fallback (only when the motion model failed) ---
    no_lm = torch.full((N,), -1, dtype=torch.int32, device=dev)
    if motion_ok_host:
        ref_ok, R_r, t_r, lm_r = torch.zeros((), dtype=torch.bool, device=dev), \
            R_pred, t_pred, no_lm
    else:
        with profiling.span("track.ref_kf"):
            ref = ref_kf.long().clamp(0, K - 1)
            ref_lidx = state.kf_landmark_idx[ref]
            ref_has = state.kf_kpt_valid[ref] & (ref_lidx >= 0)
            m_ref, _ = assoc.mutual_nn_match(state.kf_desc[ref].float(), ref_has,
                                             cur_desc, cur_valid, ratio=0.8)
            inv_r = assoc.invert_matches(torch.where((m_ref >= 0) & ref_has, m_ref, -1), N)
            lm_rr = _gather_lm(ref_lidx, inv_r, N)
            lmc = lm_rr.long().clamp(0, L - 1)
            okc = (lm_rr >= 0) & state.lm_active[lmc] & cur_valid
            res_r = pose_opt.pose_optimization(R_pred, t_pred, state.lm_pos[lmc], cur_kpts,
                                               okc, cam_params, cam_kind=cam_kind,
                                               rounds=motion_rounds,
                                               iters_per_round=motion_iters,
                                               check_cost=False, invd=cur_invd, bf=bf)
            ref_ok = (torch.sum(okc, dtype=torch.int32) >= min_matches_ref_kf) & \
                (res_r.n_inliers >= min_inliers_track)
            R_r, t_r = res_r.R_cw, res_r.t_cw
            lm_r = torch.where(res_r.inliers, lm_rr, -1)
    stage1_ok = motion_ok | ref_ok
    R1 = torch.where(motion_ok, res_m.R_cw, torch.where(ref_ok, R_r, R_pred))
    t1 = torch.where(motion_ok, res_m.t_cw, torch.where(ref_ok, t_r, t_pred))
    cur_lm1 = torch.where(motion_ok, torch.where(res_m.inliers, cur_lm0, -1),
                          torch.where(ref_ok, lm_r, -1))

    # --- local-map stage ---
    with profiling.span("track.local_map"):
        if local_map_only:
            if local_mask is not None:
                search_mask = state.lm_active & local_mask
            else:
                W = ms.covisibility(state)
                nbrs = (W[ref_kf] > 0).index_fill(0, ref_kf.reshape(1).long(), True)
                obs = ms.observation_matrix(state)
                search_mask = state.lm_active & ((nbrs.float() @ obs) > 0)
        else:
            search_mask = state.lm_active
        search_mask = search_mask & (state.lm_map_id == state.active_map_id)
        uv, _, visible = assoc.project_landmarks(state.lm_pos, search_mask, R1, t1,
                                                 cam_params, cam_kind, image_hw,
                                                 max_depth=max_depth)
        anc = state.lm_anchor_kf.long().clamp(0, K - 1)
        C_a = -torch.einsum("lji,lj->li", state.kf_R_cw[anc], state.kf_t_cw[anc])
        C_c = -torch.einsum("ji,j->i", R1, t1)
        d_a = torch.linalg.norm(state.lm_pos - C_a, dim=-1)
        rel_c = state.lm_pos - C_c
        d_c = torch.linalg.norm(rel_c, dim=-1)
        has_n = torch.linalg.norm(state.lm_normal, dim=-1) > 0.5
        cosv = torch.sum(state.lm_normal * rel_c, dim=-1) / torch.clamp(d_c, min=1e-9)
        band = ADAPT_DEPTH_BAND
        gate_ok = (d_a > 1e-6) & (d_c >= d_a / band) & (d_c <= d_a * band) \
            & (~has_n | (cosv > ADAPT_COS_MIN))
        visible = visible & gate_ok
        rad_l = proj_radius * torch.where(cosv > 0.998, 0.5, 1.0)
        kpt_lm, _ = assoc.projection_match(uv, state.lm_desc.float(), visible, cur_kpts,
                                           cur_desc, cur_valid, radius=rad_l,
                                           th_desc2=desc_th2)
        cur_lm = torch.where(cur_lm1 >= 0, cur_lm1, kpt_lm)
        lm_c2 = cur_lm.long().clamp(0, L - 1)
        ok2 = (cur_lm >= 0) & cur_valid & state.lm_active[lm_c2]
        res_l = pose_opt.pose_optimization(R1, t1, state.lm_pos[lm_c2], cur_kpts, ok2,
                                           cam_params, cam_kind=cam_kind,
                                           rounds=local_rounds,
                                           iters_per_round=local_iters, check_cost=False,
                                           invd=cur_invd, bf=bf)
        cur_lm = torch.where(res_l.inliers, cur_lm, -1)
        pose_finite = torch.all(torch.isfinite(res_l.R_cw)) & torch.all(torch.isfinite(res_l.t_cw))
        ok = (res_l.n_inliers >= min_inliers_local_map) & pose_finite
        cos_dR = 0.5 * (torch.trace(res_l.R_cw @ R_pred.T) - 1.0)
        weak = (res_l.n_inliers >= min_inliers_weak) & pose_finite & ~ok & (cos_dR > 0.94)
        usable = ok | weak
        R2 = torch.where(usable, res_l.R_cw, R_pred)
        t2 = torch.where(usable, res_l.t_cw, t_pred)
        flags = torch.stack([ok.to(torch.int32), res_l.n_inliers.to(torch.int32),
                             stage1_ok.to(torch.int32), n_cand, weak.to(torch.int32)])
    return R2, t2, torch.where(usable, cur_lm, -1).to(torch.int32), flags


def _top_covis_for_frame(state: ms.MapState, frame_lidx, frame_valid, n: int = 2):
    """Top-n keyframes sharing landmarks with a not-yet-inserted frame."""
    has = (frame_lidx >= 0) & frame_valid
    obs = ms.observation_matrix(state)
    cols = obs[:, frame_lidx.long().clamp(0, state.L - 1)]
    w = torch.where(state.kf_active, cols @ has.float(), -1.0)
    wts, ids = scatterless.top_k(w, n)
    return torch.where(wts > 0, ids, -1).to(torch.int32)


def _insert_keyframe_body(state: ms.MapState, R, t, kpts, rays, desc, valid, lidx,
                          time, parent, cam_params, cam_kind, n_opt: int,
                          n_fixed: int, ba_iters: int, run_ba: bool = True,
                          ba_gate=None, ext_tri_ids=None, ext_tri_matches=None,
                          kpt_invd=None, bf=None):
    """Add KF -> covisibility -> triangulation against the top-2 covisible
    neighbours -> fusion -> descriptors -> windowed local BA (when run_ba and
    the bool tensor ba_gate, if given, holds) -> landmark statistics,
    recount, culling, normals and the local-map mask.
    Returns (state, scalars [kf_id, n_new0, n_new1, n_obs, n_kf, n_lm,
    lm_dropped], local_mask [L])."""
    K, L = state.K, state.L
    state, kf_id = ms.add_keyframe(state, R, t, kpts, rays, desc, valid, lidx,
                                   time, parent=parent, kpt_invd=kpt_invd)
    obs = ms.observation_matrix(state)
    W = obs @ obs.T
    W.fill_diagonal_(0.0)
    if ext_tri_ids is not None:
        ids = ext_tri_ids
        wts = W[kf_id, ids.long().clamp(0, K - 1)]
    else:
        ids, wts = ms.best_covisible(W, kf_id, 2)
    n_new = []
    for j in range(2):
        with profiling.span("insert.triangulate"):
            nbr = ids[j].long().clamp(0, K - 1)
            enabled = (ids[j] >= 0) & (wts[j] >= 10)
            state, n_j = _triangulate_pair_kernel_body(
                state, kf_id, nbr, cam_params, cam_kind, enabled,
                ext_matches=None if ext_tri_matches is None else ext_tri_matches[j])
        n_new.append(n_j)
    with profiling.span("insert.fuse"):
        state, _, _ = mnt.fuse_into_keyframe(state, kf_id, cam_params, cam_kind, obs=obs)
        state = mnt.update_distinctive_descriptors(state, kf_id, obs=obs)
    if run_ba and (ba_gate is None or bool(ba_gate)):
        with profiling.span("insert.local_ba"):
            window, opt_mask = _covis_window(state, kf_id, n_opt, n_fixed)
            state = _local_ba_body(state, window, opt_mask, cam_params, cam_kind, ba_iters,
                                   bf=bf)

    with profiling.span("insert.lm_stats"):
        # Landmark statistics + culling at keyframe rate. The frustum test uses
        # the default 480x640 image, as the JAX package's insert does.
        _, _, visible_l = assoc.project_landmarks(state.lm_pos, state.lm_active,
                                                  state.kf_R_cw[kf_id],
                                                  state.kf_t_cw[kf_id], cam_params,
                                                  cam_kind)
        li_kf = state.kf_landmark_idx[kf_id]
        found_l = scatterless.seg_any(li_kf, li_kf >= 0, L)
        state = mnt.update_found_visible(state, visible_l, found_l)
        obs2 = ms.observation_matrix(state)
        state = mnt.recount_lm_obs(state, obs=obs2)
        state = mnt.cull_landmarks(state)
        # Mean viewing direction over all observing keyframes.
        n_obs_l = obs2.sum(0)
        centers = -torch.einsum("kji,kj->ki", state.kf_R_cw, state.kf_t_cw)
        sum_c = obs2.T @ torch.where(state.kf_active[:, None], centers, 0.0)
        dirs = state.lm_pos * n_obs_l[:, None] - sum_c
        nn_ = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-9)
        state = state.replace(lm_normal=torch.where(
            (state.lm_active & (n_obs_l > 0))[:, None], nn_, state.lm_normal))
        # Local-map search mask: landmarks seen by this keyframe's neighbourhood.
        w_row = obs2 @ obs2[kf_id]
        nbrs = (w_row > 0).index_fill(0, kf_id.reshape(1).long(), True)
        local_mask = ((nbrs.float() @ obs2) > 0) & state.lm_active
        # Reference-KF tracked count for the keyframe policy: landmarks with >= 3
        # observations only.
        li_new = state.kf_landmark_idx[kf_id]
        li_c = li_new.long().clamp(0, L - 1)
        n_obs = torch.sum((li_new >= 0) & state.kf_kpt_valid[kf_id]
                          & state.lm_active[li_c] & (state.lm_n_obs[li_c] >= 3), dtype=torch.int32)
        scalars = torch.stack([kf_id.to(torch.int32), n_new[0].to(torch.int32),
                               n_new[1].to(torch.int32), n_obs, state.n_kf, state.n_lm,
                               state.lm_dropped])
    return state, scalars, local_mask


def _track_and_map_body(state: ms.MapState, policy, local_mask, prev_desc, prev_valid,
                        prev_lidx, cur_kpts, cur_rays, cur_desc, cur_valid, R_pred, t_pred,
                        time, cam_params, cam_kind, image_hw, min_matches_motion,
                        min_inliers_track, min_inliers_local_map, proj_radius, desc_th2,
                        kf_tracked_ratio, kf_min_interval, kf_max_interval, n_opt: int,
                        n_fixed: int, ba_iters: int, local_map_only: bool = False,
                        ext_matches=None, max_depth=100.0, min_matches_ref_kf=15,
                        motion_rounds: int = 2, motion_iters: int = 5,
                        local_rounds: int = 2, local_iters: int = 6, min_inliers_weak=12,
                        ba_every: int = 1, cur_invd=None, bf=None):
    """One frame of pipeline mode: the track step, then the keyframe policy on
    the device from this frame's own flags, then the keyframe insert when it
    fires, so the map grows at frame rate however far the host's finish lags.

    policy [3] f32 carry: (frames since the last insert, peak inliers since
    then, inserts since the last windowed BA). The policy is the host's
    (system._need_new_keyframe): weak-band urgency, the interval bounds, and
    the c2 test of the inliers' decay from their peak; a capacity guard keeps
    inserts out of a full table. With ba_every > 1 the windowed BA runs on
    every ba_every-th insert; the carry starts at 0, so the first ba_every-1
    inserts skip it (the JAX package's behaviour). local_mask [L] carries the
    local-map search mask. Deciding the insert fetches one bool (the JAX
    package's lax.cond).

    Returns (state, policy, local_mask, R, t, lm_idx, flags [8] int32 = [ok,
    n_inl, stage1_ok, n_cand, weak, did_insert, n_kf, n_lm]); lm_idx carries
    the insert's new registrations when one fired."""
    K, L, N = state.K, state.L, state.N
    R2, t2, cur_lm, tflags = _track_step_body(
        state, prev_desc, prev_valid, prev_lidx, cur_kpts, cur_desc, cur_valid, R_pred,
        t_pred, cam_params, cam_kind, image_hw, min_matches_motion, min_inliers_track,
        min_inliers_local_map, proj_radius, desc_th2,
        ref_kf=torch.clamp(state.n_kf - 1, min=0), local_map_only=local_map_only,
        ext_matches=ext_matches, max_depth=max_depth, min_matches_ref_kf=min_matches_ref_kf,
        motion_rounds=motion_rounds, motion_iters=motion_iters, local_rounds=local_rounds,
        local_iters=local_iters, local_mask=local_mask, min_inliers_weak=min_inliers_weak,
        cur_invd=cur_invd, bf=bf)
    ok, weak = tflags[0] > 0, tflags[4] > 0
    n_inl = tflags[1].float()
    fs, peak0, sba = policy[0], policy[1], policy[2]
    peak = torch.maximum(peak0, n_inl)
    c2 = n_inl < kf_tracked_ratio * torch.clamp(peak, min=20.0)
    need = weak | (fs >= kf_max_interval) | ((fs >= kf_min_interval) & c2)
    can = (state.n_kf < K) & (state.n_lm < L - 2 * N - 64)
    do_insert = (ok | weak) & need & can & (fs >= 1)
    ba_due = (sba + 1.0 >= float(ba_every)) | (ba_every <= 1)
    lm_idx = cur_lm
    if bool(do_insert):
        state, scal, local_mask = _insert_keyframe_body(
            state, R2, t2, cur_kpts, cur_rays, cur_desc, cur_valid, cur_lm, time,
            parent=torch.clamp(state.n_kf - 1, min=0), cam_params=cam_params,
            cam_kind=cam_kind, n_opt=n_opt, n_fixed=n_fixed, ba_iters=ba_iters,
            ba_gate=None if ba_every <= 1 else ba_due, kpt_invd=cur_invd, bf=bf)
        lm_idx = state.kf_landmark_idx[scal[0].long().clamp(0, K - 1)]
    zero = torch.zeros_like(fs)
    sba_next = torch.where(do_insert, torch.where(ba_due, zero, sba + 1.0), sba)
    policy = torch.where(do_insert, torch.stack([zero, n_inl, sba_next]),
                         torch.stack([fs + 1.0, peak, sba_next]))
    flags = torch.cat([tflags, torch.stack([do_insert.to(torch.int32), state.n_kf,
                                            state.n_lm])])
    return state, policy, local_mask, R2, t2, lm_idx, flags


def _reloc_expand(state: ms.MapState, active, cur_kpts, cur_desc, cur_valid, cam_params,
                  cam_kind, R, t, lm_in, radius):
    """One guided pass of relocalization (reference Relocalization's
    SearchByProjection): project the active map at (R, t), match within
    `radius` px keeping the associations already held, re-optimize.
    Returns (R, t, lm [N], n_inliers)."""
    L = state.L
    uv, _, visible = assoc.project_landmarks(state.lm_pos, active, R, t, cam_params, cam_kind)
    kpt_lm, _ = assoc.projection_match(uv, state.lm_desc.float(), visible, cur_kpts,
                                       cur_desc, cur_valid, radius=radius)
    lm2 = torch.where(lm_in >= 0, lm_in, kpt_lm)
    lc = lm2.long().clamp(0, L - 1)
    okc = (lm2 >= 0) & cur_valid & active[lc]
    r = pose_opt.pose_optimization(R, t, state.lm_pos[lc], cur_kpts, okc, cam_params,
                                   cam_kind=cam_kind, rounds=2, iters_per_round=6,
                                   check_cost=False)
    return r.R_cw, r.t_cw, torch.where(r.inliers, lm2, -1).to(torch.int32), r.n_inliers


def _reloc_guided(state, active, cur_kpts, cur_desc, cur_valid, cam_params, cam_kind,
                  R, t, lm):
    """The wide (10 px) then narrow (3 px) guided passes."""
    args = (state, active, cur_kpts, cur_desc, cur_valid, cam_params, cam_kind)
    R, t, lm, _ = _reloc_expand(*args, R, t, lm, 10.0)
    return _reloc_expand(*args, R, t, lm, 3.0)


def _finite(R, t):
    return torch.all(torch.isfinite(R)) & torch.all(torch.isfinite(t))


def _relocalize_kernel(state: ms.MapState, cur_kpts, cur_desc, cur_valid, cam_params,
                       generator=None, cam_kind: int = cameras.PINHOLE, samples=None):
    """Global relocalization: mutual-NN of the lost frame's descriptors
    against the whole active landmark table (kernel B2), PnP RANSAC, then
    the guided passes when PnP found a pose with >= 8 inliers. `samples`
    [300, 6] overrides the RANSAC draws. Returns (R, t, cur_lm [N], ok,
    n_inliers)."""
    L = state.L
    active = state.lm_active & (state.lm_map_id == state.active_map_id)
    matches, _ = assoc.mutual_nn_match(cur_desc, cur_valid, state.lm_desc.float(), active,
                                       ratio=0.8)
    mc = matches.long().clamp(0, L - 1)
    ok_m = matches >= 0
    res = pnp.pnp_ransac(state.lm_pos[mc], cur_kpts, ok_m, cam_params, generator,
                         cam_kind=cam_kind, samples=samples)
    R, t, n = res.R_cw, res.t_cw, res.n_inliers
    lm = torch.where(res.inliers & ok_m, matches, -1).to(torch.int32)
    if bool(res.success & (n >= 8)):
        R, t, lm, n = _reloc_guided(state, active, cur_kpts, cur_desc, cur_valid,
                                    cam_params, cam_kind, R, t, lm)
    return R, t, lm, res.success & _finite(R, t), n


def _reloc_from_kf_matches(state: ms.MapState, cand_ids, ext_matches, cur_kpts, cur_desc,
                           cur_valid, cam_params, generator=None,
                           cam_kind: int = cameras.PINHOLE, samples=None):
    """Relocalization from learned keyframe <-> frame matches: per candidate
    keyframe, carry its landmarks through the matches and solve PnP RANSAC
    (one draw per candidate, as the JAX package splits its key per
    candidate); the candidate with the most inliers wins and goes through
    the guided passes when it has >= 8. cand_ids [B], ext_matches [B, N]
    (candidate kpt -> frame kpt); `samples` [B, 300, 6] overrides the draws.
    Returns (R, t, cur_lm [N], ok, n_inliers)."""
    K, L, N = state.K, state.L, cur_kpts.shape[0]
    best = None
    for b in range(cand_ids.shape[0]):
        c, m = cand_ids[b], ext_matches[b]
        cc = c.long().clamp(0, K - 1)
        kf_lidx = state.kf_landmark_idx[cc]
        has = (m >= 0) & (kf_lidx >= 0) & state.kf_kpt_valid[cc]
        lm_of_cur = _gather_lm(kf_lidx, assoc.invert_matches(torch.where(has, m, -1), N), N)
        lc = lm_of_cur.long().clamp(0, L - 1)
        ok_m = (lm_of_cur >= 0) & cur_valid & state.lm_active[lc] & (c >= 0)
        res = pnp.pnp_ransac(state.lm_pos[lc], cur_kpts, ok_m, cam_params, generator,
                             cam_kind=cam_kind,
                             samples=None if samples is None else samples[b])
        n = torch.where(res.success & _finite(res.R_cw, res.t_cw) & (c >= 0),
                        res.n_inliers, -1)
        cand = (res.R_cw, res.t_cw, torch.where(res.inliers & ok_m, lm_of_cur, -1), n)
        # argmax: the first candidate with the most inliers wins
        best = cand if best is None else tuple(
            torch.where(cand[3] > best[3], x, y) for x, y in zip(cand, best))
    R, t, lm, nb = best
    n = torch.clamp(nb, min=0)
    if bool(nb >= 8):
        active = state.lm_active & (state.lm_map_id == state.active_map_id)
        R, t, lm, n = _reloc_guided(state, active, cur_kpts, cur_desc, cur_valid,
                                    cam_params, cam_kind, R, t, lm)
    return R, t, lm.to(torch.int32), (nb > 0) & _finite(R, t), n


def _relative_pose(R_prev, t_prev, R_cur, t_cur):
    Ri, ti = lie.se3_inverse(R_prev, t_prev)
    return lie.se3_compose(R_cur, t_cur, Ri, ti)


def _compose_pose(dR, dt, R1, t1):
    return lie.se3_compose(dR, dt, R1, t1)


def _rel_to_kf(state: ms.MapState, R_cw, t_cw, ref_slot: int):
    """T_cr = T_cw * T_rw^-1 (the trajectory log entry)."""
    R_cr = R_cw @ state.kf_R_cw[ref_slot].T
    return R_cr, t_cw - R_cr @ state.kf_t_cw[ref_slot]


def _count_kf_obs(state: ms.MapState, kf_id):
    return torch.sum((state.kf_landmark_idx[kf_id] >= 0) & state.kf_kpt_valid[kf_id],
                     dtype=torch.int32)


def _init_coords(rays0, rays1, matches):
    x0 = rays0[:, :2] / rays0[:, 2:]
    r1 = rays1[matches.long().clamp(0, rays1.shape[0] - 1)]
    return x0, r1[:, :2] / r1[:, 2:]


def _covis_window(state: ms.MapState, center_kf, n_opt: int, n_fixed: int):
    """Top covisible keyframes of center_kf: the first n_opt optimized, the
    next n_fixed fixed; keyframe 0 always fixed (gauge)."""
    obs = ms.observation_matrix(state)
    c = torch.as_tensor(center_kf, device=state.device).reshape(1).long()
    w_row = (obs @ obs[c[0]]).index_fill(0, c, 0.0)
    wts, ids = scatterless.top_k(w_row, n_opt + n_fixed - 1)
    ids = torch.where(wts > 0, ids, -1)
    window = torch.cat([c, ids]).to(torch.int32)
    opt_mask = (torch.arange(n_opt + n_fixed, device=state.device) < n_opt) & (window != 0)
    return window, opt_mask
