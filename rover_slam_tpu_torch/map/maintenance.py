"""Map maintenance: neighbourhood fusion, representative descriptors,
visibility statistics, exact observation counts, landmark culling, keyframe
culling and the global bundle adjustment.

Counterpart of rover_slam_tpu/map/maintenance.py. With a mesh of more than
one shard the global BA runs the landmark-sharded distributed solver
(parallel/sharded_ba.py).
"""
from __future__ import annotations

import math

import torch

from ..geometry import cameras
from ..ops import association as assoc
from ..ops import scatterless
from ..optim import ba
from ..parallel import sharded_ba
from . import map_state as ms


def cull_landmarks(state: ms.MapState, min_found_ratio: float = 0.05,
                   min_obs: int = 1, min_age_kf: int = 3) -> ms.MapState:
    """Deactivate weak landmarks (reference MapPointCulling)."""
    found_ratio = state.lm_found.float() / torch.clamp(state.lm_visible.float(), min=1.0)
    age = state.n_kf - state.lm_first_kf
    weak = (found_ratio < min_found_ratio) | ((age >= min_age_kf) & (state.lm_n_obs <= min_obs))
    kill = state.lm_active & weak & (state.lm_first_kf >= 0)
    return ms.remove_landmarks(state, kill)


def cull_keyframes(state: ms.MapState, redundancy: float = 0.9, min_kept_obs: int = 3):
    """(state, n_culled); see cull_keyframes_ex."""
    state, n, _ = cull_keyframes_ex(state, redundancy, min_kept_obs)
    return state, n


def cull_keyframes_ex(state: ms.MapState, redundancy: float = 0.9, min_kept_obs: int = 3):
    """Deactivate redundant keyframes: more than `redundancy` of their
    landmarks are observed by >= min_kept_obs other keyframes (reference
    KeyFrameCulling). Keyframes 0 and 1, the two newest and loop-edge
    endpoints are protected. Returns (state, n_culled, redirect); see
    _apply_kf_cull."""
    K = state.K
    obs = ms.observation_matrix(state)
    redundant_lm = (obs.sum(dim=0)[None, :] - obs) >= min_kept_obs
    n_own = obs.sum(dim=1)
    n_red = (obs * redundant_lm).sum(dim=1)
    frac = n_red / torch.clamp(n_own, min=1.0)
    ar = torch.arange(K, device=state.device)
    protect = (ar <= 1) | (ar >= state.n_kf - 2) | state.kf_loop_edges.any(dim=1)
    cull = state.kf_active & (frac > redundancy) & ~protect & (n_own > 0)
    return _apply_kf_cull(state, cull, obs)


def cull_oldest_ex(state: ms.MapState, n_free: int = 4, protect_recent: int = 8):
    """Capacity-pressure fallback when nothing is redundant: deactivate the
    n_free oldest keyframes of the active map, sparing loop-edge endpoints,
    stored maps and the newest protect_recent. Returns like
    cull_keyframes_ex."""
    act = state.kf_active & (state.kf_map_id == state.active_map_id)
    rank = torch.cumsum(act.to(torch.int32), 0) - 1
    recent = rank >= torch.sum(act, dtype=torch.int32) - protect_recent
    cand = act & ~state.kf_loop_edges.any(dim=1) & ~recent
    cull = cand & (torch.cumsum(cand.to(torch.int32), 0) - 1 < n_free)
    return _apply_kf_cull(state, cull, ms.observation_matrix(state))


def _apply_kf_cull(state: ms.MapState, cull, obs):
    """Keyframe removal (reference KeyFrame::SetBadFlag): children re-parented
    to their first surviving ancestor by pointer jumping (ceil(log2 K) hops
    resolve any culled chain), observation counts decremented, observations
    cleared. redirect = (cull [K], surviving parent [K] int32 (-1 where not
    culled or none survives), R_cp [K,3,3], t_cp [K,3]): each culled
    keyframe's pose relative to that ancestor, frozen now, so trajectory
    reconstitution can chain through it."""
    K = state.K

    def culled_at(p):
        return (p >= 0) & cull[p.long().clamp(0, K - 1)]

    parent = state.kf_parent
    for _ in range(max(1, math.ceil(math.log2(max(K, 2))))):
        parent = torch.where(culled_at(parent), parent[parent.long().clamp(0, K - 1)], parent)
    surv = torch.where(culled_at(parent), -1, parent)
    sc = surv.long().clamp(0, K - 1)
    R_cp = torch.einsum("kij,klj->kil", state.kf_R_cw, state.kf_R_cw[sc])
    t_cp = state.kf_t_cw - torch.einsum("kij,kj->ki", R_cp, state.kf_t_cw[sc])
    redirect = (cull, torch.where(cull, surv, -1).to(torch.int32), R_cp, t_cp)
    dropped = (obs * cull[:, None].float()).sum(dim=0)
    state = state.replace(
        kf_active=state.kf_active & ~cull,
        kf_landmark_idx=torch.where(cull[:, None], -1, state.kf_landmark_idx),
        kf_parent=torch.where(cull, -1, parent).to(torch.int32),
        lm_n_obs=torch.clamp(state.lm_n_obs - dropped.to(torch.int32), min=0))
    return state, torch.sum(cull, dtype=torch.int32), redirect


def fuse_into_keyframe(state: ms.MapState, kf_id, cam_params,
                       cam_kind: int = cameras.PINHOLE, radius: float = 3.0,
                       th_desc2: float = 1.44, obs=None):
    """Project landmarks seen by covisible neighbours into keyframe kf_id; a
    projection that lands on a keypoint holding a different landmark fuses
    the two (the more-observed wins), and empty keypoints gain observations.
    `obs` is an optional precomputed observation matrix (the insert shares
    one build). Returns (state, n_fused, n_added)."""
    K, L, N = state.K, state.L, state.N
    dev = state.device
    if obs is None:
        obs = ms.observation_matrix(state)
    W = obs @ obs.T
    W.fill_diagonal_(0.0)
    nbr = (W[kf_id] > 0) & (torch.arange(K, device=dev) != kf_id)
    seen_by_nbr = (nbr.float() @ obs) > 0
    observed_here = obs[kf_id] > 0
    cand = state.lm_active & seen_by_nbr & ~observed_here
    uv, _, visible = assoc.project_landmarks(
        state.lm_pos, cand, state.kf_R_cw[kf_id], state.kf_t_cw[kf_id],
        cam_params, cam_kind)
    kpt_lm, _ = assoc.projection_match(
        uv, state.lm_desc.float(), visible, state.kf_kpts[kf_id],
        state.kf_desc[kf_id].float(), state.kf_kpt_valid[kf_id],
        radius=radius, th_desc2=th_desc2)
    li = state.kf_landmark_idx[kf_id]
    proj = kpt_lm
    pc = proj.long().clamp(0, L - 1)
    lc = li.long().clamp(0, L - 1)

    # Duplicate fusion: the projected landmark collides with an existing one.
    dup = (proj >= 0) & (li >= 0) & (proj != li)
    n_p, n_l = state.lm_n_obs[pc], state.lm_n_obs[lc]
    keep_proj = (n_p > n_l) | ((n_p == n_l) & (pc < lc))
    winner = torch.where(keep_proj, proj, li)
    loser = torch.where(keep_proj, li, proj)
    ar_L = torch.arange(L, dtype=torch.int32, device=dev)
    table = scatterless.seg_pick(torch.where(dup, loser, -1), winner, dup, L,
                                 ar_L).to(torch.int32)
    table = table[table.long()]
    killed = scatterless.seg_any(torch.where(dup, loser, -1), dup, L)
    state = ms.replace_landmark_ids(state, table)
    state = state.replace(lm_active=state.lm_active & ~killed)

    # New observations on empty keypoint slots.
    li2 = state.kf_landmark_idx[kf_id]
    proj2 = torch.where(proj >= 0, table[pc], -1)
    add = ((proj2 >= 0) & (li2 < 0) & state.kf_kpt_valid[kf_id]
           & state.lm_active[proj2.long().clamp(0, L - 1)])
    li_new = torch.where(add, proj2, li2)
    kf_row = torch.as_tensor(kf_id, device=dev).reshape(1).long()
    state = state.replace(kf_landmark_idx=state.kf_landmark_idx.index_copy(
        0, kf_row, li_new[None].to(torch.int32)))

    # Incremental observation counts: winners absorb the losers' counts
    # (deduped against keyframes already observing the winner), losers zero
    # out, newly added observations count one.
    w_c = winner.long().clamp(0, L - 1)
    l_c = loser.long().clamp(0, L - 1)
    overlap = torch.einsum("kn,kn->n", obs[:, w_c], obs[:, l_c])
    absorbed = torch.clamp(state.lm_n_obs[l_c].float() - overlap, min=0.0)
    gained = scatterless.seg_add(torch.where(dup, winner, -1),
                                 torch.where(dup, absorbed, 0.0)[:, None], L)[:, 0]
    added = scatterless.seg_count(torch.where(add, proj2, -1), L)
    lm_n_obs = torch.where(killed, 0, state.lm_n_obs + gained.to(torch.int32) + added)
    state = state.replace(lm_n_obs=lm_n_obs.to(torch.int32))
    return state, torch.sum(dup), torch.sum(add)


def recount_lm_obs(state: ms.MapState, obs=None) -> ms.MapState:
    """Exact landmark observation counts: column sums of the observation
    matrix."""
    if obs is None:
        obs = ms.observation_matrix(state)
    return state.replace(lm_n_obs=torch.sum(obs, dim=0).to(torch.int32))


def update_distinctive_descriptors(state: ms.MapState, kf_id, n_obs_kfs: int = 12,
                                   obs=None) -> ms.MapState:
    """For every landmark observed by kf_id, set its descriptor to the
    observation descriptor with the minimum median L2^2 to the others; the
    observations are taken from kf_id and its top covisible keyframes."""
    K, L, N = state.K, state.L, state.N
    dev = state.device
    O = min(n_obs_kfs, K)
    D = state.lm_desc.shape[1]
    li = state.kf_landmark_idx[kf_id]
    touched = li.long().clamp(0, L - 1)
    t_valid = (li >= 0) & state.kf_kpt_valid[kf_id] & state.lm_active[touched]

    if obs is None:
        obs = ms.observation_matrix(state)
    kf_row = torch.as_tensor(kf_id, device=dev).reshape(1).long()
    w_row = (obs @ obs[kf_id]).index_fill(0, kf_row, 0.0)
    nbr_w, nbr_ids = scatterless.top_k(w_row, O - 1)
    nbr_ids = torch.where(nbr_w > 0, nbr_ids, -1)
    obs_kfs = torch.cat([kf_row, nbr_ids])
    obs_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nbr_ids >= 0])
    ok_c = obs_kfs.clamp(0, K - 1)

    li_all = state.kf_landmark_idx[ok_c]                       # [O, N]
    lm_of = torch.where((li_all >= 0) & state.kf_kpt_valid[ok_c]
                        & (state.kf_active[ok_c] & obs_ok)[:, None],
                        li_all.long(), -2)
    eq = lm_of[None, :, :] == touched[:, None, None]           # [N, O, N]
    ar_n = torch.arange(N, device=dev)
    slot_tk = torch.where(eq, ar_n[None, None, :], N).amin(dim=2)   # [N, O]
    has_obs = slot_tk < N

    desc_pad = torch.cat([state.kf_desc[ok_c],
                          torch.zeros((O, 1, D), dtype=state.kf_desc.dtype, device=dev)],
                         dim=1)
    obs_desc = desc_pad[torch.arange(O, device=dev)[None, :],
                        slot_tk.clamp(0, N)].float()           # [N, O, D]
    sq = torch.sum(obs_desc ** 2, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum("nkd,nqd->nkq",
                                                              obs_desc, obs_desc)
    big = 1e9
    pair_ok = has_obs[:, :, None] & has_obs[:, None, :]
    d2 = torch.where(pair_ok, torch.clamp(d2, min=0.0), torch.nan)
    med = torch.nanquantile(d2, 0.5, dim=2)                    # numpy-style median
    med = torch.where(has_obs, med, big)
    best_k = torch.argmin(med, dim=1)
    new_desc = obs_desc[torch.arange(N, device=dev), best_k]
    write = t_valid & (med.amin(dim=1) < big)
    lm_desc = scatterless.seg_pick(torch.where(write, touched, -1),
                                   new_desc.to(state.lm_desc.dtype), write, L,
                                   state.lm_desc)
    return state.replace(lm_desc=lm_desc)


def update_found_visible(state: ms.MapState, visible_mask, found_mask) -> ms.MapState:
    """Landmark statistics (reference MapPoint::IncreaseVisible/Found)."""
    return state.replace(lm_visible=state.lm_visible + visible_mask.to(torch.int32),
                         lm_found=state.lm_found + found_mask.to(torch.int32))


def _build_global_problem(state: ms.MapState, cam_params, e_cap: int | None = None,
                          bf=None):
    """Full-map BA problem: every (keyframe, keypoint slot) observation of an
    active landmark. e_cap compacts the edge list to a static size with an
    order-preserving gather padded by edge 0 (jnp.nonzero(size=e_cap,
    fill_value=0)); with bf (stereo) the edges carry the keypoints' inverse
    depths, gathered alike. Returns (problem, gather indices or None)."""
    K, N, L = state.K, state.N, state.L
    dev = state.device
    li = state.kf_landmark_idx
    has = (li >= 0) & state.kf_kpt_valid & state.kf_active[:, None]
    e_lm = torch.where(has, li, 0).reshape(-1).long().clamp(0, L - 1)
    e_valid = has.reshape(-1) & state.lm_active[e_lm]
    e_kf = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    e_uv = state.kf_kpts.reshape(-1, 2)
    e_invd = None if bf is None else state.kf_kpt_invd.reshape(-1)
    idx = None
    if e_cap is not None and e_cap < K * N:
        idx = scatterless.nonzero_static(e_valid, e_cap, 0)
        n_val = torch.sum(e_valid)
        e_kf, e_lm, e_uv = e_kf[idx], e_lm[idx], e_uv[idx]
        e_valid = torch.arange(e_cap, device=dev) < n_val
        if e_invd is not None:
            e_invd = e_invd[idx]
    prob = ba.BAProblem(
        R_cw=state.kf_R_cw, t_cw=state.kf_t_cw,
        pose_opt_mask=state.kf_active & (torch.arange(K, device=dev) != 0),
        lm_pos=state.lm_pos, lm_opt_mask=state.lm_active, cam_params=cam_params,
        e_kf=e_kf.to(torch.int32), e_lm=e_lm.to(torch.int32), e_uv=e_uv, e_valid=e_valid,
        e_info=torch.ones(e_valid.shape, dtype=torch.float32, device=dev),
        e_invd=e_invd, bf=bf)
    return prob, idx


# (e_cap, lm_cap) ladder of the compacted global BA: the host picks the
# smallest level that fits the live map with ~30 % headroom.
GBA_LEVELS = ((16384, 4096), (65536, 8192), (262144, 16384), (1048576, 65536))


def gba_level_for(n_edges: int) -> int:
    for i, (e_cap, _) in enumerate(GBA_LEVELS):
        if n_edges * 1.3 <= e_cap:
            return i
    return len(GBA_LEVELS) - 1


def count_global_edges(state: ms.MapState) -> int:
    """Live observation count (one host read; once per fired loop)."""
    li = state.kf_landmark_idx
    has = (li >= 0) & state.kf_kpt_valid & state.kf_active[:, None]
    lm = torch.where(has, li, 0).long().clamp(0, state.L - 1)
    return int(torch.sum(has & state.lm_active[lm]))


def _global_ba_single(state: ms.MapState, cam_params, cam_kind: int, iters: int,
                      e_cap: int | None = None, lm_cap: int | None = None,
                      bf=None) -> ms.MapState:
    K, N, L = state.K, state.N, state.L
    if e_cap is not None and e_cap >= K * N:
        e_cap = None
    if lm_cap is not None and lm_cap >= L:
        lm_cap = None
    prob, idx = _build_global_problem(state, cam_params, e_cap=e_cap, bf=bf)
    # kf_major=True as in the JAX package, also for the compacted edge list,
    # whose rows are not keyframe-major: the pose-side sums then group edges
    # by position (ROADMAP.md §C), and the port reproduces that.
    res = ba.solve_ba(prob, cam_kind=cam_kind, iters=iters, cg_iters=25, solver="pcg",
                      phases=2, lm_cap=lm_cap)
    bad = (~res.e_inlier) & prob.e_valid
    if idx is not None:
        # Padding gathers edge 0 and writes after the real edges: the last
        # write wins, as the JAX package's scatter resolves it on the CPU.
        last = torch.full((K * N,), -1, dtype=torch.long, device=bad.device)
        last = last.scatter_reduce(0, idx, torch.arange(idx.shape[0], device=bad.device),
                                   reduce="amax")
        bad = torch.where(last >= 0, bad[last.clamp(min=0)], False)
    li_new = torch.where(bad.reshape(K, N), -1, state.kf_landmark_idx)
    return state.replace(kf_R_cw=res.R_cw, kf_t_cw=res.t_cw, lm_pos=res.lm_pos,
                         kf_landmark_idx=li_new)


def global_ba(state: ms.MapState, cam_params, cam_kind: int = cameras.PINHOLE,
              iters: int = 10, mesh=None, bf=None, level: int | None = None) -> ms.MapState:
    """Full-map bundle adjustment (reference GlobalBundleAdjustemnt after a
    loop closure): LM with the PCG solver over every active keyframe and
    landmark, at the compaction level `level` of GBA_LEVELS (None: the whole
    padded edge table); bf adds the stereo rows.

    mesh: a parallel.sharded_ba.Mesh; with more than one shard the solve is
    solve_ba_sharded_lm on the whole padded table (landmark math
    shard-local, only the pose vector crosses shards), as in the JAX
    package: `level` and bf are not used, and no outlier is dropped."""
    if mesh is not None and mesh.size > 1:
        prob, _ = _build_global_problem(state, cam_params)
        R, t, lm_pos, _ = sharded_ba.solve_ba_sharded_lm(prob, mesh, cam_kind=cam_kind,
                                                         iters=iters, cg_iters=25)
        return state.replace(kf_R_cw=R, kf_t_cw=t, lm_pos=lm_pos[:state.L])
    e_cap = lm_cap = None
    if level is not None:
        e_cap, lm_cap = GBA_LEVELS[min(level, len(GBA_LEVELS) - 1)]
    return _global_ba_single(state, cam_params, cam_kind=cam_kind, iters=iters,
                             e_cap=e_cap, lm_cap=lm_cap, bf=bf)
