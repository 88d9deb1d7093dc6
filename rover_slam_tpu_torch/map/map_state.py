"""Device-resident SLAM map as fixed-capacity padded tensors.

Counterpart of rover_slam_tpu/map/map_state.py, for the monocular and
monocular-inertial slices: `MapState` is a dataclass of tensors updated
functionally with `dataclasses.replace` (the stereo field of the JAX MapState
belongs to a later slice). Observations are the table kf_landmark_idx[K, N]
(keypoint slot -> landmark id or -1); covisibility is one product of the
[K, L] observation indicator with itself. `compact_map` packs the live slots
to the front of both tables and returns the renumbering.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import scatterless

FIELDS = ("kf_R_cw", "kf_t_cw", "kf_R_wb", "kf_p_wb", "kf_v_wb", "kf_bg", "kf_ba",
          "kf_time", "kf_kpts", "kf_rays", "kf_desc", "kf_kpt_valid", "kf_kpt_invd",
          "kf_landmark_idx",
          "kf_active", "kf_map_id",
          "kf_parent", "kf_loop_edges", "lm_pos", "lm_desc", "lm_normal", "lm_active",
          "lm_map_id", "lm_anchor_kf", "lm_n_obs", "lm_found", "lm_visible",
          "lm_first_kf", "n_kf", "n_lm", "active_map_id", "lm_dropped")


@dataclasses.dataclass
class MapState:
    # --- keyframes (capacity K, N keypoint slots each) ---
    kf_R_cw: torch.Tensor        # [K,3,3] world->camera rotation
    kf_t_cw: torch.Tensor        # [K,3]
    kf_R_wb: torch.Tensor        # [K,3,3] body(IMU)->world rotation
    kf_p_wb: torch.Tensor        # [K,3]
    kf_v_wb: torch.Tensor        # [K,3] velocity
    kf_bg: torch.Tensor          # [K,3] gyro bias
    kf_ba: torch.Tensor          # [K,3] accel bias
    kf_time: torch.Tensor        # [K]
    kf_kpts: torch.Tensor        # [K,N,2] pixel coords
    kf_rays: torch.Tensor        # [K,N,3] bearing rays (z=1)
    kf_desc: torch.Tensor        # [K,N,D]
    kf_kpt_valid: torch.Tensor   # [K,N] bool
    kf_kpt_invd: torch.Tensor    # [K,N] stereo inverse depth of the keypoint
                                 # (-1 = mono / no right-eye match): the metric
                                 # observation of every solver's third row
    kf_landmark_idx: torch.Tensor  # [K,N] int32, -1 = no landmark
    kf_active: torch.Tensor      # [K] bool
    kf_map_id: torch.Tensor      # [K] int32
    kf_parent: torch.Tensor      # [K] int32 spanning-tree parent (-1 root)
    kf_loop_edges: torch.Tensor  # [K,K] bool loop/merge edges (culling spares them)
    # --- landmarks (capacity L) ---
    lm_pos: torch.Tensor         # [L,3]
    lm_desc: torch.Tensor        # [L,D]
    lm_normal: torch.Tensor      # [L,3] mean viewing direction
    lm_active: torch.Tensor      # [L] bool
    lm_map_id: torch.Tensor      # [L] int32
    lm_anchor_kf: torch.Tensor   # [L] int32
    lm_n_obs: torch.Tensor       # [L] int32
    lm_found: torch.Tensor       # [L] int32
    lm_visible: torch.Tensor     # [L] int32
    lm_first_kf: torch.Tensor    # [L] int32
    # --- counters (0-dim int32 tensors on the map's device) ---
    n_kf: torch.Tensor
    n_lm: torch.Tensor
    active_map_id: torch.Tensor
    lm_dropped: torch.Tensor

    @property
    def K(self) -> int:
        return self.kf_active.shape[0]

    @property
    def L(self) -> int:
        return self.lm_active.shape[0]

    @property
    def N(self) -> int:
        return self.kf_kpt_valid.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_active.device

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)


def empty_map(K: int = 256, N: int = 1024, L: int = 16384, D: int = 256,
              device=None) -> MapState:
    f, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return MapState(
        kf_R_cw=torch.eye(3, device=device).repeat(K, 1, 1),
        kf_t_cw=z(K, 3), kf_R_wb=torch.eye(3, device=device).repeat(K, 1, 1),
        kf_p_wb=z(K, 3), kf_v_wb=z(K, 3), kf_bg=z(K, 3), kf_ba=z(K, 3),
        kf_time=z(K), kf_kpts=z(K, N, 2), kf_rays=z(K, N, 3),
        kf_desc=z(K, N, D), kf_kpt_valid=z(K, N, dtype=torch.bool),
        kf_kpt_invd=full((K, N), -1.0, f),
        kf_landmark_idx=full((K, N), -1, i32), kf_active=z(K, dtype=torch.bool),
        kf_map_id=z(K, dtype=i32), kf_parent=full((K,), -1, i32),
        kf_loop_edges=z(K, K, dtype=torch.bool),
        lm_pos=z(L, 3), lm_desc=z(L, D), lm_normal=z(L, 3),
        lm_active=z(L, dtype=torch.bool), lm_map_id=z(L, dtype=i32),
        lm_anchor_kf=full((L,), -1, i32), lm_n_obs=z(L, dtype=i32),
        lm_found=full((L,), 1, i32), lm_visible=full((L,), 1, i32),
        lm_first_kf=full((L,), -1, i32),
        n_kf=z(dtype=i32), n_lm=z(dtype=i32), active_map_id=z(dtype=i32),
        lm_dropped=z(dtype=i32))


def map_state_from_numpy(fields: dict, device=None) -> MapState:
    """Build a MapState from numpy arrays named as the JAX MapState's fields
    (extra fields of the JAX state are ignored)."""
    return MapState(**{k: torch.tensor(fields[k], device=device) for k in FIELDS})


def _set_row(arr: torch.Tensor, k: torch.Tensor, ok: torch.Tensor, val) -> torch.Tensor:
    """arr with row k set to val where ok (the row is left as it was when the
    write is dropped)."""
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    row = torch.where(ok, val, arr[k])
    return arr.index_copy(0, k.reshape(1).long(), row[None])


def add_keyframe(state: MapState, R_cw, t_cw, kpts, rays, desc, kpt_valid,
                 landmark_idx, time, R_wb=None, p_wb=None, v_wb=None, bg=None, ba=None,
                 parent=None, kpt_invd=None):
    """Insert a keyframe at the next free slot; the write is dropped when the
    table is full. The body state (R_wb ... ba) is written where given;
    kpt_invd [N] is the stereo inverse depth (-1 everywhere when None).
    Returns (new_state, kf_id)."""
    k = state.n_kf
    ok = k < state.K
    kc = torch.clamp(k, max=state.K - 1)
    par = -1 if parent is None else parent

    def body(name, val):
        arr = getattr(state, name)
        return arr if val is None else _set_row(arr, kc, ok, val)

    new = state.replace(
        kf_R_wb=body("kf_R_wb", R_wb), kf_p_wb=body("kf_p_wb", p_wb),
        kf_v_wb=body("kf_v_wb", v_wb), kf_bg=body("kf_bg", bg), kf_ba=body("kf_ba", ba),
        kf_R_cw=_set_row(state.kf_R_cw, kc, ok, R_cw),
        kf_t_cw=_set_row(state.kf_t_cw, kc, ok, t_cw),
        kf_kpts=_set_row(state.kf_kpts, kc, ok, kpts),
        kf_rays=_set_row(state.kf_rays, kc, ok, rays),
        kf_desc=_set_row(state.kf_desc, kc, ok, desc),
        kf_kpt_valid=_set_row(state.kf_kpt_valid, kc, ok, kpt_valid),
        kf_kpt_invd=_set_row(state.kf_kpt_invd, kc, ok, -1.0 if kpt_invd is None
                             else kpt_invd),
        kf_landmark_idx=_set_row(state.kf_landmark_idx, kc, ok, landmark_idx),
        kf_time=_set_row(state.kf_time, kc, ok, time),
        kf_active=_set_row(state.kf_active, kc, ok, ok),
        kf_map_id=_set_row(state.kf_map_id, kc, ok, state.active_map_id),
        kf_parent=_set_row(state.kf_parent, kc, ok, par),
        n_kf=torch.where(ok, k + 1, k),
    )
    obs_lm = torch.where(kpt_valid, landmark_idx, -1)
    counts = scatterless.seg_count(obs_lm, state.L)
    new = new.replace(lm_n_obs=torch.where(ok, new.lm_n_obs + counts, new.lm_n_obs))
    return new, kc


def add_landmarks(state: MapState, positions, descs, normals, anchor_kf,
                  valid_mask):
    """Append B landmarks at the next free slots (compacted by mask).
    Returns (new_state, slot_ids [B] int32, -1 where invalid or overflow)."""
    ranks = torch.cumsum(valid_mask.to(torch.int32), 0) - 1
    slots = torch.where(valid_mask, state.n_lm + ranks, -1)
    in_cap = slots < state.L
    slots = torch.where(in_cap, slots, -1).to(torch.int32)
    write = slots >= 0
    # Scatter targets; rows not written go to a spill slot that is dropped.
    tgt = torch.where(write, slots.long(), state.L)

    def setl(arr, val):
        val = torch.as_tensor(val, device=arr.device).to(arr.dtype)
        val = val.expand((tgt.shape[0],) + tuple(arr.shape[1:]))
        return torch.cat([arr, arr[:1]]).index_put((tgt,), val)[:-1]

    n_valid = torch.sum(valid_mask, dtype=torch.int32)
    new = state.replace(
        lm_pos=setl(state.lm_pos, positions),
        lm_desc=setl(state.lm_desc, descs),
        lm_normal=setl(state.lm_normal, normals),
        lm_active=setl(state.lm_active, True),
        lm_map_id=setl(state.lm_map_id, state.active_map_id),
        lm_anchor_kf=setl(state.lm_anchor_kf, anchor_kf),
        lm_first_kf=setl(state.lm_first_kf, anchor_kf),
        lm_n_obs=setl(state.lm_n_obs, 0),
        n_lm=torch.clamp(state.n_lm + n_valid, max=state.L),
        lm_dropped=state.lm_dropped + torch.sum(valid_mask & ~in_cap, dtype=torch.int32),
    )
    return new, slots


def observation_matrix(state: MapState) -> torch.Tensor:
    """[K, L] float32 indicator: keyframe k observes active landmark l
    (duplicate observations count once)."""
    K, L, N = state.K, state.L, state.N
    li = state.kf_landmark_idx
    cols = torch.where(state.kf_kpt_valid & (li >= 0) & (li < L), li.long(), L)
    obs = torch.zeros((K, L + 1), dtype=torch.float32, device=state.device)
    rows = torch.arange(K, device=state.device)[:, None].expand(K, N)
    obs[rows, cols] = 1.0
    obs = obs[:, :L] * state.lm_active[None, :].float()
    return obs * state.kf_active[:, None].float()


def covisibility(state: MapState) -> torch.Tensor:
    """Dense [K, K] int32 shared-landmark counts, diagonal zeroed."""
    obs = observation_matrix(state)
    W = obs @ obs.T
    W.fill_diagonal_(0.0)
    return W.to(torch.int32)


def covisibility_row(state: MapState, kf_id) -> torch.Tensor:
    """One keyframe's [K] int32 shared-landmark counts, self zeroed."""
    obs = observation_matrix(state)
    row = obs @ obs[kf_id]
    row = row.index_fill(0, torch.as_tensor(kf_id, device=row.device).reshape(1).long(), 0.0)
    return row.to(torch.int32)


def best_covisible(W: torch.Tensor, kf_id, n: int):
    """Top-n covisible keyframes of kf_id. Returns (ids [n], weights [n])."""
    weights, ids = scatterless.top_k(W[kf_id], n)
    return torch.where(weights > 0, ids, -1).to(torch.int32), weights


def remove_landmarks(state: MapState, kill_mask: torch.Tensor) -> MapState:
    """Deactivate landmarks and clear their observations."""
    li = state.kf_landmark_idx
    obs_killed = (li >= 0) & kill_mask[li.long().clamp(0, state.L - 1)]
    return state.replace(lm_active=state.lm_active & ~kill_mask,
                         kf_landmark_idx=torch.where(obs_killed, -1, li))


def replace_landmark_ids(state: MapState, old_to_new: torch.Tensor) -> MapState:
    """Apply a landmark substitution table [L] to every observation slot."""
    li = state.kf_landmark_idx
    mapped = torch.where(li >= 0, old_to_new[li.long().clamp(0, state.L - 1)], li)
    return state.replace(kf_landmark_idx=mapped.to(torch.int32))


# ---------------------------------------------------------------------------
# Slot compaction (capacity recycling)
# ---------------------------------------------------------------------------

def _pack_indices(keep: torch.Tensor):
    """Order-preserving pack of the True slots of keep [n]. Returns
    (old_of_new [n] gather indices, 0 past the count; new_live [n] bool;
    old2new [n] int32, -1 where dropped)."""
    n = keep.shape[0]
    cnt = torch.cumsum(keep.to(torch.int32), 0)
    old2new = torch.where(keep, cnt - 1, -1).to(torch.int32)
    old_of_new = scatterless.nonzero_static(keep, n, 0)
    new_live = torch.arange(n, device=keep.device) < cnt[-1]
    return old_of_new, new_live, old2new


def compact_map(state: MapState):
    """Pack active keyframes and landmarks to the front of their tables,
    keeping their order, and remap every index that points into them.
    Landmarks whose anchor keyframe is gone are re-anchored to their first
    surviving observer; landmarks with no surviving observer are dropped.
    Returns (new_state, kf_old2new [K] int32, lm_old2new [L] int32), -1 for a
    dropped slot."""
    K, L = state.K, state.L
    kf_of, kf_live, kf_o2n = _pack_indices(state.kf_active)

    obs = observation_matrix(state) > 0                    # [K, L]
    has_obs = obs.any(dim=0)
    first_obs = obs.to(torch.uint8).argmax(dim=0).to(torch.int32)
    anc = state.lm_anchor_kf
    anc_ok = (anc >= 0) & (kf_o2n[anc.long().clamp(0, K - 1)] >= 0)
    anc_res = torch.where(anc_ok, anc, torch.where(has_obs, first_obs, -1))
    lm_keep = state.lm_active & (anc_res >= 0)
    lm_of, lm_live, lm_o2n = _pack_indices(lm_keep)

    def gather(arr, of, live, fill=None):
        g = arr[of]
        if fill is None:
            return g
        return torch.where(live.reshape((-1,) + (1,) * (arr.dim() - 1)), g, fill)

    def gk(arr, fill=None):
        return gather(arr, kf_of, kf_live, fill)

    def gl(arr, fill=None):
        return gather(arr, lm_of, lm_live, fill)

    def remap(table, ids, n):
        return torch.where(ids >= 0, table[ids.long().clamp(0, n - 1)], -1)

    li_new = torch.where(kf_live[:, None], remap(lm_o2n, state.kf_landmark_idx[kf_of], L), -1)
    par_new = torch.where(kf_live, remap(kf_o2n, state.kf_parent[kf_of], K), -1)
    loops = state.kf_loop_edges[kf_of][:, kf_of] & kf_live[:, None] & kf_live[None, :]
    anc_new = torch.where(lm_live, kf_o2n[anc_res[lm_of].long().clamp(0, K - 1)], -1)
    fkf = state.lm_first_kf[lm_of]
    fkf_new = torch.where(fkf >= 0, kf_o2n[fkf.long().clamp(0, K - 1)], 0)
    fkf_new = torch.where(lm_live, torch.clamp(fkf_new, min=0), -1)

    new = state.replace(
        kf_R_cw=gk(state.kf_R_cw), kf_t_cw=gk(state.kf_t_cw),
        kf_R_wb=gk(state.kf_R_wb), kf_p_wb=gk(state.kf_p_wb), kf_v_wb=gk(state.kf_v_wb),
        kf_bg=gk(state.kf_bg), kf_ba=gk(state.kf_ba), kf_time=gk(state.kf_time),
        kf_kpts=gk(state.kf_kpts), kf_rays=gk(state.kf_rays), kf_desc=gk(state.kf_desc),
        kf_kpt_valid=gk(state.kf_kpt_valid, False),
        kf_kpt_invd=gk(state.kf_kpt_invd, -1.0),
        kf_landmark_idx=li_new.to(torch.int32),
        kf_active=kf_live & gk(state.kf_active),
        kf_map_id=gk(state.kf_map_id),
        kf_parent=par_new.to(torch.int32),
        kf_loop_edges=loops,
        lm_pos=gl(state.lm_pos), lm_desc=gl(state.lm_desc), lm_normal=gl(state.lm_normal),
        lm_active=lm_live & gl(lm_keep),
        lm_map_id=gl(state.lm_map_id),
        lm_anchor_kf=anc_new.to(torch.int32),
        lm_n_obs=gl(state.lm_n_obs, 0),
        lm_found=gl(state.lm_found, 1),
        lm_visible=gl(state.lm_visible, 1),
        lm_first_kf=fkf_new.to(torch.int32),
        n_kf=torch.sum(state.kf_active, dtype=torch.int32),
        n_lm=torch.sum(lm_keep, dtype=torch.int32))
    return new, kf_o2n, lm_o2n


def remap_landmark_refs(lidx: torch.Tensor, lm_old2new: torch.Tensor) -> torch.Tensor:
    """A frame's per-keypoint landmark ids through a compaction table."""
    L = lm_old2new.shape[0]
    return torch.where(lidx >= 0, lm_old2new[lidx.long().clamp(0, L - 1)], -1).to(torch.int32)


def compute_normals_and_depths(state: MapState) -> MapState:
    """Landmark viewing normals from their anchor keyframes' centres (the
    anchor-based part of the reference's MapPoint::UpdateNormalAndDepth);
    inactive landmarks keep theirs."""
    anchor = torch.clamp(state.lm_anchor_kf, 0, state.K - 1).long()
    R_cw, t_cw = state.kf_R_cw[anchor], state.kf_t_cw[anchor]
    centers = -torch.einsum("lji,lj->li", R_cw, t_cw)
    d = state.lm_pos - centers
    n = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    return state.replace(lm_normal=torch.where(state.lm_active[:, None], n, state.lm_normal))
