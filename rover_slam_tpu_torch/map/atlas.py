"""Atlas: several maps in one MapState, told apart by map id, and its
checkpoint / resume.

Counterpart of rover_slam_tpu/map/atlas.py: `create_new_map`,
`active_map_masks`, `merge_maps`, and `save_atlas` / `load_atlas` (an npz of
every MapState field plus a sha256 in `<path>.meta.json`, the reference's
System::SaveAtlas / LoadAtlas md5 gate). The file format is the JAX
package's: an atlas written by either package loads in the other.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from . import map_state as ms


def create_new_map(state: ms.MapState) -> ms.MapState:
    """Start a fresh active map (reference CreateMapInAtlas on tracking loss):
    stored maps keep their keyframes and landmarks under their old id; new
    insertions get the bumped id."""
    return state.replace(active_map_id=state.active_map_id + 1)


def active_map_masks(state: ms.MapState):
    """(kf_mask, lm_mask) of the active map."""
    return (state.kf_active & (state.kf_map_id == state.active_map_id),
            state.lm_active & (state.lm_map_id == state.active_map_id))


def merge_maps(state: ms.MapState, keep_id: int, absorb_id: int) -> ms.MapState:
    """Relabel map `absorb_id` into `keep_id` once loop closing has aligned
    the geometry; `keep_id` becomes the active map."""
    def relabel(ids):
        return torch.where(ids == absorb_id, torch.full_like(ids, keep_id), ids)

    return state.replace(kf_map_id=relabel(state.kf_map_id),
                         lm_map_id=relabel(state.lm_map_id),
                         active_map_id=torch.tensor(keep_id, dtype=torch.int32,
                                                    device=state.device))


def save_atlas(state: ms.MapState, path: str, metadata: dict | None = None) -> str:
    """Write every MapState field to `path` (compressed npz) and its sha256 to
    `path + ".meta.json"`; returns the digest."""
    arrays = {f: getattr(state, f).cpu().numpy() for f in ms.FIELDS}
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    digest = _sha256(path)
    with open(path + ".meta.json", "w") as f:
        json.dump({"sha256": digest, "version": 2, **(metadata or {})}, f)
    return digest


def load_atlas(path: str, verify: bool = True, device=None) -> ms.MapState:
    """Read a MapState written by either package. With verify, the sha256 in
    `path + ".meta.json"` must match the file (a corrupted atlas raises
    ValueError). A file without kf_kpt_invd (version 1, before stereo)
    loads as a monocular map."""
    if verify:
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        digest = _sha256(path)
        if digest != meta["sha256"]:
            raise ValueError(f"atlas checksum mismatch: {digest} != {meta['sha256']}")
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    fields.setdefault("kf_kpt_invd", np.full(fields["kf_kpt_valid"].shape, -1.0, np.float32))
    # Scalar counters added after a checkpoint was written default to zero.
    fields.setdefault("lm_dropped", np.zeros((), np.int32))
    return ms.map_state_from_numpy(fields, device=device)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
