"""Atlas: several maps in one MapState, told apart by map id.

Counterpart of rover_slam_tpu/map/atlas.py's `create_new_map` and
`active_map_masks`. Merging maps belongs to the loop-closing slice, saving
and loading the atlas to the persistence slice.
"""
from __future__ import annotations

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
