"""Segment reductions (counterpart of rover_slam_tpu/ops/scatterless.py) and
the index helpers with jax.lax semantics the port needs without a host sync
(`top_k` tie order, `jnp.nonzero(size=)`).

The JAX package writes the reductions as one-hot contractions because
scatters are slow on the TPU. Here the integer and boolean reductions are
native scatter ops with the same results. Float sums never go through
atomics (`index_add_` on the card adds in an order that changes from run to
run): entries are sorted by segment once (`segment_plan`) and each segment is
summed in entry order (`seg_sum`), so a run repeats to the bit. Indices
outside [0, size) contribute nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _bucket(idx: torch.Tensor, size: int, mask=None) -> torch.Tensor:
    """int64 indices with out-of-range (and unmasked) entries sent to a
    spill bucket at `size`."""
    ok = (idx >= 0) & (idx < size)
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, idx.long(), size)


class SegmentPlan(NamedTuple):
    """Entries sorted by segment: `order` [n] is the stable sort of the
    entries by segment id, segment s holds sorted positions
    [offsets[s], offsets[s + 1]), and out-of-range entries sort past
    offsets[-1]."""
    order: torch.Tensor
    offsets: torch.Tensor


def segment_plan(idx: torch.Tensor, size: int) -> SegmentPlan:
    """The sort that `seg_sum` reduces through; build it once per index set."""
    keys, order = torch.sort(_bucket(idx, size), stable=True)
    offsets = torch.searchsorted(keys, torch.arange(size + 1, device=idx.device))
    return SegmentPlan(order, offsets)


def seg_sum(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """[n, ...] -> [size, ...]: each segment summed in entry order, the same
    order on every run (0 for an empty segment)."""
    return torch.segment_reduce(vals[plan.order], "sum", offsets=plan.offsets,
                                axis=0, unsafe=True)


class ChunkedPlan(NamedTuple):
    """A SegmentPlan whose segments are cut into chunks of at most `chunk`
    sorted entries: chunk c holds sorted positions [chunk_offsets[c],
    chunk_offsets[c + 1]), and segment s chunks [seg_chunks[s],
    seg_chunks[s + 1])."""
    order: torch.Tensor
    chunk_offsets: torch.Tensor
    seg_chunks: torch.Tensor


def chunked_plan(idx: torch.Tensor, size: int, chunk: int) -> ChunkedPlan:
    """The plan of `seg_sum_chunked`. One host read (the number of chunks)."""
    plan = segment_plan(idx, size)
    off = plan.offsets
    n_chunks = (off[1:] - off[:-1] + chunk - 1) // chunk
    cum = torch.cumsum(n_chunks, 0)
    total = int(cum[-1]) if size else 0
    c = torch.arange(total, device=idx.device)
    seg = torch.searchsorted(cum, c, right=True)
    starts = off[seg] + (c - (cum[seg] - n_chunks[seg])) * chunk
    return ChunkedPlan(plan.order, torch.cat([starts, off[-1:]]),
                       torch.cat([cum.new_zeros(1), cum]))


def seg_sum_chunked(plan: ChunkedPlan, vals: torch.Tensor) -> torch.Tensor:
    """seg_sum with each segment summed chunk by chunk in entry order, then
    its chunk sums in order: the same fixed order on every run. A long
    segment then costs one short sum per chunk instead of one long serial
    one (torch.segment_reduce sums a segment serially on the card); a
    segment of at most `chunk` entries sums exactly as in seg_sum."""
    part = torch.segment_reduce(vals[plan.order], "sum", offsets=plan.chunk_offsets,
                                axis=0, unsafe=True)
    return torch.segment_reduce(part, "sum", offsets=plan.seg_chunks, axis=0, unsafe=True)


def seg_add(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """Segment-sum vals [N, ...] by idx [N] into [size, ...]."""
    return seg_sum(segment_plan(idx, size), vals)


def seg_count(idx: torch.Tensor, size: int, mask=None) -> torch.Tensor:
    """[size] int32: number of (masked) entries per segment."""
    b = _bucket(idx, size, mask)
    out = torch.zeros(size + 1, dtype=torch.int32, device=idx.device)
    return out.scatter_add_(0, b, torch.ones_like(b, dtype=torch.int32))[:size]


def seg_any(idx: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """[size] bool: segment s has any masked element."""
    return seg_count(idx, size, mask) > 0


def seg_pick(idx: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
             size: int, default: torch.Tensor) -> torch.Tensor:
    """For each segment s, vals[n] of the first masked n with idx[n] == s,
    else default[s]."""
    n = idx.shape[0]
    b = _bucket(idx, size, mask)
    ar = torch.arange(n, device=idx.device)
    first = torch.full((size + 1,), n, dtype=torch.long, device=idx.device)
    first = first.scatter_reduce(0, b, ar, reduce="amin")[:size]
    has = first < n
    picked = vals[first.clamp(max=max(n - 1, 0))]
    has_b = has.reshape(has.shape + (1,) * (picked.dim() - 1))
    return torch.where(has_b, picked, default)


def top_k(values: torch.Tensor, n: int):
    """(values, indices) of the n largest along the last dim, ties broken
    toward the lower index as jax.lax.top_k does (torch.topk promises no
    order among ties)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :n], i[..., :n]


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int):
    """Indices of the True entries of a 1-D mask in order, padded with
    fill_value or cut to `size` (jnp.nonzero(size=, fill_value=)), without a
    host sync."""
    n = mask.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    if size > n:
        order = torch.cat([order, torch.full((size - n,), n, dtype=order.dtype,
                                             device=order.device)])
    order = order[:size]
    live = torch.cat([mask, mask.new_zeros(1)])[order.clamp(max=n)]
    return torch.where(live, order, fill_value)
