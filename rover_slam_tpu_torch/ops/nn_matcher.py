"""Fused nearest-neighbour descriptor matching: a hand-written CUDA kernel and
its plain PyTorch twin.

Counterpart of rover_slam_tpu/ops/pallas_matcher.py (TPU kernel `_nn_kernel`,
`nn_reduce`, `mutual_nn_match_pallas`). `nn_reduce(desc0, desc1, valid1)`
returns per row of desc0 the best L2^2 distance over the valid columns of
desc1, its argmin (first index wins ties) and the second best. Inputs are
rounded to bf16 and the dot products summed in f32, as `nn_reduce` does.

`mutual_nn_match` is the port's descriptor matcher everywhere the JAX package
calls `ops/association.py::mutual_nn_match`: two reduces (desc0 -> desc1 with
valid1, desc1 -> desc0 with valid0) and the mutual, th_desc2, valid and
ratio gates on top.

Routing: a CPU tensor goes to `nn_reduce_plain`; a CUDA tensor goes to the
kernel in csrc/nn_matcher.cu (tensor cores, column axis split across blocks,
partials merged in column order) or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

BIG = 1e9
TH_HIGH = 1.4

_TILE = 64         # rows and columns of one block tile in csrc/nn_matcher.cu
MIN_BLOCKS = 128   # blocks a call aims for (132 SMs)
MAX_DEPTH = 512    # the kernel keeps 192 rows of depth D in shared memory

# Counters of utils/profiling.py's registry: reduces, in all ("nn_launches")
# and by "N0xN1xD" ("launches_by_shape"); one reduce is two kernel launches,
# the column splits and their merge.


def nn_reduce_plain(desc0, desc1, valid1):
    """Plain PyTorch version: full [N0, N1] score matrix, then reductions."""
    a = desc0.to(torch.bfloat16).float()
    b = desc1.to(torch.bfloat16).float()
    scores = 2.0 - 2.0 * (a @ b.T)
    scores = torch.where(valid1[None, :], scores, BIG)
    idx = torch.argmin(scores, dim=1)
    best = torch.gather(scores, 1, idx[:, None])[:, 0]
    second = torch.scatter(scores, 1, idx[:, None], BIG).amin(dim=1)
    return best, idx.to(torch.int32), second


@profiling.spanned("b2.nn_reduce", sample=False)
def nn_reduce(desc0, desc1, valid1):
    """(best d^2 [N0] f32, argmin [N0] int32, second-best d^2 [N0] f32)."""
    if desc0.device.type == "cpu":
        return nn_reduce_plain(desc0, desc1, valid1)
    return _launch(desc0, desc1, valid1)


def mutual_nn_match(desc0, valid0, desc1, valid1, th_desc2: float = TH_HIGH ** 2,
                    ratio: float | None = None):
    """Mutual nearest-neighbour matching with the TH and Lowe-ratio gates.
    Returns (matches0 [N0] int32, -1 unmatched; best d^2 [N0])."""
    # Both reduces round their inputs to bf16: convert each side once.
    desc0 = desc0.to(torch.bfloat16).contiguous()
    desc1 = desc1.to(torch.bfloat16).contiguous()
    fwd = nn_reduce(desc0, desc1, valid1)
    bwd = nn_reduce(desc1, desc0, valid0)
    return mutual_gate(fwd, bwd, valid0, valid1, th_desc2, ratio)


def mutual_gate(fwd, bwd, valid0, valid1, th_desc2: float = TH_HIGH ** 2,
                ratio: float | None = None):
    """The gates of mutual_nn_match on two reduces: fwd = desc0 -> desc1
    (with valid1), bwd = desc1 -> desc0 (with valid0)."""
    d_best, best1, d_second = fwd
    best0 = bwd[1]
    b1 = best1.long().clamp(0, valid1.shape[0] - 1)
    arange0 = torch.arange(best1.shape[0], device=best1.device, dtype=torch.int32)
    ok = (best0[b1] == arange0) & (d_best <= th_desc2) & valid0 & valid1[b1]
    if ratio is not None:
        ok = ok & (d_best <= ratio * ratio * d_second)
    return torch.where(ok, best1, -1).to(torch.int32), d_best


def _split_cols(N0: int, N1: int) -> int:
    """Columns per split of the kernel's column axis: a multiple of the
    64-column tile, as few splits as give MIN_BLOCKS blocks (64-row tiles x
    splits), at most one split per column tile."""
    row_tiles = -(-N0 // _TILE)
    col_tiles = -(-N1 // _TILE)
    splits = min(col_tiles, -(-MIN_BLOCKS // row_tiles))
    return -(-col_tiles // splits) * _TILE


def _aligned16(x):
    """x itself if 16-byte aligned, else a fresh copy (the kernel copies rows
    in 16-byte pieces)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(desc0, desc1, valid1):
    if desc0.device.type != "cuda":
        raise ValueError(f"nn_matcher: unsupported device {desc0.device}")
    if not (desc1.device == valid1.device == desc0.device):
        raise ValueError("nn_matcher: inputs on different devices")
    if desc0.dim() != 2 or desc1.dim() != 2 or desc0.shape[1] != desc1.shape[1]:
        raise ValueError(f"nn_matcher: desc shapes {tuple(desc0.shape)} / "
                         f"{tuple(desc1.shape)} (needs [N0, D] and [N1, D])")
    if not (desc0.dtype.is_floating_point and desc1.dtype.is_floating_point):
        raise ValueError("nn_matcher: descriptors must be floating point")
    N0, D = desc0.shape
    N1 = desc1.shape[0]
    if N0 == 0 or N1 == 0 or D == 0:
        raise ValueError("nn_matcher: empty input")
    if D > MAX_DEPTH:
        raise ValueError(f"nn_matcher: depth {D} > {MAX_DEPTH} (shared memory)")
    if valid1.dtype != torch.bool or tuple(valid1.shape) != (N1,):
        raise ValueError("nn_matcher: valid1 must be bool [N1]")
    pad = -D % 16                      # zero depth is inert in the products
    d0, d1 = (x.to(torch.bfloat16).contiguous() for x in (desc0, desc1))
    if pad:
        d0, d1 = (torch.nn.functional.pad(x, (0, pad)) for x in (d0, d1))
    d0, d1 = _aligned16(d0), _aligned16(d1)
    v1 = valid1.contiguous()
    split_cols = _split_cols(N0, N1)
    S = -(-N1 // split_cols)
    dev = desc0.device
    best = torch.empty((N0,), dtype=torch.float32, device=dev)
    idx = torch.empty((N0,), dtype=torch.int32, device=dev)
    second = torch.empty((N0,), dtype=torch.float32, device=dev)
    pbest = torch.empty((S, N0), dtype=torch.float32, device=dev)
    pidx = torch.empty((S, N0), dtype=torch.int32, device=dev)
    psecond = torch.empty((S, N0), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.nn_reduce(d0.data_ptr(), d1.data_ptr(), v1.data_ptr(),
                               best.data_ptr(), idx.data_ptr(), second.data_ptr(),
                               pbest.data_ptr(), pidx.data_ptr(), psecond.data_ptr(),
                               N0, N1, D + pad, split_cols, stream)
    _build.check(status, "nn_matcher")
    profiling.count("nn_launches")
    profiling.count("launches_by_shape", f"{N0}x{N1}x{D}")
    return best, idx, second


def _lib():
    lib = _build.load("nn_matcher")
    fn = lib.nn_reduce
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
