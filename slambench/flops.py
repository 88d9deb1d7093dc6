"""The yardstick's arithmetic: the card's peaks and the operations and bytes
of the networks and kernels a frame runs, from their shapes.

Peaks: NVIDIA's data sheet for the H100 SXM part at its 700 W limit, dense
rates: 989 TFLOP/s in bf16 (the networks' and both kernels' tensor-core
precision), 3.35 TB/s of HBM. A multiply-add counts two operations.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SUPERPOINT_CONVS = (  # (name, cin, cout, kernel, downsampling before it)
    ("conv1a", 1, 64, 3, 1), ("conv1b", 64, 64, 3, 1),
    ("conv2a", 64, 64, 3, 2), ("conv2b", 64, 64, 3, 2),
    ("conv3a", 64, 128, 3, 4), ("conv3b", 128, 128, 3, 4),
    ("conv4a", 128, 128, 3, 8), ("conv4b", 128, 128, 3, 8),
    ("convPa", 128, 256, 3, 8), ("convPb", 256, 65, 1, 8),
    ("convDa", 128, 256, 3, 8), ("convDb", 256, 256, 1, 8))


def superpoint_flops(h: int, w: int) -> float:
    """SuperPoint's convolutions on one h x w image (stride-1 'same' convs at
    1, 1/2, 1/4 and 1/8 resolution)."""
    return float(sum(2 * cin * cout * k * k * (h // s) * (w // s)
                     for _, cin, cout, k, s in SUPERPOINT_CONVS))


def attention_call_flops(b: int, nq: int, nk: int, d: int) -> float:
    """One masked attention call over all heads: QK^T and PV, 2 * nq * nk * d
    operations each (d = heads x head size)."""
    return 4.0 * b * nq * nk * d


def attention_call_bytes(b: int, nq: int, nk: int, d: int, elem: int = 2) -> float:
    """q and o [b, nq, d] and k, v [b, nk, d] in bf16, each read or written
    once, and the bool key mask [b, nk]."""
    return float(b * (2 * nq * d + 2 * nk * d) * elem + b * nk)


def lightglue_attention_calls(b: int, n: int, m: int, d: int, layers: int) -> list:
    """(b, nq, nk, d) of every attention call of one LightGlue forward on
    [b, n] and [b, m] keypoints: per layer self-attention of each image and
    cross-attention both ways."""
    per_layer = [(b, n, n, d), (b, m, m, d), (b, n, m, d), (b, m, n, d)]
    return per_layer * layers


def lightglue_flops(b: int, n: int, m: int, d: int, layers: int) -> float:
    """One LightGlue forward: the input projection, per layer four attention
    blocks (q, k, v and output projections and the attention) and four
    concat-FFNs (2d -> 2d -> d), then the final projection and the [n, m]
    similarity. The positional encoding, LayerNorms, softmaxes and the
    matchability head are left out (under 1 %)."""
    tokens = n + m
    proj = 2.0 * tokens * d * d                              # input_proj
    per_layer = (2 * 4 * 2.0 * tokens * d * d                 # q, k, v, out, self and cross
                 + 2 * (2.0 * tokens * (2 * d) * (2 * d) + 2.0 * tokens * (2 * d) * d))  # FFNs
    attn = sum(attention_call_flops(*c) for c in lightglue_attention_calls(1, n, m, d, 1))
    head = 2.0 * tokens * d * d + 2.0 * n * m * d
    return b * (proj + layers * (per_layer + attn) + head)


def nn_reduce_flops(n0: int, n1: int, d: int) -> float:
    """One B2 reduce: the [n0, n1] dot products."""
    return 2.0 * n0 * n1 * d


def nn_reduce_bytes(n0: int, n1: int, d: int, elem: int = 2) -> float:
    """Both descriptor sets in bf16 read once, the bool mask of the columns,
    and best, argmin and second best [n0] (4 bytes each) written once."""
    return float((n0 + n1) * d * elem + n1 + 3 * 4 * n0)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
