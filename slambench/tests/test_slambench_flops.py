"""The yardstick's operation and byte counts on shapes counted by hand."""
import pytest

from slambench import flops


def test_superpoint_flops_by_hand():
    h, w = 16, 16
    full, half, quarter, eighth = 256, 64, 16, 4
    by_hand = 2 * (1 * 64 * 9 * full + 64 * 64 * 9 * full + 64 * 64 * 9 * half * 2
                   + (64 * 128 + 128 * 128) * 9 * quarter + 128 * 128 * 9 * eighth * 2
                   + 128 * 256 * 9 * eighth * 2 + 256 * 65 * eighth + 256 * 256 * eighth)
    assert flops.superpoint_flops(h, w) == by_hand


def test_attention_counts_by_hand():
    assert flops.attention_call_flops(2, 3, 5, 8) == 4 * 2 * 3 * 5 * 8
    # q, o [2,3,8] and k, v [2,5,8] in bf16, the bool mask [2,5]
    assert flops.attention_call_bytes(2, 3, 5, 8) == 2 * (3 * 8 * 2 + 5 * 8 * 2) * 2 + 2 * 5
    calls = flops.lightglue_attention_calls(1, 3, 5, 8, 2)
    assert calls == [(1, 3, 3, 8), (1, 5, 5, 8), (1, 3, 5, 8), (1, 5, 3, 8)] * 2


def test_lightglue_flops_by_hand():
    n, m, d, layers = 3, 5, 4, 1
    t = n + m
    proj = 2 * t * d * d
    lin = 2 * 4 * 2 * t * d * d
    ffn = 2 * (2 * t * 2 * d * 2 * d + 2 * t * 2 * d * d)
    attn = 4 * (n * n + m * m + n * m + m * n) * d
    head = 2 * t * d * d + 2 * n * m * d
    assert flops.lightglue_flops(1, n, m, d, layers) == proj + lin + ffn + attn + head
    assert flops.lightglue_flops(3, n, m, d, 2) == 3 * (proj + 2 * (lin + ffn + attn) + head)


def test_nn_and_bounds():
    assert flops.nn_reduce_flops(4, 6, 8) == 2 * 4 * 6 * 8
    assert flops.nn_reduce_bytes(4, 6, 8) == (4 + 6) * 8 * 2 + 6 + 3 * 4 * 4
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
