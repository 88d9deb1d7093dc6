"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from rover_slam_tpu_torch.ops import flash_attention as fa
from rover_slam_tpu_torch.ops import nn_matcher as nm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these comparisons too)")
    return torch.device("cuda")


def _unit(g, n, d, device):
    return torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=1).to(device)


@pytest.mark.parametrize("B,N,Dh,dtype", [(1, 1024, 64, torch.bfloat16),
                                          (2, 1280, 64, torch.bfloat16),
                                          (2, 100, 32, torch.bfloat16),
                                          (1, 300, 64, torch.float32)])
def test_attention_kernel_matches_plain(dev, B, N, Dh, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, N, 4, Dh, generator=g).to(dev, dtype) for _ in range(3))
    mask = (torch.rand(B, N, generator=g) > 0.2).to(dev)
    if B > 1:
        mask[-1] = False                                  # an all-masked row
    before = fa.attention_launches
    out = fa.masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.attention_launches == before + 1
    ref = fa.masked_attention_plain(q, k, v, mask)
    tol = 0.02 if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()) < tol


def test_attention_kernel_reads_strided_views(dev):
    """The kernel takes [B, N, H, Dh] through strides (no transpose copy)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 512, 3, 4, 64, generator=g).to(dev, torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert not q.is_contiguous()
    mask = torch.ones(1, 512, dtype=torch.bool, device=dev)
    out = fa.masked_attention(q, k, v, mask)
    ref = fa.masked_attention_plain(q, k, v, mask)
    assert float((out.float() - ref.float()).abs().max()) < 0.02


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 64, 4, 48, device=dev, dtype=torch.bfloat16)   # Dh 48
    mask = torch.ones(1, 64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        fa.masked_attention(q, q, q, mask)
    q = torch.randn(1, 64, 4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.masked_attention(q, q, q, mask)


@pytest.mark.parametrize("N0,N1,D", [(1024, 1024, 256), (200, 180, 64), (512, 512, 64)])
def test_nn_kernel_matches_plain(dev, N0, N1, D):
    g = torch.Generator().manual_seed(2)
    d0 = _unit(g, N0, D, dev)
    d1 = _unit(g, N1, D, dev)
    n = min(N0, N1) // 2
    d1[:n] = torch.nn.functional.normalize(d0[:n] + 0.05 * _unit(g, n, D, dev), dim=1)
    v1 = (torch.rand(N1, generator=g) > 0.1).to(dev)
    before = nm.nn_launches
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    torch.cuda.synchronize()
    assert nm.nn_launches == before + 1
    best_p, idx_p, second_p = nm.nn_reduce_plain(d0, d1, v1)
    assert float((best - best_p).abs().max()) < 3e-2
    assert float((second - second_p).abs().max()) < 3e-2
    assert float((idx == idx_p).float().mean()) > 0.95
    assert not bool(v1[idx.long()].logical_not().any())
