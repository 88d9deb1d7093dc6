"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

import pose_opt_problems
from rover_slam_tpu_torch.geometry import cameras
from rover_slam_tpu_torch.ops import flash_attention as fa
from rover_slam_tpu_torch.ops import nn_matcher as nm
from rover_slam_tpu_torch.optim import pose_opt as po
from rover_slam_tpu_torch.utils import profiling

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
                                          (3, 1024, 64, torch.bfloat16),
                                          (2, 100, 32, torch.bfloat16),
                                          (1, 300, 64, torch.float32)])
def test_attention_kernel_matches_plain(dev, B, N, Dh, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, N, 4, Dh, generator=g).to(dev, dtype) for _ in range(3))
    mask = (torch.rand(B, N, generator=g) > 0.2).to(dev)
    if B > 1:
        mask[-1] = False                                  # an all-masked row
    before = profiling.counter("attention_launches")
    out = fa.masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert profiling.counter("attention_launches") == before + 1
    ref = fa.masked_attention_plain(q, k, v, mask)
    tol = 0.02 if dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.parametrize("Nq,Nk", [(1, 1), (65, 65), (1000, 1000), (1280, 1280),
                                   (1024, 65), (65, 1280), (1, 1000), (1000, 1)])
@pytest.mark.parametrize("Dh", [32, 64])
def test_attention_kernel_edges(dev, Nq, Nk, Dh):
    """The tensor-core tiling's edges (32-row query tiles, 64-key kv tiles
    split between two warps), B=2 with batch row 1 all masked."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, Nq, 4, Dh, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(2, Nk, 4, Dh, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    mask = (torch.rand(2, Nk, generator=g) > 0.2).to(dev)
    mask[1] = False
    out = fa.masked_attention(q, k, v, mask)
    ref = fa.masked_attention_plain(q, k, v, mask)
    assert float((out.float() - ref.float()).abs().max()) < 0.02
    mean_v = v[1].float().mean(dim=0)
    assert float((out[1].float() - mean_v).abs().max()) < 0.02


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernel_gradient(dev, dtype):
    """Inputs that require a gradient: the forward is the kernel launch
    (output with a grad_fn), the backward recomputes the plain version and
    gives plain autograd's gradients to the bit."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(4, 512, 4, 64, generator=g).to(dev, dtype) for _ in range(3))
    mask = (torch.rand(4, 512, generator=g) > 0.1).to(dev)
    mask[3] = False
    up = torch.randn(4, 512, 4, 64, generator=g).to(dev, dtype)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    launches = profiling.counter("attention_launches")
    recomputes = profiling.counter("backward_recomputes")
    out = fa.masked_attention(*a, mask)
    assert out.grad_fn is not None and profiling.counter("attention_launches") == launches + 1
    out.backward(up)
    fa.masked_attention_plain(*b, mask).backward(up)
    assert profiling.counter("backward_recomputes") == recomputes + 1
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 64, 4, 48, device=dev, dtype=torch.bfloat16)   # Dh 48
    mask = torch.ones(1, 64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        fa.masked_attention(q, q, q, mask)
    q = torch.randn(1, 64, 4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.masked_attention(q, q, q, mask)


def _nn_check(best, idx, second, ref):
    """Kernel and plain multiply the same bf16-rounded inputs exactly and sum
    in f32: values within 1e-4, argmin identical wherever the plain best and
    second differ by more than that."""
    best_p, idx_p, second_p = ref
    assert float((best - best_p).abs().max()) < 1e-4
    assert float((second - second_p).abs().max()) < 1e-4
    sep = (second_p - best_p) > 1e-4
    assert bool((idx == idx_p)[sep].all())


@pytest.mark.parametrize("N0,N1,D", [(1024, 1024, 256), (200, 180, 64), (512, 512, 64),
                                     (1024, 1000, 256), (300, 130, 64), (64, 1, 48)])
def test_nn_kernel_matches_plain(dev, N0, N1, D):
    g = torch.Generator().manual_seed(2)
    d0 = _unit(g, N0, D, dev)
    d1 = _unit(g, N1, D, dev)
    n = min(N0, N1) // 2
    d1[:n] = torch.nn.functional.normalize(d0[:n] + 0.05 * _unit(g, n, D, dev), dim=1)
    v1 = (torch.rand(N1, generator=g) > 0.1).to(dev)
    v1[0] = True
    before = profiling.counter("nn_launches")
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    torch.cuda.synchronize()
    assert profiling.counter("nn_launches") == before + 1
    _nn_check(best, idx, second, nm.nn_reduce_plain(d0, d1, v1))
    assert not bool(v1[idx.long()].logical_not().any())


def test_nn_kernel_duplicate_columns_lower_index_wins(dev):
    """Exact duplicate best columns in one 64-column tile and across column
    splits: the lower index wins and second equals best."""
    g = torch.Generator().manual_seed(4)
    d0 = _unit(g, 1024, 256, dev)
    d1 = _unit(g, 1000, 256, dev)
    v1 = torch.ones(1000, dtype=torch.bool, device=dev)
    pairs = [(3, 40), (5, 900), (130, 131)]
    for r, (lo, hi) in enumerate(pairs):
        d1[hi] = d1[lo]
        d0[r] = d1[lo]
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    _nn_check(best, idx, second, nm.nn_reduce_plain(d0, d1, v1))
    for r, (lo, _) in enumerate(pairs):
        assert int(idx[r]) == lo
        assert float(second[r]) == float(best[r])


def test_nn_kernel_all_columns_invalid(dev):
    g = torch.Generator().manual_seed(5)
    d0, d1 = _unit(g, 1024, 256, dev), _unit(g, 1000, 256, dev)
    v1 = torch.zeros(1000, dtype=torch.bool, device=dev)
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    assert bool((idx == 0).all())
    assert bool((best == nm.BIG).all()) and bool((second == nm.BIG).all())


def test_nn_kernel_is_deterministic(dev):
    """No atomics: two runs give the same bits."""
    g = torch.Generator().manual_seed(6)
    d0, d1 = _unit(g, 1024, 256, dev), _unit(g, 1024, 256, dev)
    v1 = torch.ones(1024, dtype=torch.bool, device=dev)
    a = nm.nn_reduce(d0, d1, v1)
    b = nm.nn_reduce(d0, d1, v1)
    assert all(bool(torch.equal(x, y)) for x, y in zip(a, b))


# tests/torch_parity.py's POSE (that module imports JAX).
POSE_ATOL = 1e-4
# (check_cost, rounds, iterations): the tracker's motion and local-map
# stages, and pnp_ransac's refinement.
SCHEDULES = [(False, 2, 5), (False, 2, 6), (True, 4, 10)]


def _pose_opt_check(out, ref, kw, chi2_th=5.991):
    """Kernel against plain on the same inputs: the pose within POSE_ATOL;
    the inliers equal but on edges whose final chi2 (either side's) lies
    within 1e-4 relative of its gate, n_inliers apart by at most their
    count."""
    assert torch.allclose(out.R_cw, ref.R_cw, atol=POSE_ATOL, rtol=0)
    assert torch.allclose(out.t_cw, ref.t_cw, atol=POSE_ATOL, rtol=0)
    g = pose_opt_problems.gate(kw, chi2_th)
    near = ((out.chi2 - g).abs() <= 1e-4 * g) | ((ref.chi2 - g).abs() <= 1e-4 * g)
    differ = out.inliers != ref.inliers
    assert not bool((differ & ~near).any())
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= int(near.sum())
    assert out.n_inliers.dtype == ref.n_inliers.dtype and out.n_inliers.dim() == 0


@pytest.mark.parametrize("M", [300, 1024, 3000])
@pytest.mark.parametrize("check_cost,rounds,iters", SCHEDULES)
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("cam_kind", [cameras.PINHOLE, cameras.KANNALA_BRANDT8])
def test_pose_opt_kernel_matches_plain(dev, cam_kind, stereo, check_cost, rounds, iters, M):
    """Both camera models, mono and stereo (invd <= 0 on 40 % of the edges),
    the three schedules, the register path (M <= 1024) and the strided one."""
    kw = pose_opt_problems.problem(M, cam_kind, stereo, seed=M + 7 * cam_kind, device=dev)
    sched = dict(rounds=rounds, iters_per_round=iters, check_cost=check_cost)
    key = f"{M}x{rounds}x{iters}" + ("/stereo" if stereo else "")
    before = profiling.counter_by("pose_opt_launches").get(key, 0)
    out = po.pose_optimization(**kw, **sched)
    torch.cuda.synchronize()
    assert profiling.counter_by("pose_opt_launches").get(key, 0) == before + 1
    _pose_opt_check(out, po.pose_optimization_plain(**kw, **sched), kw)


def test_pose_opt_kernel_all_edges_invalid(dev):
    """No valid edge: the pose comes back where it started, no inliers."""
    kw = pose_opt_problems.problem(1024, cameras.PINHOLE, False, seed=11, device=dev)
    kw["valid"] = torch.zeros_like(kw["valid"])
    out = po.pose_optimization(**kw, rounds=2, iters_per_round=6, check_cost=False)
    ref = po.pose_optimization_plain(**kw, rounds=2, iters_per_round=6, check_cost=False)
    _pose_opt_check(out, ref, kw)
    assert int(out.n_inliers) == 0 and not bool(out.inliers.any())
    assert torch.allclose(out.R_cw, kw["R_cw"], atol=1e-6, rtol=0)
    assert torch.equal(out.t_cw, kw["t_cw"])


@pytest.mark.parametrize("M", [1024, 3000])
def test_pose_opt_kernel_non_finite_points(dev, M):
    """Non-finite landmark rows poison H in both versions (NaN * 0 weight),
    the zeroed step leaves the pose, and those rows are never inliers."""
    kw = pose_opt_problems.problem(M, cameras.PINHOLE, True, seed=12, device=dev)
    kw["Xw"][5] = float("nan")
    kw["Xw"][9, 1] = float("inf")
    for check_cost, rounds, iters in SCHEDULES:
        sched = dict(rounds=rounds, iters_per_round=iters, check_cost=check_cost)
        out = po.pose_optimization(**kw, **sched)
        _pose_opt_check(out, po.pose_optimization_plain(**kw, **sched), kw)
        assert not bool(out.inliers[5]) and not bool(out.inliers[9])


@pytest.mark.parametrize("M", [1024, 3000])
def test_pose_opt_kernel_is_deterministic(dev, M):
    """A fixed reduction order and no atomics: two calls give the same bits."""
    kw = pose_opt_problems.problem(M, cameras.KANNALA_BRANDT8, True, seed=13, device=dev)
    for check_cost, rounds, iters in SCHEDULES:
        sched = dict(rounds=rounds, iters_per_round=iters, check_cost=check_cost)
        a = po.pose_optimization(**kw, **sched)
        b = po.pose_optimization(**kw, **sched)
        assert all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def test_pose_opt_kernel_refuses_what_it_does_not_take(dev):
    kw = pose_opt_problems.problem(300, cameras.PINHOLE, False, seed=14, device=dev)
    bad = [dict(cam_params=kw["cam_params"].cpu()),
           dict(Xw=kw["Xw"].double()),
           dict(uv=torch.cat([kw["uv"], kw["uv"]], dim=1)[:, ::2]),
           dict(valid=kw["valid"].float()),
           dict(invd=torch.ones(300, device=dev), bf=50.0)]
    assert not bad[2]["uv"].is_contiguous()
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            po.pose_optimization(**{**kw, **change}, rounds=2, iters_per_round=5,
                                 check_cost=False)
