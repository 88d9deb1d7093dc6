"""The port's two kernels (rover_slam_tpu_torch/ops/{flash_attention,nn_matcher}.py)
against the JAX package's versions on the same numpy inputs.

On the CPU the port runs each kernel's plain PyTorch twin; the JAX side runs
masked_attention's XLA path and the Pallas NN matcher in interpret mode. The
CUDA kernels themselves are compared with their twins in test_torch_cuda.py
(on a card) and by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.ops import association as assoc
from rover_slam_tpu.ops.pallas_attention import masked_attention as jax_attention
from rover_slam_tpu_torch.ops import flash_attention as fa
from rover_slam_tpu_torch.ops import nn_matcher as nm
from rover_slam_tpu_torch.utils import profiling


@pytest.fixture
def interpret_mode(monkeypatch):
    """CPU tests run the Pallas kernel in the Pallas interpreter."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", jax.default_backend() == "cpu")
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import importlib
    from rover_slam_tpu.ops import pallas_matcher
    importlib.reload(pallas_matcher)
    yield pallas_matcher
    importlib.reload(pallas_matcher)


def _qkvm(rng, B=2, N=64, H=4, Dh=32, p_valid=0.7):
    q, k, v = (rng.normal(0, 1, (B, N, H, Dh)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(0, 1, (B, N)) < p_valid
    return q, k, v, mask


def _port_attention(q, k, v, mask):
    return fa.masked_attention(*(torch.from_numpy(x) for x in (q, k, v, mask))).numpy()


def unit_desc(rng, n, d=64):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _nn_case(seed=0, N0=200, N1=180, D=64):
    rng = np.random.default_rng(seed)
    d0 = unit_desc(rng, N0, D)
    perm = rng.permutation(N0)[:N1]
    d1 = d0[perm] + rng.normal(0, 0.05, (N1, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    v0 = np.ones(N0, bool)
    v0[190:] = False
    v1 = np.ones(N1, bool)
    v1[170:] = False
    return d0, v0, d1, v1


# --- B1: attention -----------------------------------------------------------

def test_attention_matches_xla_path_f32():
    q, k, v, mask = _qkvm(np.random.default_rng(0))
    ref = np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k, v, mask)),
                                   force_xla=True))
    np.testing.assert_allclose(_port_attention(q, k, v, mask), ref, atol=1e-5)


def test_attention_masked_kv_has_no_influence():
    rng = np.random.default_rng(1)
    q, k, v, _ = _qkvm(rng, B=1, H=2)
    mask = np.ones((1, 64), bool)
    mask[:, 40:] = False
    out1 = _port_attention(q, k, v, mask)
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = -777.0
    v2[:, 40:] = 999.0
    out2 = _port_attention(q, k2, v2, mask)
    np.testing.assert_allclose(out1, out2, atol=1e-6)
    ref = np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k2, v2, mask)),
                                   force_xla=True))
    np.testing.assert_allclose(out2, ref, atol=1e-5)


def test_attention_all_masked_row_is_mean_of_v():
    """A batch row whose kv is all masked returns the mean of v over the real
    Nk, as the JAX package's XLA path does (its Pallas kernel would average
    over the padded kv instead)."""
    q, k, v, mask = _qkvm(np.random.default_rng(2), N=50)
    mask[1] = False
    out = _port_attention(q, k, v, mask)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape),
                               atol=1e-5)
    ref = np.asarray(jax_attention(*(jnp.asarray(x) for x in (q, k, v, mask)),
                                   force_xla=True))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_attention_bf16_plain_matches_xla_path():
    q, k, v, mask = _qkvm(np.random.default_rng(3), N=96, Dh=64)
    out = fa.masked_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                for x in (q, k, v)), torch.from_numpy(mask))
    ref = jax_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                        jnp.asarray(mask), force_xla=True)
    err = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err < 0.02, err


@pytest.mark.parametrize("Nq,Nk", [(1, 1), (65, 65), (33, 65), (65, 1), (1, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_tile_edges_match_xla_path(Nq, Nk, dtype):
    """Shapes at the edges of the CUDA kernel's tiles (32 query rows, 64-key kv
    tiles): Nq != Nk, one key, one query, 65 = one tile and one key; batch
    row 1 has every key masked."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (2, Nq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, Nk, 4, 32)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(0, 1, (2, Nk)) < 0.7
    mask[0, 0] = True
    mask[1] = False
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = fa.masked_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                              torch.from_numpy(mask)).float().numpy()
    ref = np.asarray(jax_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   jnp.asarray(mask), force_xla=True).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 0.02
    np.testing.assert_allclose(out, ref, atol=tol)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), out[1].shape),
                               atol=tol)


def test_attention_launch_refuses_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(x) for x in _qkvm(np.random.default_rng(4)))
    before = profiling.counter("attention_launches")
    with pytest.raises(ValueError):
        fa._launch(q, k, v, mask)
    assert profiling.counter("attention_launches") == before


# --- B2: nearest-neighbour reduce ---------------------------------------------

def test_nn_reduce_matches_pallas_interpret(interpret_mode):
    d0, _, d1, v1 = _nn_case()
    best_j, idx_j, second_j = (np.asarray(x) for x in interpret_mode.nn_reduce(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(v1)))
    best, idx, second = (x.numpy() for x in nm.nn_reduce(
        torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(v1)))
    np.testing.assert_allclose(best, best_j, atol=3e-2)
    np.testing.assert_allclose(second, second_j, atol=3e-2)
    assert (idx == idx_j).mean() > 0.95
    assert idx.dtype == np.int32


def test_nn_reduce_excludes_invalid_columns():
    rng = np.random.default_rng(2)
    d0 = unit_desc(rng, 64)
    d1 = np.concatenate([d0, unit_desc(rng, 64)])
    v1 = np.zeros(128, bool)
    v1[64:] = True
    _, idx, _ = nm.nn_reduce(torch.from_numpy(d0), torch.from_numpy(d1),
                             torch.from_numpy(v1))
    assert (idx.numpy() >= 64).all()


@pytest.mark.parametrize("ref_name", ["association", "pallas_interpret"])
def test_mutual_nn_match_matches_reference(interpret_mode, ref_name):
    d0, v0, d1, v1 = _nn_case()
    args = (jnp.asarray(d0), jnp.asarray(v0), jnp.asarray(d1), jnp.asarray(v1))
    if ref_name == "association":
        m_ref, _ = assoc.mutual_nn_match(*args, ratio=0.8)
    else:
        m_ref, _ = interpret_mode.mutual_nn_match_pallas(*args, ratio=0.8)
    m_ref = np.asarray(m_ref)
    m, _ = nm.mutual_nn_match(*(torch.from_numpy(x) for x in (d0, v0, d1, v1)),
                              ratio=0.8)
    m = m.numpy()
    assert m.dtype == np.int32
    assert (m == m_ref).mean() > 0.95
    both = (m >= 0) & (m_ref >= 0)
    assert (m[both] == m_ref[both]).mean() > 0.98


@pytest.mark.parametrize("case", ["same_tile", "different_tiles", "all_invalid"])
def test_nn_reduce_ties_and_invalid_match_pallas_interpret(interpret_mode, case):
    """Exact duplicate best columns (inside one 128-column Pallas tile, and in
    two different tiles): the lower index wins and second equals best, in the
    port's plain version as in the Pallas kernel. With every column invalid,
    best = second = 1e9 at index 0."""
    rng = np.random.default_rng(7)
    d0, d1 = unit_desc(rng, 200, 64), unit_desc(rng, 300, 64)
    v1 = np.ones(300, bool)
    pairs = {"same_tile": [(3, 40), (130, 131)],
             "different_tiles": [(5, 200), (100, 290)],
             "all_invalid": []}[case]
    for r, (lo, hi) in enumerate(pairs):
        d1[hi] = d1[lo]
        d0[r] = d1[lo]
    if case == "all_invalid":
        v1[:] = False
    best_j, idx_j, second_j = (np.asarray(x) for x in interpret_mode.nn_reduce(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(v1)))
    best, idx, second = (x.numpy() for x in nm.nn_reduce(
        torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(v1)))
    np.testing.assert_allclose(best, best_j, atol=1e-5)
    np.testing.assert_allclose(second, second_j, atol=1e-5)
    sep = (second_j - best_j) > 1e-4
    assert (idx == idx_j)[sep].all()
    for r, (lo, _) in enumerate(pairs):
        assert idx[r] == idx_j[r] == lo
        assert second[r] == best[r] and second_j[r] == best_j[r]
    if case == "all_invalid":
        assert (idx == 0).all() and (idx_j == 0).all()
        assert (best == nm.BIG).all() and (second == nm.BIG).all()
