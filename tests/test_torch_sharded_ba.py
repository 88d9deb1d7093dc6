"""Distributed bundle adjustment of the port (rover_slam_tpu_torch/parallel/
sharded_ba.py) against the JAX package's on the same inputs: the JAX
solvers run on its make_mesh(n) over the 8 virtual CPU devices
(tests/conftest.py), the port's on make_mesh(n, device="cpu").

Tolerances: the padding and the landmark partition are equal to the bit;
the solves differ in f32 reduction order only, which LM carries along:
measured over every case below (1 and 4 torch threads alike), R within
4.6e-6, t within 4.9e-5, landmarks within 4.1e-4 (coordinates up to 14)
and the cost history within 2.7e-5 relative (near convergence, where the
costs of two nearly equal iterates differ in their last digits). SOLVE
holds them at about four times that."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rover_slam_tpu.optim import ba as jba
from rover_slam_tpu.parallel import sharded_ba as jsh
from rover_slam_tpu_torch.ops import scatterless
from rover_slam_tpu_torch.optim import ba as tba
from rover_slam_tpu_torch.parallel import sharded_ba as tsh
from tests.test_ba import make_ba_problem, pose_errors

from torch_parity import torch_problem

SOLVE = {"R": dict(atol=2e-5, rtol=0), "t": dict(atol=2e-4, rtol=0),
         "X": dict(atol=2e-3, rtol=0), "costs": dict(atol=0, rtol=1e-4)}
SOLVERS = {"edges": (jsh.solve_ba_sharded, tsh.solve_ba_sharded),
           "landmarks": (jsh.solve_ba_sharded_lm, tsh.solve_ba_sharded_lm)}


def _pair(**kw):
    prob_j, truth, _ = make_ba_problem(**kw)
    return prob_j, torch_problem(tba.BAProblem, prob_j), truth


@pytest.fixture(scope="module")
def main_problem():
    return _pair(Kw=6, Lw=120, noise_px=0.5)


@pytest.fixture(scope="module")
def padded_problem():
    prob = _pair(Kw=3, Lw=30, noise_px=0.3)
    assert prob[0].e_kf.shape[0] == 90      # divides by neither 8 nor 3 nor 4
    return prob


def _assert_solves_match(out_t, out_j):
    for name, a, b in zip(("R", "t", "X", "costs"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **SOLVE[name])


@pytest.mark.parametrize("n", [3, 8])
def test_pad_edges_to(padded_problem, n):
    prob_j, prob_t, _ = padded_problem
    pj, pt = jsh.pad_edges_to(prob_j, n), tsh.pad_edges_to(prob_t, n)
    assert pt.e_kf.shape[0] % n == 0
    for f in ("e_kf", "e_lm", "e_uv", "e_valid", "e_info"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), f)
    assert tsh.pad_edges_to(pt, n) is pt


@pytest.mark.parametrize("n", [2, 3, 8])
def test_partition_by_landmark(main_problem, n):
    prob_j, prob_t, _ = main_problem
    pj, ls_j = jsh.partition_by_landmark(prob_j, n)
    pt, ls_t = tsh.partition_by_landmark(prob_t, n)
    assert ls_t == ls_j
    for f in ("lm_pos", "lm_opt_mask", "e_kf", "e_lm", "e_uv", "e_valid", "e_info"):
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)


def test_partition_counts_invalid_edges():
    """A global-problem-like table: most slots empty, clamped to landmark 0
    and invalid. They are grouped (and counted) like live edges, so shard 0
    holds them and every shard is padded to its count, as in the JAX
    package."""
    prob_j, prob_t, _ = _pair(Kw=4, Lw=50, noise_px=0.3)
    e_lm = np.asarray(prob_j.e_lm).copy()
    e_valid = np.asarray(prob_j.e_valid).copy()
    empty = np.arange(len(e_lm)) % 4 != 0
    e_lm[empty], e_valid[empty] = 0, False
    prob_j = prob_j._replace(e_lm=jnp.asarray(e_lm), e_valid=jnp.asarray(e_valid))
    prob_t = prob_t._replace(e_lm=torch.from_numpy(e_lm), e_valid=torch.from_numpy(e_valid))
    pj, _ = jsh.partition_by_landmark(prob_j, 8)
    pt, _ = tsh.partition_by_landmark(prob_t, 8)
    assert pt.e_kf.shape[0] == 8 * (int(empty.sum()) + int((e_lm[~empty] < 7).sum()))
    for f in ("e_kf", "e_lm", "e_uv", "e_valid"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), f)
    assert int(pt.e_valid.sum()) == int(e_valid.sum())


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("solver", ["edges", "landmarks"])
def test_solve_matches_jax(main_problem, solver, n):
    prob_j, prob_t, _ = main_problem
    jf, tf = SOLVERS[solver]
    out_j = jf(prob_j, jsh.make_mesh(n), iters=10, cg_iters=25)
    out_t = tf(prob_t, tsh.make_mesh(n, device="cpu"), iters=10, cg_iters=25)
    assert out_t[2].shape == np.asarray(out_j[2]).shape
    _assert_solves_match(out_t, out_j)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("solver", ["edges", "landmarks"])
def test_padded_solve_matches_jax(padded_problem, solver, n):
    """90 edges: the padding path (edge-sharded) and uneven landmark blocks."""
    prob_j, prob_t, _ = padded_problem
    jf, tf = SOLVERS[solver]
    out_j = jf(prob_j, jsh.make_mesh(n), iters=5, cg_iters=15)
    out_t = tf(prob_t, tsh.make_mesh(n, device="cpu"), iters=5, cg_iters=15)
    _assert_solves_match(out_t, out_j)
    costs = out_t[3].numpy()
    assert np.isfinite(costs).all() and costs[-1] < costs[0]


def test_sharded_basin_and_pose_error(main_problem):
    """tests/test_sharded_ba.py's asserts, on the port."""
    prob_j, prob_t, (R_true, t_true, X_true) = main_problem
    ref = jba.solve_ba(prob_j, iters=10, cg_iters=25, solver="pcg", phases=1)
    mesh = tsh.make_mesh(8, device="cpu")
    R, t, X, costs = tsh.solve_ba_sharded(prob_t, mesh, iters=10, cg_iters=25)
    assert float(costs[-1]) < float(ref.cost_history[0])
    assert np.linalg.norm(R.numpy() - np.asarray(ref.R_cw)) < 1e-2
    ang, dte = pose_errors(R.numpy(), t.numpy(), R_true, t_true)
    assert ang.max() < 0.2 and dte.max() < 0.05

    R, t, X, costs = tsh.solve_ba_sharded_lm(prob_t, mesh, iters=10, cg_iters=25)
    assert float(costs[-1]) < float(ref.cost_history[0])
    ang, dte = pose_errors(R.numpy(), t.numpy(), R_true, t_true)
    assert ang.max() < 0.2 and dte.max() < 0.05
    L = prob_t.lm_pos.shape[0]
    err_lm = np.linalg.norm(X.numpy()[:L] - X_true, axis=1)
    ref_lm = np.linalg.norm(np.asarray(ref.lm_pos) - X_true, axis=1)
    assert np.median(err_lm) < max(2.0 * np.median(ref_lm), 0.02)


def test_partition_preserves_edges(main_problem):
    """tests/test_sharded_ba.py::test_landmark_partitioning_preserves_edges
    on the port: every valid edge survives the regrouping."""
    _, prob_t, _ = main_problem
    p2, Ls = tsh.partition_by_landmark(prob_t, 8)
    assert int(p2.e_valid.sum()) == int(prob_t.e_valid.sum())
    shard = np.repeat(np.arange(8), p2.e_kf.shape[0] // 8)
    glm = p2.e_lm.numpy() + shard * Ls
    old = set(zip(prob_t.e_lm.tolist(), prob_t.e_kf.tolist(), prob_t.e_uv[:, 0].tolist()))
    ok = p2.e_valid.numpy()
    new = set(zip(glm[ok].tolist(), p2.e_kf.numpy()[ok].tolist(),
                  p2.e_uv[:, 0].numpy()[ok].tolist()))
    assert new == old


@pytest.mark.parametrize("solver", ["edges", "landmarks"])
def test_stereo_rows_stripped_with_warning(main_problem, solver):
    _, prob_t, _ = main_problem
    stereo = prob_t._replace(e_invd=torch.full((prob_t.e_kf.shape[0],), 0.1),
                             bf=torch.tensor(40.0))
    mesh = tsh.make_mesh(2, device="cpu")
    with pytest.warns(UserWarning, match="stereo"):
        out_s = SOLVERS[solver][1](stereo, mesh, iters=2, cg_iters=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out_m = SOLVERS[solver][1](prob_t, mesh, iters=2, cg_iters=5)
    for a, b in zip(out_s, out_m):
        assert torch.equal(a, b)


def test_mesh_of_one(main_problem):
    """On make_mesh(1) the sharded solver is solve_ba(solver="pcg",
    phases=1) up to reduction order (global_ba's own mesh-of-one dispatch:
    tests/test_torch_sharded_gba.py)."""
    _, prob_t, _ = main_problem
    mesh = tsh.make_mesh(1, device="cpu")
    assert mesh.size == 1 and mesh.rank_offset == 0
    R, t, X, _ = tsh.solve_ba_sharded(prob_t, mesh, iters=10, cg_iters=25)
    ref = tba.solve_ba(prob_t, iters=10, cg_iters=25, solver="pcg", phases=1)
    np.testing.assert_allclose(R.numpy(), ref.R_cw.numpy(), **SOLVE["R"])
    np.testing.assert_allclose(t.numpy(), ref.t_cw.numpy(), **SOLVE["t"])
    np.testing.assert_allclose(X.numpy(), ref.lm_pos.numpy(), **SOLVE["X"])


def test_repeats_to_the_bit(main_problem):
    _, prob_t, _ = main_problem
    mesh = tsh.make_mesh(8, device="cpu")
    for f in (tsh.solve_ba_sharded, tsh.solve_ba_sharded_lm):
        a, b = f(prob_t, mesh, iters=3, cg_iters=10), f(prob_t, mesh, iters=3, cg_iters=10)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n,size,chunk", [(1000, 7, 16), (50, 100, 4), (0, 5, 8),
                                          (300, 1, 1024), (777, 13, 1)])
def test_chunked_segment_sums(n, size, chunk):
    """The sharded solvers' segment sums (scatterless.seg_sum_chunked)
    against seg_sum: out-of-range indices dropped, empty segments 0, sums
    within f32 reordering, and equal to the bit where no segment is longer
    than a chunk or where a long segment's nonzero entries all fall in its
    first chunk and the rest are zeros (the padded rows of a shard)."""
    g = torch.Generator().manual_seed(n)
    idx = torch.randint(-2, size + 3, (n,), generator=g)
    v = torch.randn(n, 3, generator=g)
    a = scatterless.seg_sum(scatterless.segment_plan(idx, size), v)
    b = scatterless.seg_sum_chunked(scatterless.chunked_plan(idx, size, chunk), v)
    torch.testing.assert_close(b, a, atol=1e-5, rtol=0)
    if chunk >= n or chunk == 1:
        assert torch.equal(a, b)
    idx = torch.zeros(20000, dtype=torch.long)
    v = torch.zeros(20000, 6)
    v[:37] = torch.randn(37, 6, generator=g)
    assert torch.equal(scatterless.seg_sum(scatterless.segment_plan(idx, 4), v),
                       scatterless.seg_sum_chunked(scatterless.chunked_plan(idx, 4, 64), v))


def test_put_problem_blocks(padded_problem):
    """multihost.put_problem: each process keeps its contiguous block of the
    padded edges ([n_local * E/size] rows) and the whole variable set; the
    blocks of the processes, in rank order, are the padded table."""
    from rover_slam_tpu_torch.parallel import multihost
    _, prob_t, _ = padded_problem
    padded = tsh.pad_edges_to(prob_t, 8)
    blocks = []
    for rank in range(2):
        mesh = tsh.make_mesh(4, device="cpu")
        mesh.size, mesh.rank_offset = 8, 4 * rank     # as process `rank` of 2
        part = multihost.put_problem(prob_t, mesh)
        assert part.e_kf.shape[0] == padded.e_kf.shape[0] // 2
        assert torch.equal(part.lm_pos, prob_t.lm_pos) and torch.equal(part.R_cw, prob_t.R_cw)
        blocks.append(part)
    for f in ("e_kf", "e_lm", "e_uv", "e_valid", "e_info"):
        assert torch.equal(torch.cat([getattr(b, f) for b in blocks]), getattr(padded, f)), f
