"""Global bundle adjustment and place recognition of the port against the
JAX package, on a map the port built: the PCG solver, global BA at
compaction levels 0 and 1, the shipped codebooks against the JAX package's
generator, the database build, permutation and candidate ranking.
Tolerances: poses atol 1e-4 (POSE), points atol 1e-3 (POINT), observation
tables, inlier masks and candidate ids exact, tf vectors atol 1e-7."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import make_bow_codebooks
from rover_slam_tpu.map import keyframe_database as jkdb, maintenance as jmnt
from rover_slam_tpu.optim import ba as jba
from rover_slam_tpu_torch.map import keyframe_database as tkdb, maintenance as tmnt
from rover_slam_tpu_torch.optim import ba as tba
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import CAM, POINT, POSE, _np, jax_problem, synthetic_frames, to_jax_state


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def _close(t_out, j_out, tol):
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# PCG bundle adjustment and global BA
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """A map the port built over 20 frames of the forward scene, on tables
    (64, 512, 8192): global BA level 0 compacts edges and landmarks, level 1
    neither."""
    world, frames, _ = synthetic_frames(20)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                         device="cpu")
    for f in frames:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 3
    st = slam.state
    rng = np.random.default_rng(3)
    # Perturb the map so the solvers have work to do.
    st = st.replace(lm_pos=st.lm_pos + torch.from_numpy(
        rng.normal(0, 0.01, st.lm_pos.shape).astype(np.float32)))
    return st, to_jax_state(st)


def test_solve_ba_pcg(scene):
    st, _ = scene
    prob_t, _ = tmnt._build_global_problem(st, torch.from_numpy(CAM))
    prob_j = jax_problem(jba.BAProblem, prob_t)
    rj = jba.solve_ba(prob_j, iters=2, cg_iters=25, solver="pcg", phases=2, kf_major=True,
                      lm_cap=2048)
    rt = tba.solve_ba(prob_t, iters=2, cg_iters=25, solver="pcg", phases=2, lm_cap=2048)
    _close((rt.R_cw, rt.t_cw), (rj.R_cw, rj.t_cw), POSE)
    _close((rt.lm_pos,), (rj.lm_pos,), POINT)
    np.testing.assert_array_equal(rt.e_inlier.numpy(), np.asarray(rj.e_inlier))


@pytest.mark.parametrize("level", [0, 1])
def test_global_ba_levels(scene, level):
    """Level 0 compacts the edge list, and the JAX package still sums the
    pose side by position (kf_major, ROADMAP.md §C): the system is then badly
    conditioned, landmarks move up to a metre in one iteration, and the port
    and the JAX package each land about 2e-3 from a float64 run of the same
    solve. Level 0 therefore holds points to 5e-3; level 1 to POINT."""
    st, st_j = scene
    n_edges = tmnt.count_global_edges(st)
    assert n_edges == jmnt.count_global_edges(st_j)
    assert tmnt.gba_level_for(n_edges) == jmnt.gba_level_for(n_edges)
    out_j = jmnt.global_ba(st_j, jnp.asarray(CAM), iters=1, level=level)
    out_t = tmnt.global_ba(st, torch.from_numpy(CAM), iters=1, level=level)
    act = np.asarray(st_j.kf_active)
    np.testing.assert_allclose(out_t.kf_R_cw.numpy()[act], np.asarray(out_j.kf_R_cw)[act],
                               **POSE)
    np.testing.assert_allclose(out_t.kf_t_cw.numpy()[act], np.asarray(out_j.kf_t_cw)[act],
                               **POSE)
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm],
                               **(dict(atol=5e-3, rtol=0) if level == 0 else POINT))
    np.testing.assert_array_equal(out_t.kf_landmark_idx.numpy(),
                                  np.asarray(out_j.kf_landmark_idx))


def test_global_ba_mesh_raises(scene):
    """Named for when global_ba(mesh=) raised (A17): it now runs the
    landmark-sharded solver over the whole padded table, drops no outlier,
    and lands within 5e-3 of the single-device path on active keyframes
    (tests/test_sharded_ba.py's bound; its parity with the JAX package:
    tests/test_torch_sharded_gba.py)."""
    from rover_slam_tpu_torch.parallel import sharded_ba
    st, _ = scene
    cam = torch.from_numpy(CAM)
    out = tmnt.global_ba(st, cam, iters=1, mesh=sharded_ba.make_mesh(2, device="cpu"))
    ref = tmnt.global_ba(st, cam, iters=1)
    assert torch.equal(out.kf_landmark_idx, st.kf_landmark_idx)
    act = st.kf_active.numpy()
    assert np.isfinite(out.lm_pos.numpy()).all()
    assert np.abs(out.kf_t_cw.numpy() - ref.kf_t_cw.numpy())[act].max() < 5e-3


# --------------------------------------------------------------------------
# Place recognition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("desc_dim", [64, 256])
def test_codebook_asset_is_the_jax_vocabulary(desc_dim):
    shipped = tkdb.make_vocab(desc_dim, 2048, 3).codebook.numpy()
    ref = make_bow_codebooks.generate([(desc_dim, 3)])[make_bow_codebooks.key(desc_dim, 2048, 3)]
    assert shipped.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(shipped, ref)
    with pytest.raises(KeyError, match="make_bow_codebooks.py"):
        tkdb.make_vocab(desc_dim, 2048, 12345)


def _db_pair(scene):
    st, st_j = scene
    db_t = tkdb.db_build_from_state(tkdb.empty_db(64, st.K, seed=3), st.kf_desc,
                                    st.kf_kpt_valid, st.kf_active)
    db_j = jkdb.db_build_from_state(jkdb.empty_db(64, st.K, seed=3), st_j.kf_desc,
                                    st_j.kf_kpt_valid, st_j.kf_active)
    return db_t, db_j


def test_db_build_and_permute(scene):
    db_t, db_j = _db_pair(scene)
    np.testing.assert_array_equal(db_t.active.numpy(), np.asarray(db_j.active))
    np.testing.assert_allclose(db_t.tf.numpy(), np.asarray(db_j.tf), atol=1e-7)
    K = db_t.tf.shape[0]
    rng = np.random.default_rng(4)
    perm = rng.permutation(K).astype(np.int32)
    live = np.arange(K) < K - 5
    p_t = tkdb.db_permute(db_t, *_t(perm, live))
    p_j = jkdb.db_permute(db_j, *_j(perm, live))
    np.testing.assert_array_equal(p_t.active.numpy(), np.asarray(p_j.active))
    np.testing.assert_allclose(p_t.tf.numpy(), np.asarray(p_j.tf), atol=1e-7)
    # db_add of one keyframe equals its row of the rebuilt database.
    st, _ = scene
    one = tkdb.db_add(tkdb.empty_db(64, K, seed=3), 2, st.kf_desc[2], st.kf_kpt_valid[2])
    np.testing.assert_array_equal(one.tf[2].numpy(), db_t.tf[2].numpy())


def test_detect_candidates_ranked(scene):
    st, st_j = scene
    db_t, db_j = _db_pair(scene)
    n_kf = int(st.n_kf)
    conn = np.zeros(st.K, bool)
    conn[n_kf - 3:n_kf] = True
    for q in (n_kf - 1, 1):
        # The query is a noisy copy of keyframe q's descriptors.
        rng = np.random.default_rng(q)
        d = st.kf_desc[q].numpy() + rng.normal(0, 0.02, st.kf_desc[q].shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        v = st.kf_kpt_valid[q].numpy()
        tf_t = tkdb.bow_transform(db_t.vocab, torch.from_numpy(d), torch.from_numpy(v))
        tf_j = jkdb.bow_transform(db_j.vocab, jnp.asarray(d), jnp.asarray(v))
        np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j), atol=1e-7)
        for c in (np.zeros(st.K, bool), conn):
            ids_t, sc_t = tkdb.detect_candidates(db_t, tf_t, q, torch.from_numpy(c), n_best=4)
            ids_j, sc_j = jkdb.detect_candidates(db_j, tf_j, q, jnp.asarray(c), n_best=4)
            np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
            np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-6)
            assert (ids_t.numpy() >= 0).any()
