"""The loop closer's detection and verification programs of the port against
the JAX package, on one ring-orbit map the port built up to its revisit
(tests/test_loop_closing_e2e.py's scene, cut to 62 of 70 frames over 1.25
revolutions, tables 64 / 512 / 8192): place recognition with the database
insert, the Sim3 verification of the candidates (the JAX package's split
keys' draws handed in), the fire-time pair verification and the hypothesis
re-confirmation. Tolerances: packs, masks and counts exact, Sim3s and poses
atol 1e-4 (POSE), database rows atol 1e-7; per-candidate match and seed
inlier counts as _assert_packs_match states. The correction and fusion
programs are in tests/test_torch_loop_correct.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.map import keyframe_database as jkdb
from rover_slam_tpu.slam import loop_closing as jlc
from rover_slam_tpu_torch.map import keyframe_database as tkdb
from rover_slam_tpu_torch.slam import loop_closing as tlc

from torch_parity import CAM, POSE, _np, ring_orbit_state, to_jax_state

KW_J = dict(seed_chi2=jnp.asarray(36.0), min_seed=jnp.asarray(8),
            guided_radius=jnp.asarray(16.0), gn_iters=8)
KW_T = dict(seed_chi2=36.0, min_seed=8, guided_radius=16.0, gn_iters=8)


@pytest.fixture(scope="module")
def ring():
    st = ring_orbit_state()
    q = int(st.n_kf) - 1
    before = st.kf_active & (torch.arange(st.K) < q)
    db_t = tkdb.db_build_from_state(tkdb.empty_db(64, st.K, seed=3), st.kf_desc,
                                    st.kf_kpt_valid, before)
    st_j = to_jax_state(st)
    db_j = jkdb.db_build_from_state(jkdb.empty_db(64, st.K, seed=3), st_j.kf_desc,
                                    st_j.kf_kpt_valid, jnp.asarray(before.numpy()))
    return st, st_j, q, db_t, db_j


def _draws(st, q, cands, key, ext=None):
    """The JAX package's draws for each candidate's seed RANSAC: its split
    keys' weighted choice over the pairs with a landmark on both sides."""
    keys = jax.random.split(key, len(cands))
    out = []
    for b, c in enumerate(cands):
        _, _, ok, _, _, has_c, has_q = tlc._pair_inputs(
            st, q, int(np.clip(c, 0, st.K - 1)), None if ext is None else ext[b])
        both = (ok & has_c & has_q).numpy()
        p = jnp.asarray(both, jnp.float32) / max(int(both.sum()), 1)
        out.append(np.asarray(jax.random.choice(keys[b], len(both), shape=(300, 3),
                                                replace=True, p=p)))
    return torch.from_numpy(np.stack(out))


def _assert_packs_match(p_t, p_j, B):
    """Candidate ids, seed flags, the winner and its projection count
    exact; per candidate the mutual-NN match count within 1 % and the seed
    inliers within 2: the JAX package rounds descriptor distances to bf16
    and the port's matcher sums them in f32, so near-ties may pair another
    keypoint (tests/test_torch_reloc.py)."""
    np.testing.assert_array_equal(p_t[:B], p_j[:B])
    np.testing.assert_array_equal(p_t[2 * B:3 * B], p_j[2 * B:3 * B])
    np.testing.assert_array_equal(p_t[4 * B:], p_j[4 * B:])
    assert (np.abs(p_t[B:2 * B] - p_j[B:2 * B]) <= 0.01 * p_j[B:2 * B] + 1).all(), (p_t, p_j)
    assert (np.abs(p_t[3 * B:4 * B] - p_j[3 * B:4 * B]) <= 2).all(), (p_t, p_j)


def _candidates(ring):
    st, st_j, q, db_t, db_j = ring
    _, pack = jlc._detect_and_add_kernel(st_j, db_j, jnp.asarray(q, jnp.int32), 4, 10,
                                         jnp.asarray(3.0), jnp.asarray(15))
    return np.asarray(pack)[:2].astype(np.int64)


def test_detect_and_add(ring):
    st, st_j, q, db_t, db_j = ring
    db2_j, pack_j = jlc._detect_and_add_kernel(st_j, db_j, jnp.asarray(q, jnp.int32), 4, 10,
                                               jnp.asarray(3.0), jnp.asarray(15))
    db2_t, pack_t = tlc._detect_and_add_kernel(st, db_t, q, 4, 10, 3.0, 15)
    np.testing.assert_array_equal(pack_t.numpy()[:4], np.asarray(pack_j)[:4])
    np.testing.assert_allclose(pack_t.numpy()[4:], np.asarray(pack_j)[4:], atol=1e-6)
    np.testing.assert_array_equal(db2_t.active.numpy(), np.asarray(db2_j.active))
    np.testing.assert_allclose(db2_t.tf.numpy(), np.asarray(db2_j.tf), atol=1e-7)
    ids = pack_t.numpy()[:4]
    # The revisit: the best candidate is one of the first keyframes.
    assert 0 <= ids[0] < 5 and q - ids[0] > 10


@pytest.mark.parametrize("cands", ["retrieved", "padded"])
def test_sim3_candidates(ring, cands):
    st, st_j, q, _, _ = ring
    ids = _candidates(ring)
    if cands == "padded":
        ids = np.asarray([ids[0], -1])
    key = jax.random.PRNGKey(7)
    pack_j, *sim3_j = jlc._sim3_candidates_kernel(
        st_j, jnp.asarray(q, jnp.int32), jnp.asarray(ids, jnp.int32), jnp.asarray(CAM), key,
        0, False, **KW_J)
    pack_t, *sim3_t = tlc._sim3_candidates_kernel(
        st, q, ids, torch.from_numpy(CAM), None, 0, False, samples=_draws(st, q, ids, key),
        **KW_T)
    _assert_packs_match(pack_t.numpy(), np.asarray(pack_j), len(ids))
    for a, b in zip(sim3_t, sim3_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), **POSE)
    B = len(ids)
    assert pack_t.numpy()[2 * B] == 1 and pack_t.numpy()[-1] >= 40   # seeded and verified
    # No candidate at all: the skip pack, the identity Sim3, no device work.
    pack_t, s, R, t = tlc._sim3_candidates_kernel(st, q, np.asarray([-1, -1]),
                                                  torch.from_numpy(CAM), None, 0, False)
    pack_j, s_j, R_j, t_j = jlc._sim3_candidates_kernel(
        st_j, jnp.asarray(q, jnp.int32), jnp.asarray([-1, -1], jnp.int32), jnp.asarray(CAM),
        key, 0, False, **KW_J)
    np.testing.assert_array_equal(pack_t.numpy(), np.asarray(pack_j))
    assert float(s) == float(s_j) == 1.0 and bool((R == torch.eye(3)).all())
    assert bool((t == 0).all())


def test_sim3_pair_guided_and_hypothesis(ring):
    st, st_j, q, _, _ = ring
    c = int(_candidates(ring)[0])
    key = jax.random.PRNGKey(9)
    out_j = jlc._sim3_pair_guided(st_j, jnp.asarray(q, jnp.int32), jnp.asarray(c, jnp.int32),
                                  jnp.asarray(CAM), key, 0, False, **KW_J)
    _, _, ok, _, _, has_c, has_q = tlc._pair_inputs(st, q, c)
    both = (ok & has_c & has_q).numpy()
    samples = np.asarray(jax.random.choice(
        key, len(both), shape=(300, 3), replace=True,
        p=jnp.asarray(both, jnp.float32) / max(int(both.sum()), 1)))
    out_t = tlc._sim3_pair_guided(st, q, c, torch.from_numpy(CAM), None, 0, False,
                                  samples=torch.from_numpy(samples), **KW_T)
    assert bool(out_t[0]) == bool(out_j[0]) is True
    assert int(out_t[1]) == int(out_j[1]) and int(out_t[5]) == int(out_j[5])
    for a, b in zip(out_t[2:5], out_j[2:5]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **POSE)
    # Re-confirmation from the previous keyframe's view of the hypothesis.
    s, R, t = (np.asarray(x) for x in out_j[2:5])
    hj = jlc._verify_hypothesis_kernel(st_j, jnp.asarray(q, jnp.int32),
                                       jnp.asarray(q - 1, jnp.int32), jnp.asarray(c, jnp.int32),
                                       jnp.asarray(s), jnp.asarray(R), jnp.asarray(t),
                                       jnp.asarray(CAM), 0)
    ht = tlc._verify_hypothesis_kernel(st, q, q - 1, c, *(torch.from_numpy(x) for x in (s, R, t)),
                                       torch.from_numpy(CAM), 0)
    assert int(ht[0]) == int(hj[0]) >= 25
    for a, b in zip(ht[1:], hj[1:]):
        np.testing.assert_allclose(_np(a), np.asarray(b), **POSE)
