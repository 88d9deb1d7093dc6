"""The map's slot lifecycle in the port against the JAX package: keyframe
culling (redundancy and oldest-first) with its redirect record, slot
compaction with its renumbering, and the Atlas's new map. Culling, compaction
and the Atlas are integer and permutation work, so the maps must agree to the
bit; the frozen relative poses within 1e-5."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.map import atlas as jatlas, map_state as jms, maintenance as jmnt
from rover_slam_tpu_torch.map import atlas as tatlas, map_state as tms, maintenance as tmnt
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import _np, assert_states_equal, from_jax_state, synthetic_frames, \
    to_jax_state


def _tiny_map(K=8, N=4, L=16, D=8, n_kf=4):
    """tests/test_map_lifecycle.py's map: two landmarks per keyframe,
    keyframes chained by parents."""
    st = jms.empty_map(K=K, N=N, L=L, D=D)
    nl = 2 * n_kf
    st, _ = jms.add_landmarks(st, jnp.arange(nl * 3, dtype=jnp.float32).reshape(nl, 3),
                              jnp.zeros((nl, D)), jnp.zeros((nl, 3)),
                              jnp.zeros((nl,), jnp.int32), jnp.ones((nl,), bool))
    for k in range(n_kf):
        lidx = jnp.asarray([2 * k, 2 * k + 1, -1, -1], jnp.int32)
        st, _ = jms.add_keyframe(st, jnp.eye(3), jnp.full((3,), float(k)), jnp.zeros((N, 2)),
                                 jnp.ones((N, 3)), jnp.zeros((N, D)), jnp.ones((N,), bool),
                                 lidx, jnp.asarray(float(k)),
                                 parent=jnp.asarray(k - 1, jnp.int32))
    return st


def _shared_map(parents: bool, loop_edge=False):
    """tests/test_map_extras.py's map: six keyframes all seeing the same 12
    landmarks (chained by parents, or not), poses spread so the frozen
    relative poses are not trivial."""
    st = jms.empty_map(K=8, N=16, L=64, D=16)
    st, _ = jms.add_landmarks(st, jnp.zeros((12, 3)), jnp.zeros((12, 16)), jnp.zeros((12, 3)),
                              jnp.zeros(12, jnp.int32), jnp.ones(12, bool))
    lidx = np.full(16, -1)
    lidx[:12] = np.arange(12)
    rng = np.random.default_rng(1)
    from rover_slam_tpu.geometry import lie as jlie
    for k in range(6):
        R = jlie.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32))
        st, _ = jms.add_keyframe(st, R, jnp.asarray(rng.normal(0, 1, 3), jnp.float32),
                                 jnp.zeros((16, 2)), jnp.ones((16, 3)), jnp.zeros((16, 16)),
                                 jnp.asarray(np.arange(16) < 12), jnp.asarray(lidx, jnp.int32),
                                 float(k),
                                 parent=jnp.asarray(k - 1, jnp.int32) if parents else None)
    if loop_edge:
        st = st.replace(kf_loop_edges=st.kf_loop_edges.at[2, 3].set(True).at[3, 2].set(True))
    return st


def _assert_cull_matches(out_t, out_j):
    st_t, n_t, red_t = out_t
    st_j, n_j, red_j = out_j
    assert int(n_t) == int(n_j)
    assert_states_equal(st_t, st_j)
    np.testing.assert_array_equal(_np(red_t[0]), _np(red_j[0]))          # cull mask
    np.testing.assert_array_equal(_np(red_t[1]), _np(red_j[1]))          # survivor
    np.testing.assert_allclose(_np(red_t[2]), _np(red_j[2]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(red_t[3]), _np(red_j[3]), atol=1e-5, rtol=0)
    return int(n_t)


def _assert_compaction_matches(st_j):
    out_t = tms.compact_map(from_jax_state(st_j))
    out_j = jms.compact_map(jax.tree.map(jnp.copy, st_j))     # compact_map donates its input
    assert_states_equal(out_t[0], out_j[0])
    np.testing.assert_array_equal(_np(out_t[1]), _np(out_j[1]))
    np.testing.assert_array_equal(_np(out_t[2]), _np(out_j[2]))
    return out_t


def test_compact_map_remaps_indices():
    """tests/test_map_lifecycle.py: keyframe 1 and landmark 2 culled."""
    st = _tiny_map()
    st = st.replace(kf_active=st.kf_active.at[1].set(False),
                    kf_landmark_idx=jnp.where(jnp.arange(st.K)[:, None] == 1, -1,
                                              st.kf_landmark_idx))
    st = jms.remove_landmarks(st, jnp.arange(st.L) == 2)
    st = st.replace(kf_parent=st.kf_parent.at[2].set(0))
    new, kf_o2n, lm_o2n = _assert_compaction_matches(st)
    assert kf_o2n.tolist()[:4] == [0, -1, 1, 2] and int(new.n_lm) == 7


def test_compact_map_drops_orphans_and_reanchors():
    """Keyframe 0 gone: its landmarks are orphans and drop; landmarks anchored
    at a culled keyframe but seen elsewhere move their anchor."""
    st = _tiny_map()
    st = st.replace(kf_active=st.kf_active.at[0].set(False),
                    kf_landmark_idx=jnp.where(jnp.arange(st.K)[:, None] == 0, -1,
                                              st.kf_landmark_idx)
                    .at[2, 2].set(0).at[3, 3].set(1))      # kf 2, 3 see lm 0 and 1 too
    new, _, lm_o2n = _assert_compaction_matches(st)
    assert int(lm_o2n[0]) >= 0 and int(new.lm_anchor_kf[int(lm_o2n[0])]) == 1


@pytest.mark.parametrize("parents,loop_edge", [(False, False), (True, False), (True, True)])
def test_cull_keyframes_ex(parents, loop_edge):
    """tests/test_map_extras.py's scenes: redundant keyframes, the spanning
    tree re-parented across culled chains, loop-edge endpoints spared."""
    st = _shared_map(parents, loop_edge)
    out_t = tmnt.cull_keyframes_ex(from_jax_state(st))
    n = _assert_cull_matches(out_t, jmnt.cull_keyframes_ex(st))
    assert n == (0 if loop_edge else 2)          # 0, 1 and the newest two are protected
    if loop_edge:
        assert bool(out_t[0].kf_active[2]) and bool(out_t[0].kf_active[3])
    st_t, n_t = tmnt.cull_keyframes(from_jax_state(st))
    assert int(n_t) == n
    _assert_compaction_matches(jmnt.cull_keyframes_ex(st)[0])


def test_cull_redirect_record():
    """tests/test_map_lifecycle.py: the frozen pose relative to the surviving
    ancestor composes back to the culled keyframe's pose."""
    st = _tiny_map(n_kf=6)
    lidx_all = jnp.tile(jnp.asarray([4, 5, -1, -1], jnp.int32)[None], (6, 1))
    st = st.replace(kf_landmark_idx=st.kf_landmark_idx.at[:6].set(lidx_all))
    out_t = tmnt.cull_keyframes_ex(from_jax_state(st))
    assert _assert_cull_matches(out_t, jmnt.cull_keyframes_ex(st)) >= 1
    cull, surv, R_cp, t_cp = (_np(a) for a in out_t[2])
    k = int(np.nonzero(cull)[0][0])
    p = int(surv[k])
    Rp, tp = _np(st.kf_R_cw[p]), _np(st.kf_t_cw[p])
    np.testing.assert_allclose(R_cp[k] @ Rp, _np(st.kf_R_cw[k]), atol=1e-5)
    np.testing.assert_allclose(R_cp[k] @ tp + t_cp[k], _np(st.kf_t_cw[k]), atol=1e-5)


@pytest.mark.parametrize("n_free,protect_recent", [(2, 2), (4, 8), (3, 1)])
def test_cull_oldest_ex(n_free, protect_recent):
    st = _shared_map(parents=True, loop_edge=True)
    out_t = tmnt.cull_oldest_ex(from_jax_state(st), n_free=n_free,
                                protect_recent=protect_recent)
    out_j = jmnt.cull_oldest_ex(st, n_free=n_free, protect_recent=protect_recent)
    _assert_cull_matches(out_t, out_j)


def test_create_new_map_and_masks():
    st = _shared_map(parents=True)
    st_t = tatlas.create_new_map(from_jax_state(st))
    st_j = jatlas.create_new_map(st)
    assert_states_equal(st_t, st_j)
    # The new map's first keyframe and landmarks carry the new id.
    st_j, _ = jms.add_landmarks(st_j, jnp.ones((3, 3)), jnp.zeros((3, 16)), jnp.zeros((3, 3)),
                                jnp.zeros(3, jnp.int32), jnp.ones(3, bool))
    for a, b in zip(tatlas.active_map_masks(from_jax_state(st_j)),
                    jatlas.active_map_masks(st_j)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert int(tatlas.active_map_masks(from_jax_state(st_j))[1].sum()) == 3


@pytest.fixture(scope="module")
def built_map():
    """A map the port built over 12 frames of the synthetic world, a keyframe
    every other frame."""
    from rover_slam_tpu_torch.slam.tracking import TrackerConfig
    world, frames, _ = synthetic_frames(14)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 4096), desc_dim=64,
                         config=TrackerConfig(kf_min_interval=0, kf_tracked_ratio=1.0,
                                              kf_max_interval=2), device="cpu")
    for f in frames[:12]:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 4
    return slam


def test_cull_and_compact_built_map(built_map):
    """A real map: cull at a lowered redundancy (so something goes), then
    compact; a frame's landmark ids follow the renumbering."""
    st_j = to_jax_state(built_map.state)
    out_t = tmnt.cull_keyframes_ex(from_jax_state(st_j), redundancy=0.3, min_kept_obs=1)
    out_j = jmnt.cull_keyframes_ex(st_j, redundancy=0.3, min_kept_obs=1)
    assert _assert_cull_matches(out_t, out_j) >= 1
    st_j = jms.remove_landmarks(out_j[0], jnp.arange(st_j.L) % 7 == 3)
    _, _, lm_o2n = _assert_compaction_matches(st_j)
    lidx = built_map.last_frame.landmark_idx
    np.testing.assert_array_equal(
        _np(tms.remap_landmark_refs(lidx, lm_o2n)),
        _np(jms.remap_landmark_refs(jnp.asarray(lidx.numpy()), jnp.asarray(lm_o2n.numpy()))))
    out_t = tmnt.cull_oldest_ex(from_jax_state(st_j), n_free=2, protect_recent=2)
    _assert_cull_matches(out_t, jmnt.cull_oldest_ex(st_j, n_free=2, protect_recent=2))


def test_map_state_carries_loop_edges():
    """kf_loop_edges crosses between the two MapStates and starts all False."""
    st = _shared_map(parents=True, loop_edge=True)
    back = from_jax_state(st)
    assert back.kf_loop_edges.dtype == torch.bool and int(back.kf_loop_edges.sum()) == 2
    assert not bool(tms.empty_map(K=4, N=8, L=16, D=8).kf_loop_edges.any())
    assert_states_equal(back, st)
