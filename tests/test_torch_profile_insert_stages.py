"""profile_insert_port.py's stage lines, the twin of profile_insert.py's
split of the insert, against the JAX package on the CPU.

On one small snapshot (tests/profile_twins.snapshot: the ring-orbit map
the port builds, without the landmarks its newest keyframe created,
carried to JAX with to_jax_state), each stage of the
port's insert_stages against the JAX call written as profile_insert.py's
line writes it (tests/profile_twins.jax_insert_stages). Tolerances:
integer outputs (the best covisible keyframes, n0 / n1, the fused and added
counts, the window and its mask, the local-map mask, lm_found) exact; the
observation matrix and the covisibility weights exact (0 / 1 and integer
counts); landmark positions within 1e-3 (POINT, the maintenance parity
tests'; after the local BA, a landmark one window edge observes only across
its ray: test_local_ba); normals within 1e-4 (assert_states_match's); the distinctive
descriptors by assert_desc_equivalent (equal medians where a tie picked
another observation, ROADMAP.md §C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import profile_insert_port
from rover_slam_tpu_torch.slam import tracking as tT
from profile_twins import jax_insert_stages, snapshot
from torch_parity import CAM, POINT, _np, assert_desc_equivalent, to_jax_state


@pytest.fixture(scope="module")
def both():
    st = snapshot()
    res = profile_insert_port.insert_stages(st, CAM, warmup=0, reps=1, emit=lambda *a: None)
    return st, res, jax_insert_stages(to_jax_state(st), jnp.asarray(CAM))


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("name", ["obs+covis_ms", "covis_window_ms"])
def test_covisibility_and_window(both, name):
    _, res, ref = both
    for a, b in zip(res[name]["out"], ref[name], strict=True):
        _eq(a, b)


def test_triangulate_x2(both):
    _, res, ref = both
    obs, ids, wts = res["obs+covis_ms"]["out"]
    assert int(ids[0]) >= 0 and float(wts[0]) >= 10          # the first pair runs
    pos, n0, n1 = res["triangulate_x2_ms"]["out"]
    pos_j, n0_j, n1_j, st_j = ref["triangulate_x2_ms"]
    assert (int(n0), int(n1)) == (int(n0_j), int(n1_j)) and int(n0) > 0
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(_np(pos)[lm], np.asarray(pos_j)[lm], **POINT)


def test_fuse(both):
    _, res, ref = both
    pos, a, b = res["fuse_ms"]["out"]
    pos_j, a_j, b_j, st_j = ref["fuse_ms"]
    assert (int(a), int(b)) == (int(a_j), int(b_j))
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(_np(pos)[lm], np.asarray(pos_j)[lm], **POINT)


def test_distinctive_desc(both):
    st, res, ref = both
    assert_desc_equivalent(st.replace(lm_desc=res["distinctive_desc_ms"]["out"]),
                           ref["distinctive_desc_ms"])


@pytest.mark.parametrize("it", [1, 2, 4])
def test_local_ba(both, it):
    """Landmark positions within POINT, except along the ray of a landmark
    that one edge of the window observes: the BA optimizes it (as the
    reference does) but its one observation leaves its depth to the LM
    damping, where the two packages' roundings part (1.6e-3 after one
    iteration on this snapshot, 1.4e-4 after two). Across that ray it is
    held to POINT too."""
    st, res, ref = both
    win, opt_mask = res["covis_window_ms"]["out"]
    prob = tT._ba_window_args(st, win, opt_mask, torch.from_numpy(CAM))
    e_lm = _np(prob.e_lm)[_np(prob.e_valid)]
    n_edges = np.bincount(e_lm, minlength=st.L)
    name = f"local_ba_iters{it}_ms"
    a, b = _np(res[name]["out"]), np.asarray(ref[name])
    lm = _np(st.lm_active)
    np.testing.assert_allclose(a[lm & (n_edges != 1)], b[lm & (n_edges != 1)], **POINT)
    one = np.nonzero(lm & (n_edges == 1))[0]
    order = np.argsort(e_lm, kind="stable")
    kf = _np(prob.e_kf)[_np(prob.e_valid)][order][np.searchsorted(e_lm[order], one)]
    R, t = _np(st.kf_R_cw)[_np(win)[kf]], _np(st.kf_t_cw)[_np(win)[kf]]
    centers = -np.einsum("nji,nj->ni", R, t)
    u = a[one] - centers
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    d = a[one] - b[one]
    across = d - (d * u).sum(1, keepdims=True) * u
    assert np.abs(across).max(initial=0.0) <= POINT["atol"]


def test_stats_cull_normals_mask(both):
    _, res, ref = both
    nn_, mask, found = res["stats_cull_normals_mask_ms"]["out"]
    nn_j, mask_j, found_j = ref["stats_cull_normals_mask_ms"]
    _eq(mask, mask_j)
    _eq(found, found_j)
    m = _np(mask)
    assert m.any()
    np.testing.assert_allclose(_np(nn_)[m], np.asarray(nn_j)[m], atol=1e-4, rtol=0)
