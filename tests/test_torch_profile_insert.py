"""profile_insert_port.py's full inserts, the twin of profile_insert.py's
first three lines, against the JAX package on the CPU.

On one small snapshot (tests/profile_twins.snapshot: the ring-orbit map
the port builds, without the landmarks its newest keyframe created,
carried to JAX with to_jax_state), the port's
insert_stages against _insert_keyframe_kernel called as profile_insert.py
calls it, with 2 BA iterations, 1, and without the BA. Tolerances: the
insert's scalars [kf_id, n_new0, n_new1, n_obs, n_kf, n_lm, lm_dropped],
the local-map mask and the landmark ids exact; keyframe poses within 1e-4
and landmark positions within 1e-3 (POSE, POINT: the tracking parity
tests'). Every line carries the launches and syncs, and each stage's
outputs agree to the bit over its calls on fresh clones. The other stages:
tests/test_torch_profile_insert_stages.py; main(): tests/test_torch_profile_twins.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import profile_insert_port
from profile_twins import jax_insert_full, snapshot
from torch_parity import CAM, POINT, POSE, _np, to_jax_state


@pytest.fixture(scope="module")
def both():
    st = snapshot()
    lines = []
    res = profile_insert_port.insert_stages(st, CAM, warmup=1, reps=1, emit=lines.append)
    return st, res, jax_insert_full(to_jax_state(st), jnp.asarray(CAM)), lines


@pytest.mark.parametrize("name", ["insert_full(ba2)_ms", "insert_full(ba1)_ms", "insert_noba_ms"])
def test_insert_full(both, name):
    st, res, ref, _ = both
    scal, mask, lm_pos, R, t, li = res[name]["out"]
    st_j, scal_j, mask_j = ref[name]
    np.testing.assert_array_equal(_np(scal), np.asarray(scal_j))
    assert int(scal[4]) == int(st.n_kf) + 1 and int(scal[1]) + int(scal[2]) > 0
    np.testing.assert_array_equal(_np(mask), np.asarray(mask_j))
    np.testing.assert_array_equal(_np(li), np.asarray(st_j.kf_landmark_idx))
    act = np.asarray(st_j.kf_active)
    np.testing.assert_allclose(_np(R)[act], np.asarray(st_j.kf_R_cw)[act], **POSE)
    np.testing.assert_allclose(_np(t)[act], np.asarray(st_j.kf_t_cw)[act], **POSE)
    lm = np.asarray(st_j.lm_active)
    np.testing.assert_allclose(_np(lm_pos)[lm], np.asarray(st_j.lm_pos)[lm], **POINT)


def test_lines_carry_counts_and_repeat(both):
    """Every stage line ends in the launches and syncs (no kernel and no
    sync count on the CPU), and each stage's outputs agree to the bit over
    its two calls on fresh clones (chip_smoke.py path M's gate)."""
    st, res, _, lines = both
    assert lines[0] == (f"state: K={st.K} N={st.N} L={st.L} n_kf={int(st.n_kf)} "
                        f"n_lm={int(st.n_lm)}")
    assert [ln.split()[0] for ln in lines[1:]] == list(res)
    for ln in lines[1:]:
        assert ln.endswith(" b1=0 b2=0 syncs=None"), ln
    for name, r in res.items():
        assert np.isfinite(r["ms"]) and len(r["digests"]) == 2, name
        assert r["digests"][0] == r["digests"][1], name
