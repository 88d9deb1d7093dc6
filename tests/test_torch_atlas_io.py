"""Atlas persistence and map-id bookkeeping of the port against the JAX
package (rover_slam_tpu/map/atlas.py, map_state.compute_normals_and_depths):
one on-disk format both ways, every MapState field exact after a round trip
(the inertial body state included), the checksum gate refusing a corrupted
file on either side, merge_maps and the anchor normals on the same state
(normals atol 1e-6)."""
import json

import numpy as np
import pytest
import torch

from rover_slam_tpu.map import atlas as jat, map_state as jms
from rover_slam_tpu_torch.map import atlas as tat, map_state as tms

from torch_parity import to_jax_state


def random_state(seed=0, K=6, N=8, L=20, D=8) -> tms.MapState:
    """Every field of a small port MapState filled from a seeded generator."""
    rng = np.random.default_rng(seed)
    st = tms.empty_map(K=K, N=N, L=L, D=D, device="cpu")
    fields = {}
    for f in tms.FIELDS:
        a = getattr(st, f)
        if a.dtype == torch.bool:
            v = rng.uniform(size=a.shape) < 0.6
        elif a.dtype == torch.int32:
            hi = {"kf_landmark_idx": L, "lm_anchor_kf": K, "lm_first_kf": K,
                  "kf_parent": K}.get(f, 3)
            v = rng.integers(-1, hi, a.shape).astype(np.int32)
        else:
            v = rng.normal(0, 2, a.shape).astype(np.float32)
        fields[f] = torch.from_numpy(np.asarray(v))
    fields.update(n_kf=torch.tensor(4, dtype=torch.int32),
                  n_lm=torch.tensor(15, dtype=torch.int32),
                  active_map_id=torch.tensor(2, dtype=torch.int32),
                  lm_dropped=torch.tensor(5, dtype=torch.int32))
    return tms.MapState(**fields)


def assert_fields_equal(st_t: tms.MapState, st_j):
    for f in tms.FIELDS:
        a, b = getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_merge_maps():
    st = random_state(1)
    st_j = to_jax_state(st)
    for keep, absorb in ((0, 1), (2, 0), (1, 2)):
        assert_fields_equal(tat.merge_maps(st, keep, absorb), jat.merge_maps(st_j, keep, absorb))


def test_port_atlas_loads_in_jax(tmp_path):
    st = random_state(2)
    p = str(tmp_path / "port_atlas.npz")
    digest = tat.save_atlas(st, p, metadata={"seq": "port"})
    with open(p + ".meta.json") as f:
        meta = json.load(f)
    assert meta["sha256"] == digest == jat._sha256(p) and meta["seq"] == "port"
    st_j = jat.load_atlas(p)
    assert_fields_equal(st, st_j)
    np.testing.assert_array_equal(np.asarray(st_j.kf_kpt_invd), -1.0)
    assert_fields_equal(tat.load_atlas(p), st_j)


def test_jax_atlas_loads_in_port(tmp_path):
    st = random_state(3)
    st_j = to_jax_state(st)
    p = str(tmp_path / "jax_atlas.npz")
    jat.save_atlas(st_j, p)
    assert tat._sha256(p) == jat._sha256(p)
    back = tat.load_atlas(p)
    assert_fields_equal(back, st_j)
    for f in ("kf_R_wb", "kf_p_wb", "kf_v_wb", "kf_bg", "kf_ba"):   # the body state
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(st, f).numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_checksum_gate(tmp_path, writer, reader):
    st = random_state(4)
    p = str(tmp_path / "atlas.npz")
    if writer == "jax":
        jat.save_atlas(to_jax_state(st), p)
    else:
        tat.save_atlas(st, p)
    with open(p, "r+b") as f:
        f.seek(100)
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="checksum"):
        (jat if reader == "jax" else tat).load_atlas(p)


def test_stereo_atlas_and_old_counters(tmp_path):
    """A stereo atlas (kf_kpt_invd >= 0) raises naming A16; a checkpoint
    without the lm_dropped counter loads with it at zero, as in the JAX
    package."""
    st_j = to_jax_state(random_state(5))
    p = str(tmp_path / "stereo.npz")
    jat.save_atlas(st_j.replace(kf_kpt_invd=st_j.kf_kpt_invd.at[0, 0].set(0.2)), p)
    with pytest.raises(NotImplementedError, match="A16"):
        tat.load_atlas(p)
    arrays = {f: np.asarray(getattr(st_j, f)) for f in st_j.__dataclass_fields__
              if f != "lm_dropped"}
    p2 = str(tmp_path / "old.npz")
    np.savez(p2, **arrays)
    assert int(tat.load_atlas(p2, verify=False).lm_dropped) == 0
    assert int(jat.load_atlas(p2, verify=False).lm_dropped) == 0


def test_compute_normals_and_depths():
    """tests/test_map_state.py::test_normals_point_from_camera's case, then a
    random state (anchors -1 clip to keyframe 0, inactive landmarks keep
    their normals)."""
    st = tms.empty_map(K=2, N=8, L=32, D=16, device="cpu")
    st, _ = tms.add_landmarks(st, torch.tensor([[0.0, 0.0, 5.0]]), torch.zeros(1, 16),
                              torch.zeros(1, 3), torch.zeros(1, dtype=torch.int32),
                              torch.ones(1, dtype=torch.bool))
    st, _ = tms.add_keyframe(st, torch.eye(3), torch.zeros(3), torch.zeros(8, 2),
                             torch.ones(8, 3), torch.zeros(8, 16),
                             torch.ones(8, dtype=torch.bool),
                             torch.full((8,), -1, dtype=torch.int32), 0.0)
    st = tms.compute_normals_and_depths(st)
    np.testing.assert_allclose(st.lm_normal[0].numpy(), [0, 0, 1], atol=1e-6)
    st = random_state(6)
    got = tms.compute_normals_and_depths(st)
    want = jms.compute_normals_and_depths(to_jax_state(st))
    np.testing.assert_allclose(got.lm_normal.numpy(), np.asarray(want.lm_normal), atol=1e-6)
