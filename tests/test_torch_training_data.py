"""The port's training data (rover_slam_tpu_torch/training/data.py and the
LightGlue trainer's labels) against the JAX package's: the same seed gives
the same pairs, labels and batches to the bit; the f32 Rodrigues is the JAX
package's to the bit; sprite_ids and gt_assignment agree."""
import numpy as np
import pytest

import torch_parity  # noqa: F401  (caps torch's threads under xdist)
from rover_slam_tpu.geometry import lie as jlie
from rover_slam_tpu.training import data as jdata, lightglue_train as jlgt
from rover_slam_tpu_torch.training import data as tdata, lightglue_train as tlgt


def _equal(a, b):
    if hasattr(a, "_fields"):
        assert a._fields == b._fields
        a, b = a._asdict(), b._asdict()
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_so3_exp_f32_is_the_jax_rodrigues():
    """Random angles up to the trainer's 10 degrees, and tiny ones (the
    Taylor branch)."""
    rng = np.random.default_rng(0)
    for i in range(600):
        w = rng.normal(size=3)
        scale = np.deg2rad(rng.uniform(0, 10)) if i % 3 else 10.0 ** rng.uniform(-9, -3)
        w = w / (np.linalg.norm(w) + 1e-9) * scale
        np.testing.assert_array_equal(tdata.so3_exp_f32(w), np.asarray(jlie.so3_exp(w)),
                                      err_msg=str(w))


@pytest.mark.parametrize("seed,hw", [(0, (240, 320)), (1, (240, 320)), (5, (48, 64))])
def test_make_pair_and_labels(seed, hw):
    a = jdata.make_pair(np.random.default_rng(seed), image_hw=hw)
    b = tdata.make_pair(np.random.default_rng(seed), image_hw=hw)
    _equal(a, b)
    for uv, vis in ((a.uv0, a.vis0), (a.uv1, a.vis1)):
        np.testing.assert_array_equal(tdata.detector_labels(uv, vis, hw),
                                      jdata.detector_labels(uv, vis, hw))


@pytest.mark.parametrize("seed", [0, 3])
def test_render_batch(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    a = jdata.render_batch(rj, 3, image_hw=(96, 128), n_corr=64)
    b = tdata.render_batch(rt, 3, image_hw=(96, 128), n_corr=64)
    _equal(a, b)
    assert rj.integers(1 << 30) == rt.integers(1 << 30)     # the same draws consumed


def test_sprite_ids_and_gt_assignment():
    rng = np.random.default_rng(2)
    for _ in range(5):
        uv = rng.uniform(0, 100, (80, 2)).astype(np.float32)
        vis = rng.random(80) > 0.2
        kpts = np.concatenate([uv[:40] + rng.normal(0, 1.5, (40, 2)),
                               rng.uniform(0, 100, (24, 2))]).astype(np.float32)
        valid = rng.random(64) > 0.1
        sid0 = tlgt.sprite_ids(kpts, valid, uv, vis)
        np.testing.assert_array_equal(sid0, jlgt.sprite_ids(kpts, valid, uv, vis))
        sid1 = rng.permutation(sid0)
        sid1[:3] = sid1[3]                      # a sprite detected several times
        m0 = tlgt.gt_assignment(sid0, sid1)
        np.testing.assert_array_equal(m0, jlgt.gt_assignment(sid0, sid1))
        assert (m0 >= 0).sum() > 10
