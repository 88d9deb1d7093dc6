"""SuperPoint and LightGlue of the port against the JAX package, with the
same parameters on both sides (Flax-initialized, and the shipped npz)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.models import lightglue as jlg, superpoint as jsp
from rover_slam_tpu.training import checkpoints as jckpt
from rover_slam_tpu.utils import synthetic as jsyn
from rover_slam_tpu_torch.models import lightglue as tlg, superpoint as tsp
from rover_slam_tpu_torch.models import weights

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rover_slam_tpu", "assets")
HW = (120, 160)


@pytest.fixture(scope="module")
def image():
    world = jsyn.make_photo_world(n_sprites=300, patch=11, seed=3, image_hw=HW)
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    return (jsyn.render_photo_frame(world, R, t).astype(np.float32) / 255.0)[None]


@pytest.fixture(scope="module")
def sp_pair():
    ext = jsp.SuperPointExtractor(rng=jax.random.PRNGKey(0), image_hw=HW,
                                  max_keypoints=256, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, ext.params)
    ext_t = tsp.SuperPointExtractor(params=params, max_keypoints=256,
                                    dtype=torch.float32, device="cpu")
    return ext, ext_t


def test_superpoint_dense_outputs(sp_pair, image):
    ext, ext_t = sp_pair
    prob_j, desc_j = ext.model.apply({"params": ext.params}, jnp.asarray(image)[..., None])
    with torch.no_grad():
        prob_t, desc_t = ext_t.model(torch.from_numpy(image)[..., None])
    np.testing.assert_allclose(prob_t.numpy(), np.asarray(prob_j), atol=1e-4)
    np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), atol=1e-4)


def test_superpoint_keypoints_as_sets(sp_pair, image):
    ext, ext_t = sp_pair
    out_j = ext(jnp.asarray(image))
    out_t = ext_t(image)
    for key in ("keypoints", "descriptors", "valid", "scores"):
        assert tuple(out_t[key].shape) == tuple(out_j[key].shape), key
    kj = np.asarray(out_j["keypoints"][0])[np.asarray(out_j["valid"][0])]
    kt = out_t["keypoints"][0].numpy()[out_t["valid"][0].numpy()]
    assert len(kj) > 20
    sj = {tuple(p) for p in kj.astype(int)}
    st = {tuple(p) for p in kt.astype(int)}
    assert len(sj & st) >= 0.99 * max(len(sj), len(st))
    # Descriptors at the common keypoints agree.
    dj = {tuple(p): d for p, d in zip(kj.astype(int), np.asarray(out_j["descriptors"][0])[
        np.asarray(out_j["valid"][0])])}
    dt = out_t["descriptors"][0].numpy()[out_t["valid"][0].numpy()]
    err = max(np.abs(dj[tuple(p)] - d).max() for p, d in zip(kt.astype(int), dt)
              if tuple(p) in dj)
    assert err < 1e-4, err


def test_sample_descriptors_four_corner_gather():
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(2, 15, 20, 32)).astype(np.float32)
    kpts = np.stack([rng.uniform(0, 159, (2, 50)), rng.uniform(0, 119, (2, 50))],
                    -1).astype(np.float32)
    np.testing.assert_allclose(
        tsp.sample_descriptors(torch.from_numpy(desc), torch.from_numpy(kpts)).numpy(),
        np.asarray(jsp.sample_descriptors(jnp.asarray(desc), jnp.asarray(kpts))),
        atol=1e-5)


def _lg_inputs(rng, N, D=256, n_valid=None):
    k0 = rng.uniform(-1, 1, (1, N, 2)).astype(np.float32)
    d0 = rng.normal(size=(1, N, D)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    perm = rng.permutation(N)
    k1 = (k0[:, perm] + rng.normal(0, 0.01, (1, N, 2))).astype(np.float32)
    d1 = d0[:, perm] + rng.normal(0, 0.1, (1, N, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0 = np.ones((1, N), bool)
    m1 = np.ones((1, N), bool)
    if n_valid is not None:
        m0[:, n_valid:] = False
        m1[:, n_valid + 5:] = False
    return k0, d0, m0, k1, d1, m1


@pytest.fixture(scope="module")
def lg_f32_pair():
    lm = jlg.LightGlueMatcher(rng=jax.random.PRNGKey(1), num_layers=2, num_kpts=128,
                              dtype=jnp.float32)
    params = jax.tree.map(np.asarray, lm.params)
    lm_t = tlg.LightGlueMatcher(params=params, num_layers=2, dtype=torch.float32,
                                device="cpu")
    return lm, lm_t


def test_lightglue_f32_log_assignment_and_matches(lg_f32_pair):
    lm, lm_t = lg_f32_pair
    inp = _lg_inputs(np.random.default_rng(0), 128, n_valid=110)
    la_j, z0_j, z1_j = lm.model.apply({"params": lm.params}, *(jnp.asarray(x) for x in inp))
    with torch.no_grad():
        la_t, z0_t, z1_t = lm_t.model(*(torch.from_numpy(x) for x in inp))
    valid = np.zeros(la_t.shape, bool)
    valid[0, :111, :116] = True     # masked rows/cols hold -1e9-scale logits
    np.testing.assert_allclose(la_t.numpy()[valid], np.asarray(la_j)[valid], atol=1e-3)
    np.testing.assert_allclose(z0_t.numpy(), np.asarray(z0_j), atol=1e-4)
    m_j = np.asarray(lm(*(jnp.asarray(x) for x in inp))["matches0"])
    m_t = lm_t(*(torch.from_numpy(x) for x in inp))["matches0"].numpy()
    assert m_t.dtype == np.int32
    assert (m_t == m_j).mean() >= 0.99


def test_lightglue_frame_matcher_pair_and_batch(lg_f32_pair):
    lm, lm_t = lg_f32_pair
    rng = np.random.default_rng(1)
    k0, d0, m0, k1, d1, m1 = _lg_inputs(rng, 128)
    px = lambda k: ((k + 1.0) * 80.0).astype(np.float32)   # back to pixels of a 160-wide image
    fm_j = jlg.LightGlueFrameMatcher(lm, HW)
    fm_t = tlg.LightGlueFrameMatcher(lm_t, HW)
    args = (px(k0[0]), d0[0], m0[0], px(k1[0]), d1[0], m1[0])
    m_j = np.asarray(fm_j(*(jnp.asarray(x) for x in args)))
    m_t = fm_t(*(torch.from_numpy(x) for x in args)).numpy()
    assert m_t.shape == (128,) and (m_t == m_j).mean() >= 0.99
    batch = [np.stack([a, a]) for a in args]
    mb_j = np.asarray(fm_j.match_batch(*(jnp.asarray(x) for x in batch)))
    mb_t = fm_t.match_batch(*(torch.from_numpy(x) for x in batch)).numpy()
    assert mb_t.shape == (2, 128) and (mb_t == mb_j).mean() >= 0.99
    assert (mb_t[0] == m_t).all()


def test_lightglue_shipped_weights_bf16():
    """One pair through the full 9-layer matcher with the shipped npz, in
    bf16 on both sides: the two runtimes round bf16 at other places, so >= 95%
    identical matches."""
    params = weights.load_flat_npz(os.path.join(ASSETS, "lightglue_synth.npz"))
    lm = jlg.LightGlueMatcher(params=jckpt.load_params(os.path.join(ASSETS,
                                                                    "lightglue_synth.npz")),
                              num_layers=9, num_kpts=192)
    lm_t = tlg.LightGlueMatcher(params=params, num_layers=9, device="cpu")
    inp = _lg_inputs(np.random.default_rng(2), 192, n_valid=180)
    m_j = np.asarray(lm(*(jnp.asarray(x) for x in inp))["matches0"])
    m_t = lm_t(*(torch.from_numpy(x) for x in inp))["matches0"].numpy()
    assert (m_j >= 0).sum() > 50
    assert (m_t == m_j).mean() >= 0.95


def test_weights_round_trip_shapes():
    sp = weights.load_flat_npz(os.path.join(ASSETS, "superpoint_synth.npz"))
    sd = weights.superpoint_state_dict(sp)
    assert tuple(sd["conv1a.weight"].shape) == (64, 1, 3, 3)
    assert tuple(sd["convDb.weight"].shape) == (256, 256, 1, 1)
    np.testing.assert_array_equal(sd["convPb.weight"][:, :, 0, 0].numpy(),
                                  sp["convPb"]["kernel"][0, 0].T)
    assert sp["conv1a"]["conv"]["kernel"].dtype == np.float32
