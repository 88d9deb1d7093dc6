"""The public-checkpoint converters of the port against the JAX package's
(models/superpoint.py and models/lightglue.py `load_torch_weights`), on
synthetic state dicts in the official layouts (no checkpoint is fetched):
the same parameter trees, and both packages' networks on the converted
weights give the same outputs at tests/test_torch_frontend.py's tolerances
(SuperPoint dense outputs atol 1e-4 in f32; LightGlue log-assignment atol
1e-3 and matchability atol 1e-4 in f32, >= 99 % equal matches). The
official-layout writers of the port (models.weights) round-trip the shipped
synth weights."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.models import lightglue as jlg, superpoint as jsp
from rover_slam_tpu_torch.models import lightglue as tlg, superpoint as tsp, weights as W

from test_torch_frontend import ASSETS, HW, _lg_inputs, image  # noqa: F401  (fixture)

D, L = 64, 2


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _superpoint_sd(rng):
    sd = {}
    shapes = dict(conv1a=(64, 1, 3), conv1b=(64, 64, 3), conv2a=(64, 64, 3), conv2b=(64, 64, 3),
                  conv3a=(128, 64, 3), conv3b=(128, 128, 3), conv4a=(128, 128, 3),
                  conv4b=(128, 128, 3), convPa=(256, 128, 3), convPb=(65, 256, 1),
                  convDa=(256, 128, 3), convDb=(256, 256, 1))
    for name, (o, i, k) in shapes.items():
        sd[f"{name}.weight"] = torch.tensor(
            rng.normal(0, np.sqrt(2.0 / (i * k * k)), (o, i, k, k)).astype(np.float32))
        sd[f"{name}.bias"] = torch.tensor(rng.normal(0, 0.01, o).astype(np.float32))
    return sd


def _lightglue_sd(rng):
    """tests/test_lightglue.py::test_torch_checkpoint_conversion's state dict."""
    def lin(o, i):
        return (torch.tensor(rng.normal(0, 0.02, (o, i)).astype(np.float32)),
                torch.tensor(rng.normal(0, 0.02, o).astype(np.float32)))

    sd = {}
    sd["input_proj.weight"], sd["input_proj.bias"] = lin(D, 256)
    sd["posenc.Wr.weight"] = torch.tensor(rng.normal(0, 1, (D // 4 // 2, 2)).astype(np.float32))
    for i in range(L):
        p = f"transformers.{i}"
        sd[f"{p}.self_attn.Wqkv.weight"], sd[f"{p}.self_attn.Wqkv.bias"] = lin(3 * D, D)
        sd[f"{p}.self_attn.out_proj.weight"], sd[f"{p}.self_attn.out_proj.bias"] = lin(D, D)
        sd[f"{p}.cross_attn.to_qk.weight"], sd[f"{p}.cross_attn.to_qk.bias"] = lin(D, D)
        sd[f"{p}.cross_attn.to_v.weight"], sd[f"{p}.cross_attn.to_v.bias"] = lin(D, D)
        sd[f"{p}.cross_attn.to_out.weight"], sd[f"{p}.cross_attn.to_out.bias"] = lin(D, D)
        for blk in ("self_attn", "cross_attn"):
            sd[f"{p}.{blk}.ffn.0.weight"], sd[f"{p}.{blk}.ffn.0.bias"] = lin(2 * D, 2 * D)
            sd[f"{p}.{blk}.ffn.1.weight"] = torch.ones(2 * D)
            sd[f"{p}.{blk}.ffn.1.bias"] = torch.zeros(2 * D)
            sd[f"{p}.{blk}.ffn.3.weight"], sd[f"{p}.{blk}.ffn.3.bias"] = lin(D, 2 * D)
    sd[f"log_assignment.{L - 1}.final_proj.weight"], \
        sd[f"log_assignment.{L - 1}.final_proj.bias"] = lin(D, D)
    sd[f"log_assignment.{L - 1}.matchability.weight"], \
        sd[f"log_assignment.{L - 1}.matchability.bias"] = lin(1, D)
    return sd


def test_superpoint_converter(tmp_path, image):   # noqa: F811
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(_superpoint_sd(np.random.default_rng(0)), path)
    pt, pj = tsp.load_torch_weights(path), jsp.load_torch_weights(path)
    ft, fj = _flat(pt), _flat(pj)
    assert ft.keys() == fj.keys()
    for k in ft:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    ext_j = jsp.SuperPointExtractor(params=pj, image_hw=HW, max_keypoints=256,
                                    dtype=jnp.float32)
    ext_t = tsp.SuperPointExtractor(params=pt, max_keypoints=256, dtype=torch.float32,
                                    device="cpu")
    prob_j, desc_j = ext_j.model.apply({"params": ext_j.params},
                                       jnp.asarray(image)[..., None])
    with torch.no_grad():
        prob_t, desc_t = ext_t.model(torch.from_numpy(image)[..., None])
    np.testing.assert_allclose(prob_t.numpy(), np.asarray(prob_j), atol=1e-4)
    np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), atol=1e-4)
    # The official layout is the port module's own state dict.
    assert set(_superpoint_sd(np.random.default_rng(0))) == set(ext_t.model.state_dict())


def test_lightglue_converter(tmp_path):
    path = str(tmp_path / "superpoint_lightglue.pth")
    torch.save(_lightglue_sd(np.random.default_rng(0)), path)
    pt = tlg.load_torch_weights(path, num_layers=L, dim=D)
    pj = jlg.load_torch_weights(path, num_layers=L, dim=D)
    ft, fj = _flat(pt), _flat(pj)
    assert ft.keys() == fj.keys()
    for k in ft:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    lm = jlg.LightGlueMatcher(params=pj, num_kpts=128, num_layers=L, dim=D, dtype=jnp.float32)
    lm_t = tlg.LightGlueMatcher(params=pt, num_layers=L, dim=D, dtype=torch.float32,
                                device="cpu")
    inp = _lg_inputs(np.random.default_rng(0), 128, n_valid=110)
    la_j, z0_j, _ = lm.model.apply({"params": lm.params}, *(jnp.asarray(x) for x in inp))
    with torch.no_grad():
        la_t, z0_t, _ = lm_t.model(*(torch.from_numpy(x) for x in inp))
    valid = np.zeros(la_t.shape, bool)
    valid[0, :111, :116] = True
    np.testing.assert_allclose(la_t.numpy()[valid], np.asarray(la_j)[valid], atol=1e-3)
    np.testing.assert_allclose(z0_t.numpy(), np.asarray(z0_j), atol=1e-4)
    m_j = np.asarray(lm(*(jnp.asarray(x) for x in inp))["matches0"])
    m_t = lm_t(*(torch.from_numpy(x) for x in inp))["matches0"].numpy()
    assert (m_t == m_j).mean() >= 0.99


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_official_writers_round_trip(tmp_path, net):
    """The shipped synth weights written in the official layout read back
    through both packages' converters to the same trees; LightGlue's cross
    attention shares one projection there, so its to_k reads back as to_q."""
    tree = W.load_flat_npz(os.path.join(ASSETS, f"{net}_synth.npz"))
    path = str(tmp_path / f"{net}.pth")
    if net == "superpoint":
        torch.save(W.superpoint_state_dict(tree), path)
        back_t, back_j = tsp.load_torch_weights(path), jsp.load_torch_weights(path)
    else:
        torch.save(W.lightglue_official_state_dict(tree), path)
        back_t, back_j = tlg.load_torch_weights(path), jlg.load_torch_weights(path)
        for i in range(9):
            ca = tree[f"layer_{i}"]["cross_attn"]
            ca["to_k"] = ca["to_q"]
    want, ft, fj = _flat(tree), _flat(back_t), _flat(jax.tree.map(np.asarray, back_j))
    assert want.keys() == ft.keys() == fj.keys()
    for k in want:
        np.testing.assert_array_equal(ft[k], want[k], err_msg=k)
        np.testing.assert_array_equal(fj[k], want[k], err_msg=k)
