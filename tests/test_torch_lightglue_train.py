"""The port's LightGlue trainer (rover_slam_tpu_torch/training/
lightglue_train.py) against the JAX package's, and the gradient of kernel
B1's wrapper: one step's loss (rtol 1e-4), lp, ln and every gradient (each
tensor within 1e-4 of its own max-abs) at 2 layers and 64 keypoints with
some padded, in f32 from the JAX init's parameters, and in bf16 (loss rtol
2e-2, each gradient's cosine >= 0.99); the cross-attention key biases,
whose gradient is 0, at noise level on both sides; ops.flash_attention.KernelAttention
(its launch stood in for by the plain math, since the kernel runs only on
the card) gives plain autograd's output and gradients to the bit; a
gradient reaches every to_q / to_k / to_v weight through LightGlue, by the
CPU route and through KernelAttention; eval_matcher's precision and recall
equal the JAX package's on a 2-pair dataset; a whole tiny train() runs on
the CPU."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads under xdist)
from rover_slam_tpu.models import lightglue as jlg
from rover_slam_tpu.training import lightglue_train as jlgt
from rover_slam_tpu_torch.models import lightglue as tlg, superpoint as tsp, weights as W
from rover_slam_tpu_torch.ops import flash_attention as fa
from rover_slam_tpu_torch.training import checkpoints, lightglue_train as tlgt
from rover_slam_tpu_torch.training.checkpoints import flatten
from rover_slam_tpu_torch.utils import profiling

from test_torch_superpoint_train import assert_grads_match, jax_step

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rover_slam_tpu", "assets")
N, L = 64, 2


def lg_batch(rng, B=2, N=N):
    """B pairs of N keypoints: image 1 is a permuted, noisy copy of image 0;
    the GT keeps about 60 % of the pairs; the last keypoints are padding."""
    out = {k: [] for k in ("k0", "d0", "v0", "k1", "d1", "v1", "m0")}
    for b in range(B):
        k0 = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        d0 = rng.normal(size=(N, 256)).astype(np.float32)
        perm = rng.permutation(N)
        k1 = (k0[perm] + rng.normal(0, 0.01, (N, 2))).astype(np.float32)
        d1 = (d0[perm] + rng.normal(0, 0.3, (N, 256))).astype(np.float32)
        v0, v1 = np.ones(N, bool), np.ones(N, bool)
        v0[N - 6 - b:] = False
        v1[N - 9:] = False
        m0 = np.argsort(perm).astype(np.int64)
        m0[(rng.random(N) > 0.6) | ~v0 | ~v1[m0]] = -1
        for k, v in zip(out, (k0, d0 / np.linalg.norm(d0, axis=1, keepdims=True), v0, k1,
                              d1 / np.linalg.norm(d1, axis=1, keepdims=True), v1, m0)):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    batch = lg_batch(np.random.default_rng(0))
    # Column 0 is both a GT match and the clip target of later unmatched
    # keypoints: the case where the dustbin mask follows the last writer.
    b = int(np.nonzero((batch["m0"] == 0).any(1))[0][0])
    assert (batch["m0"][b, int(np.argmax(batch["m0"][b] == 0)):] < 0).any()
    model_j = jlg.LightGlue(num_layers=L, dtype=getattr(jnp, dtype))
    z = jnp.zeros((1, N, 2)), jnp.zeros((1, N, 256)), jnp.ones((1, N), bool)
    params = model_j.init(jax.random.PRNGKey(0), *z, *z)["params"]
    loss_j, lp_j, ln_j, grads_j = jax_step(jlgt.make_train_step, model_j, params, batch)

    model_t = tlg.LightGlue(num_layers=L, dtype=getattr(torch, dtype))
    model_t.load_state_dict(W.lightglue_state_dict(jax.tree.map(np.asarray, params)))
    loss_t, lp_t, ln_t = tlgt.loss_fn(model_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t.backward()
    grads_t = flatten(W.lightglue_params({n: p.grad for n, p in model_t.named_parameters()}))
    rtol = 1e-4 if dtype == "float32" else 2e-2
    for got, want in ((loss_t, loss_j), (lp_t, lp_j), (ln_t, ln_j)):
        np.testing.assert_allclose(got.item(), want, rtol=rtol)
    # Cross attention's key bias adds q . b to every logit of a row (no
    # rotary term there), which the softmax ignores: its gradient is 0, and
    # both sides hold only rounding noise, far under the key kernel's.
    noise = 1e-5 if dtype == "float32" else 2e-2
    for i in range(L):
        key = f"layer_{i}/cross_attn/to_k/"
        scale = np.abs(grads_j[key + "kernel"]).max()
        for grads in (grads_t, grads_j):
            assert np.abs(grads.pop(key + "bias")).max() < noise * scale, key
    assert_grads_match(grads_t, grads_j, dtype)


def _launch_stand_in(q, k, v, mask_kv):
    """The kernel's function on a q already divided by sqrt(Dh), in the
    plain version's arithmetic."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = torch.where(mask_kv[:, None, None, :], s.float(), fa.NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs", [(True, True, True), (False, True, False)])
def test_kernel_attention_gradient_is_plain_autograd(monkeypatch, dtype, needs):
    """Padded keys and one all-masked row, at path K's heads and width."""
    monkeypatch.setattr(fa, "_launch", _launch_stand_in)
    g = torch.Generator().manual_seed(0)
    B, Nq, Nk, H, Dh = 3, 40, 33, 4, 64
    q, k, v = (torch.randn(B, n, H, Dh, generator=g).to(dtype) for n in (Nq, Nk, Nk))
    mask = torch.rand(B, Nk, generator=g) > 0.25
    mask[2] = False
    up = torch.randn(B, Nq, H, Dh, generator=g).to(dtype)
    a = [x.clone().requires_grad_(n) for x, n in zip((q, k, v), needs)]
    b = [x.clone().requires_grad_(n) for x, n in zip((q, k, v), needs)]
    n0 = profiling.counter("backward_recomputes")
    out_f = fa.KernelAttention.apply(*a, mask)
    out_p = fa.masked_attention_plain(*b, mask)
    assert torch.equal(out_f, out_p) and out_f.grad_fn is not None
    out_f.backward(up)
    out_p.backward(up)
    assert profiling.counter("backward_recomputes") == n0 + 1
    for x, y, n in zip(a, b, needs):
        assert (x.grad is None) == (not n)
        if n:
            assert torch.equal(x.grad, y.grad) and x.grad.abs().sum() > 0


@pytest.mark.parametrize("route", ["cpu", "kernel_function"])
def test_gradient_reaches_every_projection(monkeypatch, route):
    """A loss through LightGlue (bf16 layer stack, f32 parameters) from a
    descriptor input that requires a gradient: every to_q / to_k / to_v
    weight, and the input, get a nonzero gradient."""
    if route == "kernel_function":
        monkeypatch.setattr(fa, "_launch", _launch_stand_in)
        monkeypatch.setattr(tlg, "masked_attention", fa.KernelAttention.apply)
    batch = {k: torch.from_numpy(v) for k, v in lg_batch(np.random.default_rng(1), B=1).items()}
    model = W.flax_init_(tlg.LightGlue(num_layers=L), torch.Generator().manual_seed(0))
    d0 = batch["d0"].clone().requires_grad_(True)
    n0 = profiling.counter("backward_recomputes")
    la, _, _ = model(batch["k0"], d0, batch["v0"], batch["k1"], batch["d1"], batch["v1"])
    la[:, :-1, :-1][batch["v0"][:, :, None] & batch["v1"][:, None, :]].sum().backward()
    names = [n for n, _ in model.named_parameters() if n.split(".")[-2] in ("to_q", "to_k", "to_v")]
    assert len(names) == L * 2 * 3 * 2
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        if n in names:
            assert p.grad.abs().sum() > 0, n
    assert d0.grad.abs().sum() > 0
    recomputes = profiling.counter("backward_recomputes") - n0
    assert recomputes == (4 * L if route == "kernel_function" else 0)


def test_eval_matcher_matches_jax():
    """Precision and recall on a 2-pair dataset the port's make_dataset
    extracts on the CPU (shipped SuperPoint weights), matched by both
    packages' LightGlue on the shipped weights in f32."""
    ext = tsp.SuperPointExtractor(params=checkpoints.load_params(
        os.path.join(ASSETS, "superpoint_synth.npz")), max_keypoints=128,
        dtype=torch.float32, device="cpu")
    ds = tlgt.make_dataset(ext, np.random.default_rng(0), 2, image_hw=(120, 160), n_kpts=128)
    assert sum((b["m0"] >= 0).sum() for b in ds) > 20
    lg_params = checkpoints.load_params(os.path.join(ASSETS, "lightglue_synth.npz"))
    model_t = tlg.LightGlue(dtype=torch.float32)
    model_t.load_state_dict(W.lightglue_state_dict(lg_params))
    got = tlgt.eval_matcher(tlgt._RawMatcher(model_t), ds)
    want = jlgt.eval_matcher(jlgt._RawMatcher(jlg.LightGlue(dtype=jnp.float32),
                                              jax.tree.map(jnp.asarray, lg_params)), ds)
    assert got == want and got[1] > 0.3, (got, want)


def test_train_runs_on_the_cpu(capsys):
    r = tlgt.train(steps=3, batch=2, n_pairs=3, num_layers=L, image_hw=(96, 128), n_kpts=64,
                   log_every=1, device="cpu")
    assert r.losses.shape == (3, 3) and np.isfinite(r.losses).all()
    np.testing.assert_allclose(r.losses[:, 0], r.losses[:, 1] + 0.5 * r.losses[:, 2],
                               rtol=1e-6)
    assert set(r.params) == {"input_proj", "posenc", "final_proj", "matchability",
                             "layer_0", "layer_1"}
    assert "# heldout precision" in capsys.readouterr().out
    assert math.isfinite(r.heldout[0]) and math.isfinite(r.heldout[1])


def test_serving_weights_give_the_training_forward():
    """LightGlueMatcher's cast-once bf16 weights (to_compute_dtype) and the
    trained module's f32 parameters cast per call give the same
    log-assignment to the bit: the LayerNorm affine stays f32 in both, as
    Flax keeps it (rounded to bf16 and back, the shipped scales lose their
    low bits)."""
    tree = checkpoints.load_params(os.path.join(ASSETS, "lightglue_synth.npz"))
    trained = tlg.LightGlue()
    trained.load_state_dict(W.lightglue_state_dict(tree))
    served = tlg.LightGlueMatcher(params=tree, device="cpu").model
    assert served.layers[0].self_ffn.ln.weight.dtype == torch.float32
    assert served.layers[0].self_attn.to_q.weight.dtype == torch.bfloat16
    b = {k: torch.from_numpy(v) for k, v in lg_batch(np.random.default_rng(3), B=1).items()}
    args = [b[k] for k in ("k0", "d0", "v0", "k1", "d1", "v1")]
    with torch.no_grad():
        assert torch.equal(served(*args)[0], trained(*args)[0])
