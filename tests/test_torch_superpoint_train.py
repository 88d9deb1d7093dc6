"""The port's SuperPoint trainer (rover_slam_tpu_torch/training/
superpoint_train.py) against the JAX package's, on the same numpy inputs:
desc_info_nce to 1e-5; one step's loss (rtol 1e-4), ce, nce and every
gradient (each tensor within 1e-4 of its own max-abs) at 48x64, batch 2, in
f32 from the JAX init's parameters; the same step in bf16 (loss rtol 2e-2,
each gradient's cosine >= 0.99); the optimizer (Adam + cosine schedule)
against optax on one stored gradient sequence, parameters within 1e-6
after 5 updates; the Flax-style init against the JAX init's statistics;
and a whole tiny train() on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch's threads under xdist)
from rover_slam_tpu.models import superpoint as jsp
from rover_slam_tpu.training import data as jdata, superpoint_train as jspt
from rover_slam_tpu_torch.models import superpoint as tsp, weights as W
from rover_slam_tpu_torch.training import adam_cosine, superpoint_train as tspt
from rover_slam_tpu_torch.training.checkpoints import flatten

HW = (48, 64)


def grad_capture():
    """An optax transformation that leaves the parameters as they are and
    keeps the step's gradients in its state (the JAX step returns no
    gradients)."""
    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def jax_step(make_train_step, model, params, batch):
    """(loss, aux0, aux1, flat gradients) of one JAX training step."""
    tx = grad_capture()
    step = make_train_step(model, tx)
    _, st, loss, a, b = step(params, tx.init(params), {k: jnp.asarray(v) for k, v in
                                                       batch.items()})
    return float(loss), float(a), float(b), flatten(jax.tree.map(np.asarray, st["g"]))


def assert_grads_match(got: dict, want: dict, dtype):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        assert g.shape == w.shape, k
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
        else:
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos >= 0.99, (k, cos)


def test_desc_info_nce():
    rng = np.random.default_rng(0)
    B, Hc, Wc, C = 3, 6, 8, 40
    g0 = rng.normal(size=(B, Hc, Wc, 256)).astype(np.float32)
    g1 = (g0 + rng.normal(0, 0.5, g0.shape)).astype(np.float32)
    g0 /= np.linalg.norm(g0, axis=-1, keepdims=True)
    g1 /= np.linalg.norm(g1, axis=-1, keepdims=True)
    uv0 = rng.uniform(0, 63, (B, C, 2)).astype(np.float32)
    uv1 = (uv0 + rng.normal(0, 2, uv0.shape)).astype(np.float32)
    cv = rng.random((B, C)) > 0.3
    cv[2] = False                                   # a pair with no correspondence
    want = np.asarray(jax.vmap(jspt.desc_info_nce)(*(jnp.asarray(x) for x in
                                                     (g0, g1, uv0, uv1, cv))))
    got = tspt.desc_info_nce(*(torch.from_numpy(x) for x in (g0, g1, uv0, uv1, cv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    batch = jdata.render_batch(np.random.default_rng(0), 2, image_hw=HW, n_corr=64)
    model_j = jsp.SuperPoint(dtype=getattr(jnp, dtype))
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 1), jnp.float32))["params"]
    loss_j, ce_j, nce_j, grads_j = jax_step(jspt.make_train_step, model_j, params, batch)

    model_t = tsp.SuperPoint(dtype=getattr(torch, dtype))
    model_t.load_state_dict(W.superpoint_state_dict(jax.tree.map(np.asarray, params)))
    loss_t, ce_t, nce_t = tspt.loss_fn(model_t, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    loss_t.backward()
    grads_t = flatten(W.superpoint_params({n: p.grad for n, p in model_t.named_parameters()}))
    rtol = 1e-4 if dtype == "float32" else 2e-2
    for got, want in ((loss_t, loss_j), (ce_t, ce_j), (nce_t, nce_j)):
        np.testing.assert_allclose(got.item(), want, rtol=rtol)
    assert_grads_match(grads_t, grads_j, dtype)


def test_adam_cosine_matches_optax():
    """Five updates from one stored gradient sequence (a schedule of 4 steps,
    so the last update is past the decay's end)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(7, 5)).astype(np.float32),
          "b": rng.normal(size=(11,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-6, 0, v.shape))
              .astype(np.float32) for k, v in p0.items()} for _ in range(5)]
    lr, steps = 1e-3, 4
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = adam_cosine(list(pt.values()), lr, steps)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=0, atol=1e-6)
        assert np.abs(pt[k].detach().numpy() - p0[k]).max() > 1e-3      # the updates moved it


def test_flax_style_init():
    """Every kernel's std within 5 % of the JAX init's, biases 0. A kernel
    under 4096 values (conv1a's 576) is compared over 16 inits of each side,
    so that 5 % is well outside the spread of the estimate."""
    params = jsp.SuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 1)))["params"]
    want = flatten(jax.tree.map(np.asarray, params))
    got = flatten(W.superpoint_params(
        W.flax_init_(tsp.SuperPoint(), torch.Generator().manual_seed(0)).state_dict()))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith("bias"):
            assert not got[k].any(), k
            continue
        g, w = got[k], want[k]
        if g.size < 4096:
            g = np.stack([W.flax_init_(tsp.SuperPoint(), torch.Generator().manual_seed(s))
                          .conv1a.weight.detach().numpy() for s in range(16)])
            w = np.stack([np.asarray(jax.nn.initializers.lecun_normal()(
                jax.random.PRNGKey(s), want[k].shape)) for s in range(16)])
        assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())
        bound = 2 * np.sqrt(1.0 / np.prod(want[k].shape[:-1])) / 0.87962566103423978
        assert np.abs(got[k]).max() <= bound * (1 + 1e-6), k


def test_train_runs_on_the_cpu(capsys):
    r = tspt.train(steps=3, batch=2, pool=3, image_hw=HW, log_every=1, device="cpu")
    assert r.losses.shape == (3, 3) and np.isfinite(r.losses).all()
    np.testing.assert_allclose(r.losses[:, 0], r.losses[:, 1] + r.losses[:, 2], rtol=1e-6)
    assert set(r.params) == set(W.SUPERPOINT_LAYERS) and 0.0 <= r.heldout[0] <= 1.0
    assert "# heldout mutual-NN precision" in capsys.readouterr().out
