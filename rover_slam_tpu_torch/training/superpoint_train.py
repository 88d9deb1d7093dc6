"""Train SuperPoint on the synthetic photo world (detector cross-entropy +
descriptor InfoNCE), on the card by default.

Counterpart of rover_slam_tpu/training/superpoint_train.py, with the same
data (training/data.py, drawn in the same order from the seed), losses,
optimizer and schedule:

- detector: 65-way cell cross-entropy; each 8x8 cell's label is the
  within-cell pixel of a sprite centre, or the dustbin (DeTone et al. 2018,
  eq. 2-4).
- descriptor: symmetric InfoNCE over ground-truth correspondences; the
  coarse descriptor grid is bilinearly sampled at the matched sprite centres
  in both views; the same sprite is the positive, every other sampled point
  a negative.

The parameters are f32 and Flax-initialized (models.weights.flax_init_);
the convolutions compute in bf16.

Run:  python -m rover_slam_tpu_torch.training.superpoint_train \
          --steps 1500 --out superpoint_synth.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import superpoint as sp
from ..models import weights as W
from ..ops import nn_matcher
from . import TrainResult, adam_cosine, checkpoints
from . import data as D


def desc_info_nce(desc_grid0, desc_grid1, uv0, uv1, corr_valid, tau=0.1):
    """Symmetric InfoNCE over GT correspondences, one value per pair.

    desc_grid*: [B,Hc,Wc,256] L2-normalized coarse grids; uv*: [B,C,2]
    pixels; corr_valid: [B,C] bool. Returns [B]."""
    d0 = sp.sample_descriptors(desc_grid0, uv0)                  # [B,C,D]
    d1 = sp.sample_descriptors(desc_grid1, uv1)
    sim = torch.einsum("bcd,bed->bce", d0, d1) / tau             # [B,C,C]
    mask = corr_valid[:, :, None] & corr_valid[:, None, :]
    sim = torch.where(mask, sim, -1e9)
    B, C, _ = sim.shape
    labels = torch.arange(C, device=sim.device).repeat(B)
    ce0 = F.cross_entropy(sim.reshape(B * C, C), labels, reduction="none")
    ce1 = F.cross_entropy(sim.transpose(1, 2).reshape(B * C, C), labels,
                          reduction="none")
    w = corr_valid.float()
    return (torch.sum((ce0 + ce1).reshape(B, C) * 0.5 * w, dim=1)
            / torch.clamp(torch.sum(w, dim=1), min=1.0))


def loss_fn(model, batch, det_weight=1.0, desc_weight=1.0):
    """(loss, ce, nce) of one batch of tensors (render_batch's keys)."""
    _, desc0, logits0 = model(batch["img0"], return_logits=True)
    _, desc1, logits1 = model(batch["img1"], return_logits=True)

    def ce_of(logits, lab):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), lab.reshape(-1).long(),
                               reduction="none").mean()

    ce = (ce_of(logits0, batch["lab0"]) + ce_of(logits1, batch["lab1"])) * 0.5
    nce = desc_info_nce(desc0, desc1, batch["uv0"], batch["uv1"], batch["corr_valid"]).mean()
    return det_weight * ce + desc_weight * nce, ce, nce


def make_train_step(model, optimizer, scheduler, det_weight=1.0, desc_weight=1.0):
    """step(batch) -> (loss, ce, nce): one Adam update of `model` on a batch
    of tensors on the model's device. The step's gradients stay on the
    parameters until the next step."""
    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss, ce, nce = loss_fn(model, batch, det_weight, desc_weight)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.detach(), ce.detach(), nce.detach()

    return step


def _sprite_of(k, uv, vis, radius):
    """[N] index of the visible sprite within `radius` px of each keypoint,
    or -1."""
    d = np.linalg.norm(uv[None, :, :] - k[:, None, :], axis=-1)
    d[:, ~vis] = 1e9
    j = d.argmin(1)
    return np.where(d[np.arange(len(k)), j] < radius, j, -1)


def eval_matching(extractor, rng, n_pairs=8, image_hw=(240, 320)):
    """Mutual-NN match precision on held-out pairs (a match is correct when
    the two keypoints lie within 4 px of the same sprite's projections),
    through nn_matcher.mutual_nn_match (kernel B2 on the card). Returns
    (precision, matches a pair)."""
    correct = total = 0
    for _ in range(n_pairs):
        s = D.make_pair(rng, image_hw=image_hw)
        o0 = extractor(s.img0[None])
        o1 = extractor(s.img1[None])
        m, _ = nn_matcher.mutual_nn_match(o0["descriptors"][0], o0["valid"][0],
                                          o1["descriptors"][0], o1["valid"][0], ratio=0.95)
        m = m.cpu().numpy()
        s0 = _sprite_of(o0["keypoints"][0].cpu().numpy(), s.uv0, s.vis0, 4.0)
        s1 = _sprite_of(o1["keypoints"][0].cpu().numpy(), s.uv1, s.vis1, 4.0)
        mm = m >= 0
        total += mm.sum()
        correct += ((s0[mm] >= 0) & (s0[mm] == s1[np.clip(m[mm], 0, None)])).sum()
    return correct / max(total, 1), total / n_pairs


def train(steps=1500, batch=4, lr=1e-3, seed=0, image_hw=(240, 320), pool=400,
          out=None, log_every=50, device=None, on_step=None) -> TrainResult:
    """Train from a Flax-style init on `pool` rendered pairs; save the
    parameters to `out` (npz, the JAX package's layout) if given; evaluate
    on 8 held-out pairs. on_step(it, model), if given, runs after each step
    with that step's gradients on the parameters. device None means cuda."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = W.flax_init_(sp.SuperPoint(), torch.Generator().manual_seed(seed)).to(dev)
    optimizer, scheduler = adam_cosine(model.parameters(), lr, steps)
    step = make_train_step(model, optimizer, scheduler)

    print(f"# rendering {pool} training pairs ...", flush=True)
    t0 = time.time()
    samples = [D.render_batch(rng, 1, image_hw=image_hw) for _ in range(pool)]
    setup_s = time.time() - t0
    print(f"# pool in {setup_s:.0f}s", flush=True)

    def get_batch():
        picks = rng.choice(pool, batch, replace=False)
        return {k: torch.from_numpy(np.concatenate([samples[i][k] for i in picks])).to(dev)
                for k in samples[0]}

    losses = []
    t0 = time.time()
    for it in range(steps):
        losses.append(torch.stack(step(get_batch())))
        if on_step is not None:
            on_step(it, model)
        if it % log_every == 0 or it == steps - 1:
            loss, ce, nce = losses[-1].tolist()
            print(f"# step {it} loss {loss:.4f} det {ce:.4f} desc {nce:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    params = W.superpoint_params(model.state_dict())
    if out:
        checkpoints.save_params(out, params)
        print(f"# saved {out}")
    ext = sp.SuperPointExtractor(params=params, device=dev)
    prec, n = eval_matching(ext, np.random.default_rng(seed + 1), image_hw=image_hw)
    print(f"# heldout mutual-NN precision {prec:.3f} ({n:.0f} matches/pair)")
    return TrainResult(params, model, torch.stack(losses).cpu().numpy(), setup_s, (prec, n))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pool", type=int, default=400)
    ap.add_argument("--out", default=None, help="npz to write the trained weights to")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    train(steps=args.steps, batch=args.batch, lr=args.lr, pool=args.pool, out=args.out,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
