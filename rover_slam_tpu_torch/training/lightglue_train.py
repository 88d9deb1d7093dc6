"""Train LightGlue on SuperPoint features from the synthetic photo world, on
the card by default.

Counterpart of rover_slam_tpu/training/lightglue_train.py: the same
architecture (models/lightglue.py) on pairs whose ground-truth assignment is
exact: a detected keypoint inherits the sprite id of the nearest
ground-truth sprite projection (<= 3 px), and two keypoints correspond iff
they inherit the same sprite.

Loss: negative log-likelihood of the ground-truth assignment under the
double-softmax log-assignment matrix: matched pairs at la[i, j], unmatched
valid keypoints at their dustbin entries (Lindenberger et al. 2023, eq. 6).

The parameters are f32 and Flax-initialized; the layer stack computes in
bf16, and every attention call's forward runs on kernel B1 with its
gradient taken by recompute (ops.flash_attention.KernelAttention).

Run:  python -m rover_slam_tpu_torch.training.lightglue_train \
          --sp rover_slam_tpu/assets/superpoint_synth.npz \
          --out lightglue_synth.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import lightglue as lg
from ..models import superpoint as sp
from ..models import weights as W
from . import TrainResult, adam_cosine, checkpoints
from . import data as D

SHIPPED_SP = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "rover_slam_tpu", "assets", "superpoint_synth.npz")


def sprite_ids(kpts, valid, uv, vis, radius=3.0):
    """[N] sprite id per detected keypoint (-1 = no sprite within radius)."""
    d = np.linalg.norm(uv[None, :, :] - kpts[:, None, :], axis=-1)
    d[:, ~vis] = 1e9
    j = d.argmin(1)
    ok = (d[np.arange(len(kpts)), j] < radius) & valid
    return np.where(ok, j, -1)


def gt_assignment(sid0, sid1):
    """GT matches: m0 [N] index into image1 or -1; matched iff same sprite.
    A sprite detected twice in one image keeps only the first keypoint."""
    n1_of = {}
    for j, s in enumerate(sid1):
        if s >= 0 and s not in n1_of:
            n1_of[s] = j
    seen = set()
    m0 = np.full(len(sid0), -1, np.int64)
    for i, s in enumerate(sid0):
        if s >= 0 and s in n1_of and s not in seen:
            m0[i] = n1_of[s]
            seen.add(s)
    return m0


def make_dataset(extractor, rng, n_pairs, image_hw=(240, 320), n_kpts=512):
    """SuperPoint features (extractor: models.superpoint.SuperPointExtractor)
    on rendered pairs, with the GT assignment; a list of dicts of numpy
    arrays (keypoints normalized to [-1, 1])."""
    out = []
    for _ in range(n_pairs):
        s = D.make_pair(rng, image_hw=image_hw)
        o0 = extractor(s.img0[None])
        o1 = extractor(s.img1[None])
        k0, k1 = o0["keypoints"][0, :n_kpts].cpu(), o1["keypoints"][0, :n_kpts].cpu()
        v0 = o0["valid"][0, :n_kpts].cpu().numpy()
        v1 = o1["valid"][0, :n_kpts].cpu().numpy()
        sid0 = sprite_ids(k0.numpy(), v0, s.uv0, s.vis0)
        sid1 = sprite_ids(k1.numpy(), v1, s.uv1, s.vis1)
        # Normalized on the host, in true division as the JAX package does.
        out.append({"k0": lg.normalize_keypoints(k0, image_hw).numpy(),
                    "d0": o0["descriptors"][0, :n_kpts].cpu().numpy(), "v0": v0,
                    "k1": lg.normalize_keypoints(k1, image_hw).numpy(),
                    "d1": o1["descriptors"][0, :n_kpts].cpu().numpy(), "v1": v1,
                    "m0": gt_assignment(sid0, sid1)})
    return out


def loss_fn(model, b):
    """(loss, lp, ln) of one batch of tensors (make_dataset's keys,
    stacked)."""
    la, _, _ = model(b["k0"], b["d0"], b["v0"], b["k1"], b["d1"], b["v1"])
    B, N0p, N1p = la.shape
    N0, N1 = N0p - 1, N1p - 1
    m0 = b["m0"]                                   # [B,N0]
    matched = m0 >= 0
    midx = torch.clamp(m0, 0, N1 - 1)
    nll_pos = -torch.gather(la[:, :N0, :N1], 2, midx[:, :, None])[..., 0]
    # Dustbin targets for unmatched-but-valid keypoints on both sides. hit1
    # is the JAX package's zeros.at[midx].set(matched): where several
    # keypoints write one column (every unmatched one writes column 0), the
    # last keypoint's value stands, as XLA's CPU scatter leaves it.
    order = torch.arange(N0, device=la.device).expand(B, N0)
    last = torch.full((B, N1), -1, dtype=torch.long, device=la.device).scatter_reduce(
        1, midx, order, reduce="amax")
    hit1 = (last >= 0) & torch.gather(matched, 1, torch.clamp(last, min=0))
    un0 = b["v0"] & ~matched
    un1 = b["v1"] & ~hit1
    nll_un0 = -la[:, :N0, N1]
    nll_un1 = -la[:, N0, :N1]
    wp, w0, w1 = matched.float(), un0.float(), un1.float()
    # Positives weighted as heavily as both dustbin terms together (the
    # official loss averages positives and negatives separately).
    lp = torch.sum(nll_pos * wp) / torch.clamp(torch.sum(wp), min=1.0)
    ln = ((torch.sum(nll_un0 * w0) + torch.sum(nll_un1 * w1))
          / torch.clamp(torch.sum(w0) + torch.sum(w1), min=1.0))
    return lp + 0.5 * ln, lp, ln


def make_train_step(model, optimizer, scheduler):
    """step(batch) -> (loss, lp, ln): one Adam update of `model`. The step's
    gradients stay on the parameters until the next step."""
    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss, lp, ln = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.detach(), lp.detach(), ln.detach()

    return step


def eval_matcher(matcher, dataset):
    """Precision/recall of mutual-argmax matches vs GT on a dataset slice."""
    tp = fp = fn = 0
    for b in dataset:
        m = matcher(*(torch.from_numpy(b[k][None]) for k in ("k0", "d0", "v0", "k1", "d1",
                                                             "v1")))["matches0"]
        m = m[0].cpu().numpy()
        gt = b["m0"]
        pred = m >= 0
        tp += ((m == gt) & pred & (gt >= 0)).sum()
        fp += (pred & (m != gt)).sum()
        fn += ((gt >= 0) & ~pred).sum()
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


class _RawMatcher:
    """LightGlueMatcher-compatible view of a model being trained, for eval
    (keypoints already normalized in the dataset)."""

    def __init__(self, model, threshold=0.1):
        self.model, self.threshold = model, threshold
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, k0, d0, v0, k1, d1, v1):
        args = [x.to(self.device) for x in (k0, d0, v0, k1, d1, v1)]
        la = self.model(*args)[0]
        return lg.extract_matches(la, args[2], args[5], self.threshold)


def train(sp_ckpt=SHIPPED_SP, steps=1200, batch=4, lr=2e-4, seed=0, n_pairs=300,
          num_layers=9, image_hw=(240, 320), n_kpts=512, out=None, log_every=50,
          device=None, on_step=None) -> TrainResult:
    """Extract a dataset of `n_pairs` pairs with the SuperPoint weights at
    `sp_ckpt`, train from a Flax-style init, save to `out` (npz) if given,
    evaluate on 8 held-out pairs (heldout = (precision, recall)).
    on_step(it, model), if given, runs after each step with that step's
    gradients on the parameters. device None means cuda."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    extractor = sp.SuperPointExtractor(params=checkpoints.load_params(sp_ckpt),
                                       max_keypoints=n_kpts, device=dev)
    print(f"# extracting features for {n_pairs} pairs ...", flush=True)
    t0 = time.time()
    dataset = make_dataset(extractor, rng, n_pairs, image_hw=image_hw, n_kpts=n_kpts)
    setup_s = time.time() - t0
    n_gt = np.mean([(b["m0"] >= 0).sum() for b in dataset])
    print(f"# dataset in {setup_s:.0f}s; avg GT matches/pair {n_gt:.0f}", flush=True)

    model = W.flax_init_(lg.LightGlue(num_layers=num_layers),
                         torch.Generator().manual_seed(seed)).to(dev)
    optimizer, scheduler = adam_cosine(model.parameters(), lr, steps)
    step = make_train_step(model, optimizer, scheduler)

    def get_batch():
        picks = rng.choice(len(dataset), batch, replace=False)
        return {k: torch.from_numpy(np.stack([dataset[i][k] for i in picks])).to(dev)
                for k in dataset[0]}

    losses = []
    t0 = time.time()
    for it in range(steps):
        losses.append(torch.stack(step(get_batch())))
        if on_step is not None:
            on_step(it, model)
        if it % log_every == 0 or it == steps - 1:
            loss, lp, ln = losses[-1].tolist()
            print(f"# step {it} loss {loss:.4f} pos {lp:.4f} dust {ln:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    params = W.lightglue_params(model.state_dict())
    if out:
        checkpoints.save_params(out, params)
        print(f"# saved {out}")
    heldout = make_dataset(extractor, np.random.default_rng(seed + 1), 8,
                           image_hw=image_hw, n_kpts=n_kpts)
    prec, rec = eval_matcher(_RawMatcher(model), heldout)
    print(f"# heldout precision {prec:.3f} recall {rec:.3f}")
    return TrainResult(params, model, torch.stack(losses).cpu().numpy(), setup_s, (prec, rec))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", default=SHIPPED_SP)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--pairs", type=int, default=300)
    ap.add_argument("--layers", type=int, default=9)
    ap.add_argument("--out", default=None, help="npz to write the trained weights to")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    train(args.sp, steps=args.steps, batch=args.batch, lr=args.lr, n_pairs=args.pairs,
          num_layers=args.layers, out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
