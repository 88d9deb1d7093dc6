"""Place recognition: a device-resident bag of words over keypoint
descriptors.

Counterpart of rover_slam_tpu/map/keyframe_database.py. Words are a fixed
random codebook (word = argmax of the descriptor's products with the [D, W]
unit columns), a keyframe is its normalized word histogram, and querying the
database is one L1 similarity against every row of the dense [K, W] table.

The JAX package draws the codebook at run time from jax.random; the port
loads the same arrays from `assets/bow_codebooks.npz`, which
`make_bow_codebooks.py` writes with the JAX package (the parity tests check
it bit for bit). The word product runs in f32 with TF32 off, what the JAX
package computes on the CPU; near-ties may still pick another word on
another runtime (ROADMAP.md §C).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops import scatterless

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "bow_codebooks.npz")


class BowVocab(NamedTuple):
    codebook: torch.Tensor   # [D, W] random unit directions


def make_vocab(desc_dim: int, n_words: int = 2048, seed: int = 0, device=None) -> BowVocab:
    """The JAX package's make_vocab(desc_dim, n_words, seed), from the
    shipped codebooks."""
    name = f"d{desc_dim}_w{n_words}_s{seed}"
    with np.load(ASSET) as z:
        if name not in z.files:
            raise KeyError(
                f"no shipped codebook for desc_dim={desc_dim}, n_words={n_words}, "
                f"seed={seed} in {ASSET} (has {sorted(z.files)}); generate it with the "
                f"JAX package: JAX_PLATFORMS=cpu python3 make_bow_codebooks.py "
                f"--add {desc_dim}:{seed}")
        C = z[name]
    return BowVocab(codebook=torch.tensor(C, device=device))


def bow_transform(vocab: BowVocab, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[..., N, D] descriptors -> normalized tf vectors [..., W]."""
    W = vocab.codebook.shape[1]
    words = torch.argmax(desc.float() @ vocab.codebook, dim=-1)
    words = torch.where(valid, words, W)
    lead = words.shape[:-1]
    flat = words.reshape(-1, words.shape[-1])
    rows = torch.arange(flat.shape[0], device=desc.device)[:, None] * (W + 1)
    counts = scatterless.seg_count((flat + rows).reshape(-1), flat.shape[0] * (W + 1))
    tf = counts.reshape(lead + (W + 1,))[..., :W].float()
    return tf / torch.clamp(torch.sum(tf, dim=-1, keepdim=True), min=1e-9)


def bow_similarity(tf_query: torch.Tensor, tf_db: torch.Tensor) -> torch.Tensor:
    """L1 similarity 1 - 0.5 |q - d|_1 (DBoW3's default): [W], [K, W] -> [K]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(tf_query[None, :] - tf_db), dim=-1)


class KeyFrameDB(NamedTuple):
    vocab: BowVocab
    tf: torch.Tensor         # [K, W] per-keyframe tf vectors
    active: torch.Tensor     # [K]


def empty_db(desc_dim: int, K: int, n_words: int = 2048, seed: int = 0,
             device=None) -> KeyFrameDB:
    return KeyFrameDB(vocab=make_vocab(desc_dim, n_words, seed, device=device),
                      tf=torch.zeros((K, n_words), device=device),
                      active=torch.zeros((K,), dtype=torch.bool, device=device))


def db_set(db: KeyFrameDB, kf_id, tf) -> KeyFrameDB:
    """The database with keyframe kf_id's row set to tf and marked active."""
    row = torch.as_tensor(kf_id, device=db.tf.device).reshape(1).long()
    return db._replace(tf=db.tf.index_copy(0, row, tf[None]),
                       active=db.active.index_fill(0, row, True))


def db_add(db: KeyFrameDB, kf_id, desc, valid) -> KeyFrameDB:
    return db_set(db, kf_id, bow_transform(db.vocab, desc, valid))


def db_build_from_state(db: KeyFrameDB, kf_desc, kf_kpt_valid, kf_active) -> KeyFrameDB:
    """The whole database from a (loaded) map state in one pass."""
    tf = bow_transform(db.vocab, kf_desc.float(), kf_kpt_valid)
    return db._replace(tf=torch.where(kf_active[:, None], tf, 0.0), active=kf_active.clone())


def db_permute(db: KeyFrameDB, old_of_new, new_live) -> KeyFrameDB:
    """Follow a map-slot compaction: row k moves with its keyframe's slot.
    old_of_new [K] gather indices, new_live [K]."""
    g = old_of_new.long()
    return db._replace(tf=torch.where(new_live[:, None], db.tf[g], 0.0),
                       active=new_live & db.active[g])


def detect_candidates(db: KeyFrameDB, query_tf, query_kf, connected_mask, n_best: int = 4):
    """Loop/merge candidates by individually gated similarity: keyframes not
    connected to the query, at least 0.8 of the best similarity, ranked.
    Returns (ids [n_best], scores [n_best]), ids -1 past the hits."""
    sims = bow_similarity(query_tf, db.tf)
    sims = torch.where(db.active & ~connected_mask, sims, -1.0)
    q = torch.as_tensor(query_kf, device=sims.device).reshape(1).long()
    sims = sims.index_fill(0, q, -1.0)
    best = torch.max(sims)
    gated = torch.where(sims >= 0.8 * torch.clamp(best, min=1e-6), sims, -1.0)
    scores, ids = scatterless.top_k(gated, n_best)
    return torch.where(scores > 0, ids, -1).to(torch.int32), scores
