"""Flat '/'-keyed npz checkpoints, the format the JAX package ships.

Counterpart of rover_slam_tpu/training/checkpoints.py: `load_params` reads a
file in place and unflattens it into a nested dict of float32 numpy arrays
(the JAX package's parameter-tree layout); `save_params` writes such a tree
(models.weights.superpoint_params / lightglue_params make one from a port
module) as float16 by default, the layout the JAX package's `load_params`
reads.
"""
from __future__ import annotations

import numpy as np


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v, np.float32)
    return tree


def load_params(path: str) -> dict:
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def save_params(path: str, params: dict, dtype=np.float16):
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in flatten(params).items()})
