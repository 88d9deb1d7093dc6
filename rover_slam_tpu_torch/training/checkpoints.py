"""Read the flat '/'-keyed float16 npz checkpoints the JAX package ships.

Counterpart of rover_slam_tpu/training/checkpoints.py (`load_params`): the
file is read in place and unflattened into a nested dict of float32 numpy
arrays (the JAX package's parameter-tree layout).
"""
from __future__ import annotations

import numpy as np


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
