"""The shipped front-end weights as plain arrays.

The npz files are flat, '/'-keyed float16 arrays in Flax layouts (a conv
kernel [kh, kw, in, out], a Dense kernel [in, out]). load_npz reads one into
a nested dict of float32 numpy arrays: the tree both the port's loaders and
the references below take, so both sides get the same arrays.
"""
from __future__ import annotations

import numpy as np


def load_npz(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(z[key], np.float32)
    return tree
