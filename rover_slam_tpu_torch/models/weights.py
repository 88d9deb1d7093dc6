"""Carry the JAX package's parameters into the port's modules.

Flax stores a conv kernel as [kh, kw, in, out] and a Dense kernel as
[in, out]; torch wants [out, in, kh, kw] and Linear [out, in]. LayerNorm's
`scale` is torch's `weight`. These are the inverses of the converters in
rover_slam_tpu/models/superpoint.py (`load_torch_weights`) and
rover_slam_tpu/models/lightglue.py (`load_torch_weights`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..training.checkpoints import load_params

SUPERPOINT_LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                     "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


def load_flat_npz(path: str) -> dict:
    """The shipped flat '/'-keyed f16 npz, read in place, as a nested dict of
    float32 numpy arrays."""
    return load_params(path)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def superpoint_state_dict(flax_params: dict) -> dict:
    sd = {}
    for name in SUPERPOINT_LAYERS:
        leaf = flax_params[name]
        leaf = leaf.get("conv", leaf)
        sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(leaf["bias"])
    return sd


def _dense(sd: dict, prefix: str, leaf: dict, bias: bool = True):
    sd[f"{prefix}.weight"] = _t(np.asarray(leaf["kernel"]).T)
    if bias:
        sd[f"{prefix}.bias"] = _t(leaf["bias"])


def lightglue_state_dict(flax_params: dict, num_layers: int | None = None) -> dict:
    """num_layers: convert only the first layers (as a shallower Flax model
    applied to the same tree would read them); None takes every layer."""
    sd = {}
    _dense(sd, "input_proj", flax_params["input_proj"])
    _dense(sd, "posenc.Wr", flax_params["posenc"]["Wr"], bias=False)
    _dense(sd, "final_proj", flax_params["final_proj"])
    _dense(sd, "matchability", flax_params["matchability"])
    i = 0
    while f"layer_{i}" in flax_params and (num_layers is None or i < num_layers):
        lp = flax_params[f"layer_{i}"]
        for blk in ("self_attn", "cross_attn"):
            for lin in ("to_q", "to_k", "to_v", "to_out"):
                _dense(sd, f"layers.{i}.{blk}.{lin}", lp[blk][lin])
        for blk in ("self_ffn", "cross_ffn"):
            _dense(sd, f"layers.{i}.{blk}.fc1", lp[blk]["fc1"])
            _dense(sd, f"layers.{i}.{blk}.fc2", lp[blk]["fc2"])
            sd[f"layers.{i}.{blk}.ln.weight"] = _t(lp[blk]["ln"]["scale"])
            sd[f"layers.{i}.{blk}.ln.bias"] = _t(lp[blk]["ln"]["bias"])
        i += 1
    return sd
