"""Carry the JAX package's parameters into the port's modules.

Flax stores a conv kernel as [kh, kw, in, out] and a Dense kernel as
[in, out]; torch wants [out, in, kh, kw] and Linear [out, in]. LayerNorm's
`scale` is torch's `weight`. `superpoint_state_dict` / `lightglue_state_dict`
carry a tree into a port module (the inverses of the converters in
rover_slam_tpu/models/superpoint.py and lightglue.py, `load_torch_weights`);
`superpoint_params` / `lightglue_params` carry a port module's state dict
back into the tree (numpy float32), the layout training.checkpoints
.save_params writes.
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


# Flax's default kernel init, lecun_normal: a normal of std sqrt(1 / fan_in)
# cut at +-2 std and rescaled by the std of the cut unit normal.
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Initialize every Linear and Conv2d of `module` as Flax's Dense and
    Conv do (kernels lecun_normal, biases 0) and every LayerNorm to scale 1,
    bias 0, drawing from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = float(np.sqrt(1.0 / fan_in)) / _TRUNC_STD
            with torch.no_grad():
                torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                            generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, torch.nn.LayerNorm):
            torch.nn.init.ones_(m.weight)
            torch.nn.init.zeros_(m.bias)
    return module


def _n(x) -> np.ndarray:
    return np.ascontiguousarray(x.detach().float().cpu().numpy())


def superpoint_params(state_dict: dict) -> dict:
    """A port SuperPoint's state dict as the JAX package's parameter tree."""
    params = {}
    for name in SUPERPOINT_LAYERS:
        leaf = {"kernel": np.ascontiguousarray(
                    _n(state_dict[f"{name}.weight"]).transpose(2, 3, 1, 0)),
                "bias": _n(state_dict[f"{name}.bias"])}
        params[name] = leaf if name in ("convPb", "convDb") else {"conv": leaf}
    return params


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


def lightglue_params(state_dict: dict) -> dict:
    """A port LightGlue's state dict as the JAX package's parameter tree
    (every layer the module has)."""
    def dense(prefix, bias=True):
        leaf = {"kernel": np.ascontiguousarray(_n(state_dict[f"{prefix}.weight"]).T)}
        if bias:
            leaf["bias"] = _n(state_dict[f"{prefix}.bias"])
        return leaf

    params = {"input_proj": dense("input_proj"),
              "posenc": {"Wr": dense("posenc.Wr", bias=False)},
              "final_proj": dense("final_proj"),
              "matchability": dense("matchability")}
    i = 0
    while f"layers.{i}.self_attn.to_q.weight" in state_dict:
        p = f"layers.{i}"
        layer = {blk: {lin: dense(f"{p}.{blk}.{lin}")
                       for lin in ("to_q", "to_k", "to_v", "to_out")}
                 for blk in ("self_attn", "cross_attn")}
        for blk in ("self_ffn", "cross_ffn"):
            layer[blk] = {"fc1": dense(f"{p}.{blk}.fc1"),
                          "ln": {"scale": _n(state_dict[f"{p}.{blk}.ln.weight"]),
                                 "bias": _n(state_dict[f"{p}.{blk}.ln.bias"])},
                          "fc2": dense(f"{p}.{blk}.fc2")}
        params[f"layer_{i}"] = layer
        i += 1
    return params


def lightglue_official_state_dict(flax_params: dict, num_layers: int = 9) -> dict:
    """The tree as an official LightGlue checkpoint's state dict (the layout
    models.lightglue.load_torch_weights reads): to_q / to_k / to_v fused into
    the self block's `Wqkv`, cross attention's `to_qk` from the tree's to_q
    (the official block shares one projection; the tree's to_k is dropped),
    the ffn as Sequential indices 0 / 1 / 3, the head under the last layer's
    `log_assignment`."""
    sd = {}
    _dense(sd, "input_proj", flax_params["input_proj"])
    _dense(sd, "posenc.Wr", flax_params["posenc"]["Wr"], bias=False)
    last = f"log_assignment.{num_layers - 1}"
    _dense(sd, f"{last}.final_proj", flax_params["final_proj"])
    _dense(sd, f"{last}.matchability", flax_params["matchability"])
    for i in range(num_layers):
        lp, p = flax_params[f"layer_{i}"], f"transformers.{i}"
        sa, ca = lp["self_attn"], lp["cross_attn"]
        sd[f"{p}.self_attn.Wqkv.weight"] = _t(np.concatenate(
            [np.asarray(sa[n]["kernel"]).T for n in ("to_q", "to_k", "to_v")]))
        sd[f"{p}.self_attn.Wqkv.bias"] = _t(np.concatenate(
            [np.asarray(sa[n]["bias"]) for n in ("to_q", "to_k", "to_v")]))
        _dense(sd, f"{p}.self_attn.out_proj", sa["to_out"])
        _dense(sd, f"{p}.cross_attn.to_qk", ca["to_q"])
        _dense(sd, f"{p}.cross_attn.to_v", ca["to_v"])
        _dense(sd, f"{p}.cross_attn.to_out", ca["to_out"])
        for blk, ffn in (("self_attn", lp["self_ffn"]), ("cross_attn", lp["cross_ffn"])):
            _dense(sd, f"{p}.{blk}.ffn.0", ffn["fc1"])
            sd[f"{p}.{blk}.ffn.1.weight"] = _t(ffn["ln"]["scale"])
            sd[f"{p}.{blk}.ffn.1.bias"] = _t(ffn["ln"]["bias"])
            _dense(sd, f"{p}.{blk}.ffn.3", ffn["fc2"])
    return sd
