"""Rounding of a product's inputs to a lower precision, for the controls.

"f32": unchanged. "fp8": per-tensor scaled float8 e4m3 (the scale maps the
largest magnitude to 448, e4m3's largest finite value), as fp8 inference
quantizes activations and weights. Products then accumulate in float32.
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as a product reads it in `precision` (float32 out)."""
    if precision == "f32":
        return x.float()
    if precision == "fp8":
        return _fp8(x)
    raise ValueError(f"unknown precision {precision!r}")
