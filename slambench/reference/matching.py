"""The nearest-neighbour reduce, plain: per row of desc0, the squared L2
distance 2 - 2 a.b to every valid row of desc1 (unit descriptors), the
argmin and the best distance, in float32 with TF32 off. The port's kernel B2
(csrc/nn_matcher.cu) reads the same descriptors rounded to bf16."""
from __future__ import annotations

import torch

from .precision import rnd
from .superpoint import tf32_off

BIG = 1e9


@torch.no_grad()
def distances(desc0: torch.Tensor, desc1: torch.Tensor, valid1: torch.Tensor,
              precision: str = "f32", block: int = 4096) -> torch.Tensor:
    """[N0, N1] squared distances (BIG at invalid columns), in row blocks."""
    tf32_off()
    b = rnd(desc1, precision)
    out = []
    for s in range(0, desc0.shape[0], block):
        d = 2.0 - 2.0 * (rnd(desc0[s:s + block], precision) @ b.T)
        out.append(torch.where(valid1[None, :], d, BIG))
    return torch.cat(out)


def reduce(desc0, desc1, valid1, precision: str = "f32"):
    """(best d^2 [N0], argmin [N0]) of the reduce."""
    d = distances(desc0, desc1, valid1, precision)
    best, idx = torch.min(d, dim=1)
    return best, idx
