"""Robust-kernel weights and chi2 gates (counterpart of
rover_slam_tpu/optim/robust.py)."""
from __future__ import annotations

import torch

# chi-square 95% gates
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 for chi2 <= delta2, else
    delta/sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / safe))


def cauchy_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Cauchy kernel: 1 / (1 + chi2 / delta2)."""
    return 1.0 / (1.0 + chi2 / delta2)


def huber_cost(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber cost on squared residuals (ba._huber_cost / pose_opt._huber_cost
    in the JAX package)."""
    delta = delta2 ** 0.5
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * r - delta2)
