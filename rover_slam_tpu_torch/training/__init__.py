"""Training of the learned front end on the synthetic photo world.

Counterpart of rover_slam_tpu/training/: the same SuperPoint and LightGlue
architectures trained on rendered photo-world pairs with exact ground truth
(data.py), with the JAX trainers' losses, optimizer and schedule, on the
card by default. checkpoints.py reads and writes the flat npz files the JAX
package ships.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TrainResult(NamedTuple):
    """What a trainer's train() returns."""
    params: dict              # the JAX package's parameter tree, numpy float32
    model: torch.nn.Module    # the trained module (f32 parameters)
    losses: np.ndarray        # [steps, 3]: the loss and its two terms at each step
    setup_s: float            # wall time of the training data (pool or dataset)
    heldout: tuple            # the held-out evaluation's numbers


def adam_cosine(params, lr: float, steps: int, alpha: float = 0.05):
    """optax.adam(optax.cosine_decay_schedule(lr, steps, alpha)) as a torch
    Adam (b1 0.9, b2 0.999, eps 1e-8: optax's defaults) and a LambdaLR:
    update t (from 0) takes lr * ((1 - alpha) * (1 + cos(pi * min(t, steps)
    / steps)) / 2 + alpha), as optax counts. Call scheduler.step() after
    each optimizer.step()."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def factor(t):
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps)) + alpha

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
