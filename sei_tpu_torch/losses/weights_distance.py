"""The fine-tuning regularizer (counterpart of
``sei_tpu/losses/weights_distance.py``): lambda times the mean over
parameter tensors of each tensor's mean squared distance to a frozen copy of
the starting weights.  The tensors are summed in the module's parameter
order, not in the JAX tree's leaf order, so the two packages agree to f32
roundoff, not bit for bit."""

from __future__ import annotations

from typing import Sequence

import torch


def weights_distance_loss(params: Sequence[torch.Tensor], pretrained: Sequence[torch.Tensor],
                          lambd: float = 1.0) -> torch.Tensor:
    """``lambd * mean_i mean((p_i - q_i) ** 2)`` over paired tensors, in f32."""
    params, pretrained = list(params), list(pretrained)
    if len(params) != len(pretrained):
        raise ValueError(f"{len(params)} parameter tensors against {len(pretrained)} frozen ones")
    total = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for p, q in zip(params, pretrained):
        d = p.float() - q.float()
        total = total + torch.mean(d * d)
    return lambd * total / len(params)
