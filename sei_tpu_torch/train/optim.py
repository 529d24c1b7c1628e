"""Optimizers and per-step LR schedules (counterpart of
``sei_tpu/train/optim.py``).

Reference recipes: Adam(lr, betas=(0.9, beta2)) by default, SGD for
fine-tuning; ``multi_step_decay`` (x0.5 at 50/80/90/95% of the epochs) and
``delayed_linear_decay`` (constant for epochs/2, then linear to 1e-2 of the
base LR).  The reference steps its schedules once per epoch; they are
expressed here per optimizer step with ``steps_per_epoch``, as in the JAX
package.  Adam is the stock ``torch.optim.Adam``: the JAX package left its
elementwise update to XLA (optax), outside any Pallas kernel.  The
``trainable_mask`` of fine-tuning is not ported yet (ROADMAP, Queue 1).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def multi_step_decay(lr: float, epochs: int, steps_per_epoch: int) -> Schedule:
    """x0.5 at each distinct milestone (optax's piecewise-constant schedule
    over a dict, so milestones that coincide count once)."""
    milestones = {epochs * p // 100 for p in (50, 80, 90, 95)}
    bounds = sorted(m * steps_per_epoch for m in milestones)
    return lambda step: lr * 0.5 ** sum(step >= b for b in bounds)


def delayed_linear_decay(lr: float, epochs: int, steps_per_epoch: int) -> Schedule:
    """Constant for epochs // 2 epochs, then torch LinearLR(1 -> 1e-2) over
    max(epochs // 2 - 1, 1) epochs."""
    half = epochs // 2
    total = max(epochs // 2 - 1, 1)

    def schedule(step: int) -> float:
        decayed = min(max(step // steps_per_epoch - half, 0), total)
        return lr * (1.0 - 0.99 * decayed / total)

    return schedule


def get_lr_schedule(kind, lr: float, epochs: int, steps_per_epoch: int) -> Schedule:
    if kind == "multi_step_decay":
        return multi_step_decay(lr, epochs, steps_per_epoch)
    if kind == "delayed_linear_decay":
        return delayed_linear_decay(lr, epochs, steps_per_epoch)
    if kind in (None, "none", "constant"):
        return lambda step: lr
    raise ValueError(f"Unknown lr scheduler: {kind}")


def get_optimizer(params: Iterable[torch.Tensor], *, kind: str = "Adam", lr: float,
                  beta2: float = 0.999) -> torch.optim.Optimizer:
    """Adam (betas (0.9, beta2), eps 1e-8, as optax.adam) or plain SGD; the
    trainer sets each step's LR from the schedule."""
    if kind == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, beta2), eps=1e-8)
    if kind == "SGD":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"Unknown optimizer: {kind}")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
