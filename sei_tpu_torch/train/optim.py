"""Optimizers and per-step LR schedules (counterpart of
``sei_tpu/train/optim.py``).

Reference recipes: Adam(lr, betas=(0.9, beta2)) by default, SGD for
fine-tuning; ``multi_step_decay`` (x0.5 at 50/80/90/95% of the epochs) and
``delayed_linear_decay`` (constant for epochs/2, then linear to 1e-2 of the
base LR).  The reference steps its schedules once per epoch; they are
expressed here per optimizer step with ``steps_per_epoch``, as in the JAX
package.  Each schedule has two forms: a float function of the step (the
tests' comparisons) and a tensor function of a device step counter, the
counterpart of optax reading ``state.step`` inside the jitted step, so the
trainer's captured step computes its own LR on the device.  The tensor form
works in f64 in the float form's operation order and rounds once to f32, so
it equals the float form rounded to f32.  Adam is the stock
``torch.optim.Adam`` with a tensor LR, ``capturable`` on a CUDA device (its
step count and bias corrections on the device, updated inside a CUDA
graph): the JAX package left its elementwise update to XLA (optax), outside
any Pallas kernel.  SGD (fine-tuning's default) is :class:`SGD`, optax's
``sgd`` as two elementwise ops that read a tensor LR on the device, so a
CUDA graph holds it too.  :func:`trainable_mask` is fine-tuning's
``--fine_tuning_params``: only ``conv_last`` is handed to the optimizer, and
every other parameter stays as it was, bit for bit (optax's ``masked`` with
``set_to_zero``).  :func:`clip_by_global_norm_` is ``optax.clip_by_global_norm``,
which the JAX trainer chains before its optimizer when ``SEI_CLIP`` is set
(``sei_tpu/train/trainer.py:212-221``), on the device with no host sync.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]
TensorSchedule = Callable[[torch.Tensor], torch.Tensor]  # int64 step -> f32 LR
F64 = torch.float64


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


def multi_step_decay_tensor(lr: float, epochs: int, steps_per_epoch: int) -> TensorSchedule:
    milestones = {epochs * p // 100 for p in (50, 80, 90, 95)}
    bounds = sorted(m * steps_per_epoch for m in milestones)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        scale = torch.ones((), dtype=F64, device=step.device)
        for b in bounds:
            scale = torch.where(step >= b, scale * 0.5, scale)
        return (lr * scale).float()

    return schedule


def delayed_linear_decay_tensor(lr: float, epochs: int, steps_per_epoch: int) -> TensorSchedule:
    half = epochs // 2
    total = max(epochs // 2 - 1, 1)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        decayed = (torch.div(step, steps_per_epoch, rounding_mode="floor") - half).clamp(0, total)
        return (lr * (1.0 - 0.99 * decayed.to(F64) / total)).float()

    return schedule


def get_lr_schedule(kind, lr: float, epochs: int, steps_per_epoch: int) -> Schedule:
    if kind == "multi_step_decay":
        return multi_step_decay(lr, epochs, steps_per_epoch)
    if kind == "delayed_linear_decay":
        return delayed_linear_decay(lr, epochs, steps_per_epoch)
    if kind in (None, "none", "constant"):
        return lambda step: lr
    raise ValueError(f"Unknown lr scheduler: {kind}")


def get_lr_schedule_tensor(kind, lr: float, epochs: int, steps_per_epoch: int) -> TensorSchedule:
    """The schedule ``kind`` as a tensor function: an int64 step counter (a
    0-d tensor on any device) -> the f32 LR on that device, with no host
    round trip."""
    if kind == "multi_step_decay":
        return multi_step_decay_tensor(lr, epochs, steps_per_epoch)
    if kind == "delayed_linear_decay":
        return delayed_linear_decay_tensor(lr, epochs, steps_per_epoch)
    if kind in (None, "none", "constant"):
        return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)
    raise ValueError(f"Unknown lr scheduler: {kind}")


class SGD(torch.optim.Optimizer):
    """Plain SGD as optax's ``sgd`` computes it: u = g * (-lr), then p + u
    (two f32 roundings, no fused multiply-add).  ``lr`` may be a tensor on
    the parameters' device, read there: nothing goes to the host."""

    def __init__(self, params: Iterable[torch.Tensor], lr):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            neg_lr = -group["lr"]
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(p.grad * neg_lr)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` on ``grads`` in place: with
    the global norm (the root of the sum of every gradient's squares) below
    ``max_norm`` they stay as they are, else each becomes ``(g / norm) *
    max_norm``, two roundings as optax's.  All on the gradients' device
    (``where`` picks the divisor and factor, 1 leaves a gradient as it is),
    so a CUDA graph holds it; returns the norm, a 0-d tensor there."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = ~(norm < max_norm)  # optax keeps the gradients only when norm < max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


def trainable_mask(module: torch.nn.Module, names: tuple = ("conv_last",)) -> dict:
    """Parameter name -> whether it trains: those under a submodule named in
    ``names`` (``demo/train.py:214-225``: ``conv_last`` only)."""
    return {n: any(part in names for part in n.split(".")) for n, _ in module.named_parameters()}


def get_optimizer(params: Iterable[torch.Tensor], *, kind: str = "Adam", lr,
                  beta2: float = 0.999, capturable: bool = False) -> torch.optim.Optimizer:
    """Adam (betas (0.9, beta2), eps 1e-8, as optax.adam) or :class:`SGD`.
    ``lr`` is a float or a 1-element f32 tensor that the trainer rewrites
    each step; ``capturable`` (Adam on a CUDA device) keeps Adam's step
    count on the device, so a CUDA graph can hold the update (SGD needs
    nothing more)."""
    if kind == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, beta2), eps=1e-8,
                                capturable=capturable)
    if kind == "SGD":
        return SGD(params, lr=lr)
    raise ValueError(f"Unknown optimizer: {kind}")

