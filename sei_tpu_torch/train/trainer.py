"""The training loop (counterpart of ``sei_tpu/train/trainer.py``).

One step: the step's images (a slice of the epoch's permutation), their
aligned dataset crop from the device cache, the loss with its model
evaluations (for ``proposed``: the 2B SURE forward and the EI forward, each
through the trunk kernels), ``backward`` (the trunk and attention backward
kernels), and Adam at the step's scheduled LR.  Epoch bookkeeping follows
the reference: ``len(dataset) // batch`` steps per epoch, the epoch's mean
loss to stdout and ``training.csv``, ``torch.save`` checkpoints at epoch 0,
every ``checkpoint_interval`` epochs and after the last.

Randomness comes from the trainer's own generators (:mod:`sei_tpu_torch.rng`):
permutation, crops, SURE probe, scaling parameters and drop-path each draw
from their own stream.  Not ported yet (ROADMAP, Queue 1): multi-GPU (DDP),
several steps per dispatch and a CUDA graph of the step, resume,
``eval_interval`` / ``ckp_best``, ``trainable_mask`` fine-tuning and the
weights-distance term.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from datetime import datetime
from typing import Any, Callable, Optional

import torch

from ..data import DeviceDataCache, epoch_indices, sample_train_batch
from ..rng import Streams, make_streams
from .optim import get_lr_schedule, get_optimizer, set_lr


@dataclasses.dataclass
class Trainer:
    """Owns the optimizer, the random streams and the epoch loop."""

    model: Any  # sei_tpu_torch.models.Model
    loss_fn: Callable  # loss(x, y, model, rng=None, draws=None) -> scalar
    physics: Any
    cache: DeviceDataCache
    batch_size: int = 8
    epochs: int = 500
    lr: float = 1e-4
    optimizer: str = "Adam"
    beta2: float = 0.999
    lr_scheduler_kind: Optional[str] = "delayed_linear_decay"
    crop_size: int = 256  # y-side dataset crop
    out_dir: Optional[str] = None
    checkpoint_interval: int = 50
    seed: int = 0

    def __post_init__(self):
        self.steps_per_epoch = max(len(self.cache) // self.batch_size, 1)
        self.schedule = get_lr_schedule(self.lr_scheduler_kind, self.lr, self.epochs,
                                        self.steps_per_epoch)
        self.opt = get_optimizer(self.model.module.parameters(), kind=self.optimizer,
                                 lr=self.schedule(0), beta2=self.beta2)
        self.streams: Streams = make_streams(self.seed, self.model.device)
        self.step_count = 0
        self._perm = None

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """The model as the loss calls it: training mode, drop-path from the
        dropout stream."""
        return self.model.module(y, generator=self.streams.dropout)

    def batch(self, step: int):
        """(x, y) of a global step: a new permutation at each epoch start."""
        step_in_epoch = step % self.steps_per_epoch
        if self._perm is None or step_in_epoch == 0:
            self._perm = torch.randperm(len(self.cache), generator=self.streams.batch)
        idx = epoch_indices(self._perm, step_in_epoch, self.batch_size)
        return sample_train_batch(self.cache, idx, crop_size=self.crop_size,
                                  generator=self.streams.crop)

    def step(self) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar, no sync)."""
        module = self.model.module
        module.train()
        x, y = self.batch(self.step_count)
        set_lr(self.opt, self.schedule(self.step_count))
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(x, y, self.apply, self.streams)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        return loss.detach()

    def train(self, *, log_every_epoch: bool = True,
              on_step: Optional[Callable[[int, torch.Tensor], None]] = None) -> dict:
        """Run ``epochs`` epochs; returns wall time, images/s and the epoch
        losses.  ``on_step(step, loss)`` is called after every step."""
        writer = None
        if self.out_dir:
            os.makedirs(os.path.join(self.out_dir, "checkpoints"), exist_ok=True)
            f = open(os.path.join(self.out_dir, "training.csv"), "w", newline="", buffering=1)
            writer = csv.writer(f)
            writer.writerow(["Epoch", "Training Loss"])
            self.save_checkpoint(0, epoch=0)
        t0 = time.perf_counter()
        epoch_losses = []
        for epoch in range(self.epochs):
            losses = []
            for _ in range(self.steps_per_epoch):
                loss = self.step()
                losses.append(loss)
                if on_step is not None:
                    on_step(self.step_count - 1, loss)
            epoch_loss = float(torch.stack(losses).mean())
            epoch_losses.append(epoch_loss)
            if log_every_epoch:
                ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                nd = len(str(self.epochs))
                print(f"\t{ts}\t[{epoch + 1:{nd}d}/{self.epochs}]\tTraining_Loss: {epoch_loss:.2e}")
            if writer:
                writer.writerow([epoch + 1, epoch_loss])
            if self.out_dir and (epoch % self.checkpoint_interval == 0
                                 or epoch == self.epochs - 1):
                self.save_checkpoint(epoch + 1, epoch=epoch)
        if writer:
            f.close()
        self.model.module.eval()
        dt = time.perf_counter() - t0
        images = self.step_count * self.batch_size
        return {"wall_time_s": dt, "images_per_sec": images / dt if dt > 0 else 0.0,
                "steps": self.step_count, "epoch_losses": epoch_losses}

    def checkpoint_path(self, index: int) -> str:
        width = len(str(self.epochs))
        return os.path.join(self.out_dir, "checkpoints", f"ckp_{index:0{width}d}.pt")

    def save_checkpoint(self, index: int, *, epoch: int) -> str:
        """``{"epoch", "params" (the state_dict), "optimizer"}``; loads back
        through ``Model.load_weights``."""
        path = self.checkpoint_path(index)
        torch.save({"epoch": epoch,
                    "params": {k: v.detach().cpu() for k, v in self.model.module.state_dict().items()},
                    "optimizer": self.opt.state_dict()}, path)
        return path
