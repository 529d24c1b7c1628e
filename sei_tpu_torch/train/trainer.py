"""The training loop (counterpart of ``sei_tpu/train/trainer.py``).

One step: the step's images (a slice of the epoch's permutation), their
aligned dataset crop from the device cache, the loss with its model
evaluations (for ``proposed``: the 2B SURE forward and the EI forward, each
through the trunk kernels), ``backward`` (the trunk and attention backward
kernels), Adam at the step's scheduled LR, and the step counter + 1.  Epoch
bookkeeping follows the reference: ``len(dataset) // batch`` steps per
epoch, the epoch's mean loss to stdout and ``training.csv``, ``torch.save``
checkpoints at epoch 0, every ``checkpoint_interval`` epochs and after the
last; :meth:`Trainer.load_checkpoint` resumes from one.  With
``eval_interval`` and an ``eval_hook``
(:class:`~sei_tpu_torch.train.validate.ValidationHook`), the val split is
scored after every ``eval_interval``-th epoch and the last one, eagerly
between dispatches: the ``Validation [e/E] PSNR: .. SSIM: ..`` line,
``validation.csv`` (``Epoch,PSNR,SSIM``) and, on each new best PSNR,
``checkpoints/ckp_best.pt`` (the JAX trainer's :382-393, :420-436).

**One dispatch per ``scan_steps`` steps** (the counterpart of the JAX
package's one jitted, scanned step, :291-347).  On a CUDA device the
trainer warms up eagerly on a side stream (building the kernels, cuFFT
plans, cuDNN choices and the shift-mask cache, and Adam's state), undoes
the warm-up, and captures ``scan_steps`` whole steps into one CUDA graph;
each dispatch is then a copy of the steps' image indices into a static
device buffer (from pinned host memory) and one ``graph.replay()``.  The
step's random draws come from the trainer's device generators, registered
with the graph, so every replay draws new numbers; its LR comes from a
tensor schedule of a device step counter; Adam is ``capturable``.
``capture=False``, or a CPU device, runs the same steps eagerly, one launch
at a time (what per-kernel profiling needs).  A capture that fails raises;
nothing falls back.

Randomness comes from the trainer's own generators (:mod:`sei_tpu_torch.rng`):
permutation (host), crops, SURE probe, transform draws, drop-path and
measurement noise (device) each draw from their own stream.

The training modes of the JAX trainer (:150-160, :244-246, :324-327,
:349-401): ``css`` and ``fresh_measurements`` degrade the step's images on
the device (``data.sample_train_batch``, the ``noise`` stream);
``trainable_mask`` (parameter name -> bool, ``optim.trainable_mask``) hands
only the True parameters to the optimizer, so the others stay bit for bit;
``weights_distance_lambda`` adds ``losses.weights_distance_loss`` against a
frozen copy of the starting weights; ``clip_norm`` (when not given,
``SEI_CLIP`` as the JAX trainer reads it, :212-221; unset or empty: off)
clips the step's gradients to that global norm before the optimizer
(``optim.clip_by_global_norm_``, optax's formula), over every parameter's
gradient, the frozen ones of ``trainable_mask`` included, as the JAX chain
puts the clip outside the masked optimizer, and after the data-parallel
all-reduce; ``grad_norm`` holds the last step's norm before the clip, on
the device; ``normal_rate_losses`` (the normal
scaling kind, one loss per rate) gives each loss its own step and CUDA
graph, and before each dispatch the host picks one with
``np.random.default_rng(0).integers(n)``, reset at each :meth:`train`, as
the JAX trainer does.

``data_parallel`` (a :class:`~sei_tpu_torch.parallel.DataParallel`, this
process's rank in a process group; the JAX trainer's mesh, :182-193,
:258-293): every rank keeps the whole state and the global batch's
indices, draws the step's random numbers at the global batch's shapes and
keeps its own rows (:func:`sei_tpu_torch.parallel.sharded_rows`), runs
forward and backward on its ``batch_size / R`` images, copies the
gradients and the loss into one flat buffer, all-reduces it and divides it
by R (each ``.grad`` then a view into it) before the optimizer step; so R
ranks compute the one-process step.  The all-reduce is part of the captured step.  Rank 0
alone writes ``training.csv``, ``validation.csv`` and the checkpoints, and
validates while the other ranks wait at a barrier.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import math
import os
import time
from datetime import datetime
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..data import DeviceDataCache, epoch_indices, sample_train_batch
from ..losses import weights_distance_loss
from ..ops.swin_trunk import launch_counts
from ..parallel import DataParallel, sharded_rows
from ..rng import Streams, make_streams
from .optim import clip_by_global_norm_, get_lr_schedule_tensor, get_optimizer


@dataclasses.dataclass
class Trainer:
    """Owns the optimizer, the random streams, the step's CUDA graph and the
    epoch loop."""

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
    scan_steps: int = 1  # steps per dispatch
    capture: bool = True  # one CUDA graph per dispatch (CUDA devices only)
    start_epoch: int = 0
    # every eval_interval epochs (and after the last): eval_hook(model) ->
    # (psnr, ssim), validation.csv and ckp_best; 0 = off
    eval_interval: int = 0
    eval_hook: Optional[Callable] = None
    css: bool = False  # (x, y) -> (y, degrade(y)) before the crop
    fresh_measurements: bool = False  # y = degrade(x) anew at every step
    trainable_mask: Optional[dict] = None  # parameter name -> trains
    weights_distance_lambda: Optional[float] = None
    normal_rate_losses: Optional[list] = None  # one loss per normal-kind rate
    data_parallel: Optional[DataParallel] = None  # this process's rank; None: one process
    clip_norm: Optional[float] = None  # global-norm gradient clip; None: SEI_CLIP

    def __post_init__(self):
        dev = self.model.device
        dp = self.data_parallel
        self._rows = None if dp is None else dp.rows(self.batch_size)  # raises if R does not divide
        self.leader = dp is None or dp.rank == 0  # writes the files, validates, prints
        self.steps_per_epoch = max(len(self.cache) // self.batch_size, 1)
        if self.scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {self.scan_steps}")
        # an epoch is a whole number of dispatches (the JAX trainer's rule, :195-198)
        self.scan_steps = math.gcd(self.scan_steps, self.steps_per_epoch)
        self.graphed = self.capture and dev.type == "cuda"
        self.lr_schedule = get_lr_schedule_tensor(self.lr_scheduler_kind, self.lr,
                                                  self.epochs, self.steps_per_epoch)
        self.step_t = torch.zeros((), dtype=torch.int64, device=dev)  # what the LR reads
        self.lr_t = self.lr_schedule(self.step_t)
        if self.clip_norm is None and os.environ.get("SEI_CLIP"):
            self.clip_norm = float(os.environ["SEI_CLIP"])
        self.grad_norm: Optional[torch.Tensor] = None
        named = list(self.model.module.named_parameters())
        mask = self.trainable_mask
        self.opt = get_optimizer([p for n, p in named if mask is None or mask[n]],
                                 kind=self.optimizer, lr=self.lr_t, beta2=self.beta2,
                                 capturable=dev.type == "cuda")
        self._pretrained = None
        if self.weights_distance_lambda is not None:
            with torch.no_grad():
                self._pretrained = [p.detach().clone() for _, p in named]
        self.streams: Streams = make_streams(self.seed, dev)
        self.flat_grads = None  # data parallel: [every gradient, the loss], all-reduced at once
        if dp is not None:
            self._grad_params = [p for p in self.model.module.parameters() if p.requires_grad]
            self.flat_grads = torch.empty(sum(p.numel() for p in self._grad_params) + 1,
                                          device=dev)
        self.step_count = 0
        self._perm = None
        shape = (self.scan_steps, self.batch_size)
        self._idx = torch.zeros(shape, dtype=torch.int64, device=dev)
        self._idx_host = torch.zeros(shape, dtype=torch.int64, pin_memory=dev.type == "cuda")
        self._idx_copied = torch.cuda.Event() if dev.type == "cuda" else None
        self._losses = torch.zeros(self.scan_steps, device=dev)
        self.graphs: dict = {}  # variant -> its captured CUDA graph
        self.replays = 0
        self.capture_launches: Optional[dict] = None  # trunk kernel launches in the last graph
        self.variants: list = []  # the variant of every dispatch, in order
        self._variant_rng = np.random.default_rng(0)

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """The model as the loss calls it: training mode, drop-path from the
        dropout stream."""
        return self.model.module(y, generator=self.streams.dropout)

    def indices(self, step: int) -> torch.Tensor:
        """The images of a global step (host): a new permutation from the
        batch stream at each epoch start."""
        step_in_epoch = step % self.steps_per_epoch
        if self._perm is None or step_in_epoch == 0:
            self._perm = torch.randperm(len(self.cache), generator=self.streams.batch)
        return epoch_indices(self._perm, step_in_epoch, self.batch_size)

    def _sample(self, idx: torch.Tensor):
        return sample_train_batch(self.cache, idx, crop_size=self.crop_size,
                                  generator=self.streams.crop, physics=self.physics,
                                  css=self.css, fresh_measurements=self.fresh_measurements,
                                  noise_generator=self.streams.noise)

    def batch(self, step: int):
        """(x, y) of a global step, crops drawn from the crop stream."""
        return self._sample(self.indices(step))

    @property
    def n_variants(self) -> int:
        return len(self.normal_rate_losses) if self.normal_rate_losses else 1

    def _all_reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """The step's gradients and loss copied into one flat buffer, summed
        over the ranks and divided by their number; each ``.grad`` is then a
        view into it.  Returns the mean loss."""
        grads = [p.grad for p in self._grad_params]
        if any(g is None for g in grads):  # Adam would skip it in one process
            raise RuntimeError("data parallel: a parameter got no gradient")
        flat = self.flat_grads
        torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)], out=flat)
        self.data_parallel.all_reduce_mean_(flat)
        offset = 0
        for p in self._grad_params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[-1]

    def _one_step(self, i: int, variant: int = 0) -> None:
        """Inner step ``i`` of a dispatch, all on the device: what the graph
        holds."""
        idx, rows = self._idx[i], contextlib.nullcontext()
        dp = self.data_parallel
        if dp is not None:
            idx = idx[self._rows]
            rows = sharded_rows(dp.rank, dp.world, self._rows.stop - self._rows.start)
        with rows:
            x, y = self._sample(idx)
            self.lr_t.copy_(self.lr_schedule(self.step_t))
            self.model.module.zero_grad(set_to_none=True)
            loss_fn = self.normal_rate_losses[variant] if self.normal_rate_losses else self.loss_fn
            loss = loss_fn(x, y, self.apply, self.streams)
            if self._pretrained is not None:
                loss = loss + weights_distance_loss(self.model.module.parameters(),
                                                    self._pretrained, self.weights_distance_lambda)
            loss.backward()
        if dp is not None:
            loss = self._all_reduce(loss)
        if self.clip_norm is not None:
            grads = [p.grad for p in self.model.module.parameters() if p.grad is not None]
            self.grad_norm = clip_by_global_norm_(grads, self.clip_norm)
        self.opt.step()
        self.step_t += 1
        self._losses[i].copy_(loss.detach())

    def _load_indices(self) -> None:
        """The next dispatch's image indices into the static device buffer."""
        if self._idx_copied is not None:
            self._idx_copied.synchronize()  # the previous copy has read the pinned buffer
        for i in range(self.scan_steps):
            self._idx_host[i] = self.indices(self.step_count + i)
        self._idx.copy_(self._idx_host, non_blocking=True)
        if self._idx_copied is not None:
            self._idx_copied.record()

    def _state_tensors(self) -> list:
        """Every tensor a step updates: params, Adam state, step counter, LR."""
        opt_state = [v for s in self.opt.state.values() for v in s.values() if torch.is_tensor(v)]
        return [*self.model.module.parameters(), *opt_state, self.step_t, self.lr_t]

    def _warm_up(self, variant: int = 0) -> None:
        """One eager dispatch on a side stream, then the trainer's state and
        device streams put back as they were: the warm-up builds what a
        capture cannot (kernels, cuFFT plans, cuDNN choices, the shift-mask
        cache, Adam's state tensors) and counts as no training."""
        fresh = not self.opt.state  # Adam makes its state at its first step
        tensors = self._state_tensors()
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        gens = self.streams.device_generators()
        gen_states = [g.get_state() for g in gens]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(self.scan_steps):
                self._one_step(i, variant)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            if fresh:  # zero, as a first step would find it
                for state in self.opt.state.values():
                    for v in state.values():
                        v.zero_()
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(gens, gen_states):
            g.set_state(s)
        torch.cuda.synchronize()

    def _capture(self, variant: int = 0) -> None:
        """Warm up, then capture ``scan_steps`` steps of ``variant`` into one
        CUDA graph."""
        self._warm_up(variant)
        graph = torch.cuda.CUDAGraph()
        for g in self.streams.device_generators():
            graph.register_generator_state(g)
        self.model.module.zero_grad(set_to_none=True)
        before = launch_counts()
        # NCCL's watchdog thread queries the events of earlier collectives
        # (the warm-up's); "global" mode would let that break the capture
        mode = "global" if self.data_parallel is None else "thread_local"
        with torch.cuda.graph(graph, capture_error_mode=mode):
            for i in range(self.scan_steps):
                self._one_step(i, variant)
        self.capture_launches = {k: v - before[k] for k, v in launch_counts().items()}
        self.graphs[variant] = graph

    def step(self) -> torch.Tensor:
        """One dispatch: ``scan_steps`` optimizer steps; returns their losses
        (a (scan_steps,) device tensor, no sync)."""
        self.model.module.train()
        variant = int(self._variant_rng.integers(self.n_variants)) if self.n_variants > 1 else 0
        self.variants.append(variant)
        self._load_indices()
        if self.graphed:
            if variant not in self.graphs:
                self._capture(variant)
            self.graphs[variant].replay()
            self.replays += 1
        else:
            for i in range(self.scan_steps):
                self._one_step(i, variant)
        self.step_count += self.scan_steps
        return self._losses.clone()

    def train(self, *, log_every_epoch: bool = True,
              on_step: Optional[Callable[[int, torch.Tensor], None]] = None) -> dict:
        """Run epochs ``start_epoch`` .. ``epochs - 1``; returns wall time,
        images/s, the epoch losses and the validations ``(epoch, psnr,
        ssim)``.  ``on_step(step, loss)`` is called for every step, after the
        dispatch that ran it.  A resumed run appends to the CSV files."""
        validating = bool(self.eval_interval) and self.eval_hook is not None
        self._variant_rng = np.random.default_rng(0)  # the JAX trainer's, per train()
        files, writer, val_writer = [], None, None
        writes = bool(self.out_dir) and self.leader
        if writes:
            os.makedirs(os.path.join(self.out_dir, "checkpoints"), exist_ok=True)
            fresh = self.start_epoch == 0

            def table(name, header):
                files.append(open(os.path.join(self.out_dir, name), "w" if fresh else "a",
                                  newline="", buffering=1))
                w = csv.writer(files[-1])
                if fresh:
                    w.writerow(header)
                return w

            writer = table("training.csv", ["Epoch", "Training Loss"])
            if validating:
                val_writer = table("validation.csv", ["Epoch", "PSNR", "SSIM"])
            if fresh:
                self.save_checkpoint(0, epoch=0)
        validations, best_psnr = [], -math.inf
        t0 = time.perf_counter()
        steps0 = self.step_count
        epoch_losses = []
        for epoch in range(self.start_epoch, self.epochs):
            losses = []
            for _ in range(self.steps_per_epoch // self.scan_steps):
                dispatch = self.step()
                losses.append(dispatch)
                if on_step is not None:
                    first = self.step_count - self.scan_steps
                    for i in range(self.scan_steps):
                        on_step(first + i, dispatch[i])
            epoch_loss = float(torch.cat(losses).mean())
            epoch_losses.append(epoch_loss)
            if log_every_epoch and self.leader:
                ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                nd = len(str(self.epochs))
                print(f"\t{ts}\t[{epoch + 1:{nd}d}/{self.epochs}]\tTraining_Loss: {epoch_loss:.2e}")
            if writer:
                writer.writerow([epoch + 1, epoch_loss])
            if writes and (epoch % self.checkpoint_interval == 0 or epoch == self.epochs - 1):
                self.save_checkpoint(epoch + 1, epoch=epoch)
            if validating and ((epoch + 1) % self.eval_interval == 0
                               or epoch == self.epochs - 1):
                if not self.leader:  # rank 0 validates
                    self.data_parallel.barrier()
                    continue
                psnr, ssim = self.eval_hook(self.model)
                best = psnr > best_psnr
                print(f"\tValidation [{epoch + 1}/{self.epochs}] PSNR: {psnr:.2f} "
                      f"SSIM: {ssim:.4f}" + (" (best)" if best else ""))
                validations.append((epoch + 1, psnr, ssim))
                if val_writer:
                    val_writer.writerow([epoch + 1, f"{psnr:.4f}", f"{ssim:.6f}"])
                if best:
                    best_psnr = psnr
                    if writes:
                        self.save_checkpoint("best", epoch=epoch)
                if self.data_parallel is not None:
                    self.data_parallel.barrier()
        for f in files:
            f.close()
        self.model.module.eval()
        dt = time.perf_counter() - t0
        images = (self.step_count - steps0) * self.batch_size
        return {"wall_time_s": dt, "images_per_sec": images / dt if dt > 0 else 0.0,
                "steps": self.step_count, "epoch_losses": epoch_losses,
                "validation": validations}

    def checkpoint_path(self, index) -> str:
        """``checkpoints/ckp_<index>.pt``: a number zero-padded to the width
        of ``epochs``, or a name (``best``)."""
        name = index if isinstance(index, str) else f"{index:0{len(str(self.epochs))}d}"
        return os.path.join(self.out_dir, "checkpoints", f"ckp_{name}.pt")

    def save_checkpoint(self, index, *, epoch: int) -> str:
        """``{"epoch", "params" (the state_dict), "optimizer", "step",
        "streams"}`` at :meth:`checkpoint_path`; loads back through
        ``Model.load_weights`` and :meth:`load_checkpoint`."""
        path = self.checkpoint_path(index)
        torch.save({"epoch": epoch, "step": self.step_count,
                    "params": {k: v.detach().cpu() for k, v in self.model.module.state_dict().items()},
                    "optimizer": self.opt.state_dict(), "streams": self.streams.get_state()},
                   path)
        return path

    def load_checkpoint(self, path: str) -> dict:
        """Resume (counterpart of ``sei_tpu/train/trainer.py:476-485``):
        restore the params, Adam's state, the step counter and the random
        streams, and start at the epoch after the checkpoint's last one, so
        the resumed run continues the interrupted run exactly.  (The JAX
        trainer restarts at the checkpoint's ``epoch`` entry, its last
        epoch, and so repeats that epoch; the training command line's
        ``--RESUME`` does the same by setting ``start_epoch`` to that entry
        after this call, ``sei_tpu_torch/cli/train.py``.)  A captured step
        is captured again at the next dispatch."""
        data = torch.load(path, map_location="cpu", weights_only=False)
        self.model.load_weights(data)
        self.opt.load_state_dict(data["optimizer"])
        for group in self.opt.param_groups:
            group["lr"] = self.lr_t  # load_state_dict put a copy there
        self.step_count = int(data["step"])
        self.step_t.fill_(self.step_count)
        self.lr_t.copy_(self.lr_schedule(self.step_t))
        self.streams.set_state(data["streams"])
        self.start_epoch = self.step_count // self.steps_per_epoch
        self._perm = None
        self.graphs = {}
        return data
