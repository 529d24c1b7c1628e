"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``sei_tpu/parallel/__init__.py``: ``make_mesh``, ``shard_batch``,
``replicate``).

The JAX package shards each step's global batch over a 1-D
``Mesh(('data',))``: one program over the global batch, parameters and
optimizer state replicated, the gradients reduced by the ``psum`` XLA
inserts.  The mesh changes where work runs, not what it computes, so R
ranks here compute the one-process step over the same global batch of B
images.  Each rank:

- draws every random number of the step at the global shape, from
  generators seeded as the one-process trainer seeds them, and keeps its
  own rows (:func:`draw_rows`, active inside :func:`sharded_rows`);
- runs forward and backward on its B / R images;
- all-reduces the gradients (one flat buffer) and divides them by R before
  the optimizer step (:meth:`DataParallel.all_reduce_mean_`), and reports
  the mean of the ranks' losses.

A batch of local rows is ``n / b`` blocks of b = B / R rows, each block
this rank's slice of a global block of B rows: the plain B-row batch, and
the 2B stacks of SURE's and R2R's forwards (``[y, y + tau b]``), whose
halves rank r holds rows ``r * b ..`` of.  So a drop-path mask of a 2b
forward keeps the one-process 2B draw's rows of both halves.

NCCL on CUDA devices, gloo on the CPU; the rendezvous is a file
(``init_method="file://..."``), which needs no port and no network.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

# (rank, world, rows per rank) while a data-parallel step draws; a context
# variable, so it holds only inside the ``with sharded_rows(...)`` block
_SHARD: contextvars.ContextVar = contextvars.ContextVar("sei_tpu_torch_shard", default=None)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the default process group: rank ``rank`` of
    ``world``."""

    rank: int
    world: int

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` images; raises
        when ``world`` does not divide it (as the JAX ``NamedSharding``
        does)."""
        if batch % self.world:
            raise ValueError(f"the batch of {batch} does not divide over {self.world} ranks")
        b = batch // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, then divided by the world size, in
        place."""
        dist.all_reduce(t)
        return t.div_(self.world)

    def barrier(self) -> None:
        dist.barrier()


def init(rank: int, world: int, init_file: str, device: torch.device) -> DataParallel:
    """Join the process group of ``world`` ranks as ``rank``: NCCL for a
    CUDA ``device`` (made current), gloo for the CPU; rendezvous through
    ``init_file``, which must not exist before the first rank comes."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}",
                            rank=rank, world_size=world)
    return DataParallel(rank=rank, world=world)


@contextlib.contextmanager
def sharded_rows(rank: int, world: int, rows: int):
    """Inside the block, :func:`draw_rows` draws at the global shape and
    keeps rank ``rank``'s rows (``rows`` per rank)."""
    token = _SHARD.set((rank, world, rows))
    try:
        yield
    finally:
        _SHARD.reset(token)


def global_rows(n: int) -> int:
    """The one-process size of a local batch of ``n`` rows."""
    shard = _SHARD.get()
    return n if shard is None else n * shard[1]


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, a per-row draw whose dimension ``dim`` runs over a
    batch's rows; inside :func:`sharded_rows`, drawn at the one-process
    (global) shape and cut to this rank's rows, so the generator moves as
    in the one-process step."""
    shape = tuple(shape)
    shard = _SHARD.get()
    if shard is None:
        return draw(shape)
    rank, world, b = shard
    n = shape[dim]
    if n % b:
        raise ValueError(f"a draw over {n} rows is not made of blocks of the {b} rows per rank")
    full = draw(shape[:dim] + (n * world,) + shape[dim + 1:])
    return full.unflatten(dim, (n // b, world, b)).select(dim + 1, rank).flatten(dim, dim + 1)


__all__ = ["DataParallel", "draw_rows", "global_rows", "init", "sharded_rows"]
