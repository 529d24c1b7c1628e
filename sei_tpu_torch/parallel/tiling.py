"""Spatial tiling with halo overlap (counterpart of ``sei_tpu/parallel/tiling.py``).

``tiled_apply`` splits the output height into strips; each strip is computed
from a fixed-size input window clamped inside the image (so the model sees
the true image boundary wherever its receptive field reaches it), and the
valid cores are stitched back together.  The strips run as one batch, one
forward.  Exact for models whose receptive field is within the halo; for
SwinIR a halo of 64 rows keeps the strips' boundary effects small.

``group`` (a ``torch.distributed`` process group of R > 1 ranks) is the
JAX function's ``mesh``: rank r runs ``model_fn`` on its share of the strips
(``ceil(n / R)`` of them, contiguous; a short share is filled up with copies
of its last strip, so every rank's batch has one shape), one ``all_gather``
brings every rank's outputs to every rank, and each rank stitches and
returns the whole image, as the JAX function returns one global array.  No
group, or a group of one rank, is the one-process path.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist


def strips(h: int, n_tiles: int, halo: int) -> tuple[int, int, list]:
    """(strip, window, [(window start, core offset in the window, core
    start)] per strip) for an image of ``h`` rows: the last strip slides
    back inside the image, overlapping the one before it."""
    strip = math.ceil(h / n_tiles)
    win = strip + 2 * halo
    if win > h:
        raise ValueError(f"tile window {win} exceeds image height {h}; lower n_tiles or halo")
    out = []
    for i in range(n_tiles):
        out_start = min(i * strip, h - strip)
        s = min(max(out_start - halo, 0), h - win)
        out.append((s, out_start - s, out_start))
    return strip, win, out


def _gathered(model_fn: Callable, windows: list, group) -> torch.Tensor:
    """Every strip's output, computed over the ranks of ``group`` (see the
    module docstring)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    share = -(-len(windows) // world)
    mine = [windows[min(rank * share + j, len(windows) - 1)] for j in range(share)]
    out = model_fn(torch.cat(mine)).contiguous()
    everyone = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(everyone, out, group=group)
    return torch.cat(everyone)[:len(windows)]


def tiled_apply(model_fn: Callable, y: torch.Tensor, *, n_tiles: int, halo: int,
                out_scale: int = 1, group=None) -> torch.Tensor:
    """Apply ``model_fn`` to a (1, C, H, W) measurement by H-strips with halo
    overlap.  ``model_fn`` maps (B', C, h, w) to (B', C', h * out_scale,
    w * out_scale); it gets the (n_tiles, C, window, W) strips as one batch,
    or with a ``group`` of R > 1 ranks this rank's share of them.  Needs H
    >= ceil(H / n_tiles) + 2 * halo."""
    b, _, h, w = y.shape
    if b != 1:
        raise ValueError(f"tiled_apply operates on a single image, got a batch of {b}")
    strip, win, parts = strips(h, n_tiles, halo)
    windows = [y[:, :, s:s + win] for s, _, _ in parts]
    if group is not None and dist.get_world_size(group) > 1:
        out_tiles = _gathered(model_fn, windows, group)
    else:
        out_tiles = model_fn(torch.cat(windows))
    sc = out_scale
    # overlapping strips write the same rows where the halo covers the
    # receptive field; the later strip's write stands, as in the JAX stitch
    full = out_tiles.new_zeros((1, out_tiles.shape[1], h * sc, w * sc))
    for i, (_, off, out_start) in enumerate(parts):
        full[0, :, out_start * sc:(out_start + strip) * sc] = \
            out_tiles[i, :, off * sc:(off + strip) * sc]
    return full
