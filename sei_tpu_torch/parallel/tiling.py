"""Spatial tiling with halo overlap (counterpart of ``sei_tpu/parallel/tiling.py``).

``tiled_apply`` splits the output height into strips; each strip is computed
from a fixed-size input window clamped inside the image (so the model sees
the true image boundary wherever its receptive field reaches it), and the
valid cores are stitched back together.  The strips run as one batch, one
forward.  Exact for models whose receptive field is within the halo; for
SwinIR a halo of 64 rows keeps the strips' boundary effects small.

The JAX function's ``mesh`` argument (the strips sharded over devices) is
not ported: the eval protocol never passes it (ROADMAP, Queue 1).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


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


def tiled_apply(model_fn: Callable, y: torch.Tensor, *, n_tiles: int, halo: int,
                out_scale: int = 1) -> torch.Tensor:
    """Apply ``model_fn`` to a (1, C, H, W) measurement by H-strips with halo
    overlap.  ``model_fn`` maps (B', C, h, w) to (B', C', h * out_scale,
    w * out_scale); it gets the (n_tiles, C, window, W) strips as one batch.
    Needs H >= ceil(H / n_tiles) + 2 * halo."""
    b, _, h, w = y.shape
    if b != 1:
        raise ValueError(f"tiled_apply operates on a single image, got a batch of {b}")
    strip, win, parts = strips(h, n_tiles, halo)
    out_tiles = model_fn(torch.cat([y[:, :, s:s + win] for s, _, _ in parts]))
    sc = out_scale
    # overlapping strips write the same rows where the halo covers the
    # receptive field; the later strip's write stands, as in the JAX stitch
    full = out_tiles.new_zeros((1, out_tiles.shape[1], h * sc, w * sc))
    for i, (_, off, out_start) in enumerate(parts):
        full[0, :, out_start * sc:(out_start + strip) * sc] = \
            out_tiles[i, :, off * sc:(off + strip) * sc]
    return full
