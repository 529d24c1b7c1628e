"""Aligned pair cropping (counterpart of ``sei_tpu/transforms/crop.py``).

Both images are constant-padded bottom/right to the crop size, then both
get a ``size`` crop at one per-image offset.  Offsets are host integers
(drawn from a CPU generator or passed in), so the crops are plain slices
with no device sync.  The SR crop ratio (x cropped ``size * rate`` at the
scaled offset) comes with the SR task (ROADMAP, Queue 1 item 18).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def pad_min_size(x: torch.Tensor, size_h: int, size_w: int) -> torch.Tensor:
    """Constant-pad the bottom/right of (..., H, W) to reach a minimum size."""
    ph, pw = max(0, size_h - x.shape[-2]), max(0, size_w - x.shape[-1])
    return F.pad(x, (0, pw, 0, ph)) if ph or pw else x


def crop_offsets(generator: torch.Generator, heights, widths, size: int) -> torch.Tensor:
    """(B, 2) int offsets, uniform over [0, max(h - size + 1, 1)) per image
    (the distribution of ``torch.randint(0, h - size + 1)``)."""
    heights = torch.as_tensor(heights, dtype=torch.int64)
    widths = torch.as_tensor(widths, dtype=torch.int64)
    hi = torch.stack([(heights - size + 1).clamp_min(1), (widths - size + 1).clamp_min(1)], 1)
    u = torch.rand(hi.shape, generator=generator, dtype=torch.float64)
    return torch.minimum((u * hi).long(), hi - 1)


def crop_pair_batch(x: torch.Tensor, y: torch.Tensor, *, size: int,
                    offsets: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Per-image aligned crops of a batch (B, C, H, W) -> (x_crop, y_crop).

    ``offsets`` (B, 2) are (top, left); without them they are drawn from
    ``generator`` over the padded images.
    """
    x = pad_min_size(x, size, size)
    y = pad_min_size(y, size, size)
    b, _, h, w = y.shape
    if offsets is None:
        offsets = crop_offsets(generator, [h] * b, [w] * b, size)
    offs = torch.as_tensor(offsets).tolist()
    xs = [x[i, :, t:t + size, l:l + size] for i, (t, l) in enumerate(offs)]
    ys = [y[i, :, t:t + size, l:l + size] for i, (t, l) in enumerate(offs)]
    return torch.stack(xs), torch.stack(ys)
