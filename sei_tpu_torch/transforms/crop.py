"""Aligned pair cropping (counterpart of ``sei_tpu/transforms/crop.py``).

Both images are constant-padded bottom/right to the crop size (x to
``size * ratio``), then y gets a ``size`` crop at a per-image offset and x
the aligned ``size * ratio`` crop at ``ratio`` times it (the SR pairs,
``ratio`` the rate; 1 otherwise).  Offsets are a (B, 2) tensor on the
images' device (drawn there from the trainer's crop stream, or passed in),
and the crops are one gather built from them, the counterpart of
``jax.lax.dynamic_slice`` under ``vmap`` (:25-92): no offset reaches the
host, so a CUDA graph of the training step can hold the crops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import draw_rows


def pad_min_size(x: torch.Tensor, size_h: int, size_w: int) -> torch.Tensor:
    """Constant-pad the bottom/right of (..., H, W) to reach a minimum size."""
    ph, pw = max(0, size_h - x.shape[-2]), max(0, size_w - x.shape[-1])
    return F.pad(x, (0, pw, 0, ph)) if ph or pw else x


def crop_offsets(generator: torch.Generator, heights, widths, size: int) -> torch.Tensor:
    """(B, 2) int offsets on the generator's device, uniform over
    [0, max(h - size + 1, 1)) per image (the distribution of
    ``torch.randint(0, h - size + 1)``).  heights, widths: (B,) int tensors
    (best on the generator's device: no copy) or sequences."""
    dev = generator.device
    heights = torch.as_tensor(heights, dtype=torch.int64, device=dev)
    widths = torch.as_tensor(widths, dtype=torch.int64, device=dev)
    hi = torch.stack([(heights - size + 1).clamp_min(1), (widths - size + 1).clamp_min(1)], 1)
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=dev, dtype=torch.float64),
                  hi.shape)
    return torch.minimum((u * hi).long(), hi - 1)


def crop_batch(img: torch.Tensor, offsets: torch.Tensor, size: int) -> torch.Tensor:
    """``img[b, :, t:t + size, l:l + size]`` for each image b at offsets[b] =
    (t, l), as one gather on img's device; offsets must keep the crop
    inside the image."""
    b, c, h, w = img.shape
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=img.device)
    ar = torch.arange(size, device=img.device)
    rows = offsets[:, 0:1] + ar
    cols = offsets[:, 1:2] + ar
    flat = (rows[:, :, None] * w + cols[:, None, :]).view(b, 1, size * size)
    return img.reshape(b, c, h * w).gather(2, flat.expand(b, c, size * size)).view(
        b, c, size, size)


def crop_pair_batch(x: torch.Tensor, y: torch.Tensor, *, size: int, xy_size_ratio: int = 1,
                    offsets: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Per-image aligned crops of a batch (B, C, H, W) -> (x_crop, y_crop):
    y cropped ``size`` at ``offsets``, x ``size * xy_size_ratio`` at
    ``offsets * xy_size_ratio``.

    ``offsets`` (B, 2) are (top, left) on y; without them they are drawn
    from ``generator`` over the padded y.
    """
    r = int(xy_size_ratio)
    x = pad_min_size(x, size * r, size * r)
    y = pad_min_size(y, size, size)
    b, _, h, w = y.shape
    if offsets is None:
        def full(n):
            return torch.full((b,), n, dtype=torch.int64, device=generator.device)

        offsets = crop_offsets(generator, full(h), full(w), size)
    offsets = torch.as_tensor(offsets, dtype=torch.int64, device=y.device)
    return (crop_batch(x, offsets if r == 1 else offsets * r, size * r),
            crop_batch(y, offsets, size))
