"""Random-scale resampling, the paper's augmentation (counterpart of
``sei_tpu/ops/scaling.py``).

Per-image rate and center: an affine sampling grid ``g = (v - c) / rate + c``
over normalized coordinates, bicubic ``grid_sample`` with reflection padding
and ``align_corners=True``.  The grid is separable, so the sample is
``M_v @ img @ M_u^T`` with per-image (out, in) matrices built from the rates
and centers by four scatter-adds.  The JAX package left these products to
XLA, outside any Pallas kernel; here they are one ``torch.einsum``
(cuBLAS).  Square images only, as the reference's grid is only coherent for
those.

The antialiased kind resizes each image first, by its own rate, with the
antialiased bicubic resize, and samples the small image back to the full
size.  The rates are drawn on the device, so no branch is chosen on the
host: both rates' branches run for the whole batch, and each image takes
its own by a ``torch.where`` on its rate (the JAX package's ``lax.switch``
under ``vmap``).  Shapes stay static, and a CUDA graph holds the step.  The
``normal`` kind (:func:`normal_scaling_transform`) resizes the whole batch
by one fixed rate: the image shrinks.
"""

from __future__ import annotations

import torch

from .bicubic import cubic_weights_from_frac, output_size_for_scale
from .resize import matrix, resize

DEFAULT_RATES = (0.75, 0.5)  # the paper's downscaling rates


def _reflect_coords(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch grid_sample 'reflection' padding with align_corners=True:
    reflect about pixel centers [0, size-1], then clamp."""
    if size == 1:
        return torch.zeros_like(x)
    span = float(size - 1)
    x = x.abs()
    extra = torch.remainder(x, span)
    flips = torch.floor(x / span)
    x = torch.where(torch.remainder(flips, 2.0) == 0.0, extra, span - extra)
    return x.clamp(0.0, span)


def scaling_sample_matrix_1d(n_out: int, n_in: int, rate: torch.Tensor,
                             center: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) bicubic sampling matrices for one axis, one per
    image: output coordinate ``a`` samples the input at normalized
    ``g = (v_a - center) / rate + center``, ``v_a = 2 / n_out * a - 1``,
    unnormalized with align_corners=True over ``n_in`` pixels.

    rate, center: (B,).
    """
    a = torch.arange(n_out, dtype=rate.dtype, device=rate.device)
    v = 2.0 / n_out * a - 1.0
    g = (v[None] - center[:, None]) / rate[:, None] + center[:, None]
    px = (g + 1.0) * 0.5 * (n_in - 1)
    base = torch.floor(px)
    ws = cubic_weights_from_frac(px - base)
    m = torch.zeros((rate.shape[0], n_out, n_in), dtype=rate.dtype, device=rate.device)
    for tap in range(4):
        idx = _reflect_coords(base - 1.0 + tap, n_in).long()
        m.scatter_add_(2, idx[..., None], ws[tap][..., None])
    return m


def _sample(x: torch.Tensor, rates: torch.Tensor, centers: torch.Tensor, n_h: int,
            n_w: int) -> torch.Tensor:
    """(B, C, in_h, in_w) -> (B, C, n_h, n_w): each image sampled on its
    rate's grid around its center."""
    mv = scaling_sample_matrix_1d(n_h, x.shape[-2], rates, centers[:, 1])
    mu = scaling_sample_matrix_1d(n_w, x.shape[-1], rates, centers[:, 0])
    return torch.einsum("boh,bchw,bpw->bcop", mv, x, mu)


def padded_scaling_transform(x: torch.Tensor, rates: torch.Tensor,
                             centers: torch.Tensor, *, antialias: bool = False) -> torch.Tensor:
    """Padded (same-size) random-scale transform of a batch.

    x: (B, C, H, W) with H == W; rates: (B,) per-image downscaling rate, one
    of ``DEFAULT_RATES`` when ``antialias``; centers: (B, 2) per-image (cx,
    cy) in [-1, 1].  ``antialias``: the per-image antialiased pre-resize to
    floor(H * rate) (``sei_tpu/ops/scaling.py:104-127``).
    """
    b, c, h, w = x.shape
    if h != w:
        raise ValueError("the reference grid is only defined for square images")
    if not antialias:
        return _sample(x, rates, centers, h, w)
    out = None
    for r in DEFAULT_RATES:
        ph = matrix(h, output_size_for_scale(h, r), True, 1.0 / r, x.device, x.dtype)
        pw = matrix(w, output_size_for_scale(w, r), True, 1.0 / r, x.device, x.dtype)
        branch = _sample(torch.einsum("oh,bchw,pw->bcop", ph, x, pw), rates, centers, h, w)
        out = branch if out is None else torch.where((rates == r).view(b, 1, 1, 1), branch, out)
    return out


def normal_scaling_transform(x: torch.Tensor, rate: float, *, antialias: bool) -> torch.Tensor:
    """The normal kind: the whole batch bicubic-resized by the fixed ``rate``
    (``sei_tpu/ops/scaling.py:132-141``); the output is floor(size * rate)."""
    return resize(x, scale_factor=rate, antialias=antialias)
