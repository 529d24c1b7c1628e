"""Bicubic image resize as two matrix products (counterpart of
``sei_tpu/ops/resize.py``).

  * :func:`resize`: ``interpolate(mode="bicubic")`` to an explicit size or
    by a scale factor, antialias on or off;
  * :func:`resize_shorter_side`: torchvision's ``resize(size=int)``, the
    ground truth's shorter-side resize;
  * :func:`resize_transpose`: the exact transpose of :func:`resize` (the SR
    physics' true adjoint, ``jax.linear_transpose`` of the resize in the JAX
    package);
  * :func:`resize_np`, :func:`resize_shorter_side_np`: the same on the host
    (numpy), for the datasets.

Layout (..., H, W).  The per-axis matrices come from
:func:`~sei_tpu_torch.ops.bicubic.resize_matrix` (numpy f64 rounded to f32,
then cast to the image's dtype, as the JAX package casts); on a device they are built once per shape and kept
(:func:`matrix`), so a captured step finds them there.  The JAX package left
these products to XLA, outside any Pallas kernel: here they are two
``torch.einsum`` calls (cuBLAS on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bicubic import output_size_for_scale, resize_matrix, shorter_side_sizes


def _sizes(h: int, w: int, size, scale_factor):
    """(out_h, out_w, scale_h, scale_w) of a resize by size or by factor."""
    if (size is None) == (scale_factor is None):
        raise ValueError("pass exactly one of size / scale_factor")
    if scale_factor is not None:
        return (output_size_for_scale(h, scale_factor), output_size_for_scale(w, scale_factor),
                1.0 / scale_factor, 1.0 / scale_factor)
    out_h, out_w = size
    return out_h, out_w, h / out_h, w / out_w


@functools.lru_cache(maxsize=None)
def matrix(in_size: int, out_size: int, antialias: bool, scale: float,
           device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`resize_matrix` as a tensor on ``device``; built once per
    argument set (a CUDA graph cannot copy from the host)."""
    m = resize_matrix(in_size, out_size, antialias=antialias, scale=scale)  # f32, as JAX casts
    return torch.as_tensor(m, device=device).to(dtype)


def _matrices(h: int, w: int, size, scale_factor, antialias: bool, like: torch.Tensor):
    """The (out_h, h) and (out_w, w) matrices of a resize of an (h, w) image
    on ``like``'s device and dtype; None where the resize is the identity."""
    out_h, out_w, scale_h, scale_w = _sizes(h, w, size, scale_factor)
    if (out_h, out_w) == (h, w) and scale_h == 1.0 and scale_w == 1.0:
        return None
    return (matrix(h, out_h, antialias, scale_h, like.device, like.dtype),
            matrix(w, out_w, antialias, scale_w, like.device, like.dtype))


def resize(x: torch.Tensor, *, size: tuple[int, int] | None = None,
           scale_factor: float | None = None, antialias: bool = False) -> torch.Tensor:
    """Bicubic resize of the last two axes, torch ``interpolate``'s
    semantics; exactly one of ``size`` / ``scale_factor``."""
    mats = _matrices(*x.shape[-2:], size, scale_factor, antialias, x)
    if mats is None:
        return x
    wh, ww = mats
    x = torch.einsum("oh,...hw->...ow", wh, x)
    return torch.einsum("ow,...hw->...ho", ww, x)


def resize_transpose(y: torch.Tensor, in_size: tuple[int, int], *,
                     size: tuple[int, int] | None = None, scale_factor: float | None = None,
                     antialias: bool = False) -> torch.Tensor:
    """The transpose of :func:`resize` from an ``in_size`` image, applied to
    ``y`` (its output's shape): ``W_h^T y W_w``, so ``<resize(x), y> = <x,
    resize_transpose(y)>``."""
    mats = _matrices(*in_size, size, scale_factor, antialias, y)
    if mats is None:
        return y
    wh, ww = mats
    y = torch.einsum("oh,...ow->...hw", wh, y)
    return torch.einsum("ow,...ho->...hw", ww, y)


def resize_shorter_side(x: torch.Tensor, size: int, *, antialias: bool = True) -> torch.Tensor:
    """torchvision ``resize(x, size=int, BICUBIC, antialias=True)``."""
    h, w = x.shape[-2:]
    out = shorter_side_sizes(h, w, size)
    if out == (h, w):
        return x
    return resize(x, size=out, antialias=antialias)


def resize_np(x: np.ndarray, *, size: tuple[int, int] | None = None,
              scale_factor: float | None = None, antialias: bool = False) -> np.ndarray:
    """Numpy twin of :func:`resize` (matrices in the image's dtype): the
    columns as one 2-D BLAS product over every row, then the rows.  The JAX
    package's two ``np.einsum`` calls run numpy's own loops, two orders of
    magnitude slower at DIV2K sizes; the sums run in another order (the
    results agree to ~1e-7)."""
    h, w = x.shape[-2:]
    out_h, out_w, scale_h, scale_w = _sizes(h, w, size, scale_factor)
    wh = resize_matrix(h, out_h, antialias=antialias, scale=scale_h).astype(x.dtype)
    ww = resize_matrix(w, out_w, antialias=antialias, scale=scale_w).astype(x.dtype)
    cols = np.ascontiguousarray(x).reshape(-1, w) @ ww.T
    return np.matmul(wh, cols.reshape(*x.shape[:-2], h, out_w))


def resize_shorter_side_np(x: np.ndarray, size: int, *, antialias: bool = True) -> np.ndarray:
    """Numpy twin of :func:`resize_shorter_side`."""
    h, w = x.shape[-2:]
    out = shorter_side_sizes(h, w, size)
    if out == (h, w):
        return x
    return resize_np(x, size=out, antialias=antialias)
