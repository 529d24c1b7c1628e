"""Spectral (circular) convolution with ``torch.fft`` (cuFFT on the GPU).

Counterpart of ``sei_tpu/ops/fft_conv.py``: the OTF is the PSF embedded at
the origin and rolled by -(k//2) per axis, so measurements match the JAX
package to f32 roundoff.  The JAX package left these to XLA, so the port
leaves them to cuFFT: no hand-written kernel belongs here.  The CT-like
task's separable ramp filter (:func:`ct_like_filter`) is here too.
"""

from __future__ import annotations

import torch


def psf_to_otf(kernel: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """rfft2 of the (kh, kw) PSF placed top-left and rolled by -(k//2)."""
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    psf = torch.zeros(shape, dtype=kernel.dtype, device=kernel.device)
    psf[:kh, :kw] = kernel.reshape(kh, kw)
    psf = torch.roll(psf, (-(kh // 2), -(kw // 2)), dims=(-2, -1))
    return torch.fft.rfft2(psf, dim=(-2, -1))


def blur_circular(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Circular blur y = k (*) x over the last two axes."""
    shape = tuple(x.shape[-2:])
    otf = psf_to_otf(kernel.to(x.dtype), shape)
    xf = torch.fft.rfft2(x, dim=(-2, -1))
    return torch.fft.irfft2(otf * xf, s=shape, dim=(-2, -1))


def blur_circular_adjoint(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`blur_circular`: multiplication by conj(OTF)."""
    shape = tuple(y.shape[-2:])
    otf = psf_to_otf(kernel.to(y.dtype), shape)
    yf = torch.fft.rfft2(y, dim=(-2, -1))
    return torch.fft.irfft2(torch.conj(otf) * yf, s=shape, dim=(-2, -1))


def inverse_filter(y: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Exact spectral deconvolution x = F^-1(F(y) / OTF)."""
    shape = tuple(y.shape[-2:])
    otf = psf_to_otf(kernel.to(y.dtype), shape)
    yf = torch.fft.rfft2(y, dim=(-2, -1))
    return torch.fft.irfft2(yf / otf, s=shape, dim=(-2, -1))


def _ramp_filter_1d(x: torch.Tensor, dim: int, eps: float, inverse: bool) -> torch.Tensor:
    """The spectrum along ``dim`` times (k + eps) (or its inverse), k the
    rfft frequency index; ``irfft`` takes the axis length, so odd sizes
    round-trip."""
    n = x.shape[dim]
    xf = torch.fft.rfft(x, dim=dim)
    otf = torch.arange(xf.shape[dim], dtype=x.dtype, device=x.device) + eps
    if inverse:
        otf = 1.0 / otf
    shape = [1] * x.dim()
    shape[dim] = -1
    return torch.fft.irfft(xf * otf.reshape(shape), n=n, dim=dim)


def ct_like_filter(x: torch.Tensor, *, eps: float = 1.0, inverse: bool = True) -> torch.Tensor:
    """Separable spectral ramp filter along H, then W
    (``sei_tpu/ops/fft_conv.py:62-84``).  ``inverse=True`` is the CT-like
    task's forward operator A (each axis' spectrum over (k + eps)), and
    ``inverse=False`` its exact pseudo-inverse."""
    x = _ramp_filter_1d(x, -2, eps, inverse)
    return _ramp_filter_1d(x, -1, eps, inverse)
