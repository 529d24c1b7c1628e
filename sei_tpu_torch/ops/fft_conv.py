"""Spectral (circular) convolution with ``torch.fft`` (cuFFT on the GPU).

Counterpart of ``sei_tpu/ops/fft_conv.py``: the OTF is the PSF embedded at
the origin and rolled by -(k//2) per axis, so measurements match the JAX
package to f32 roundoff.  The JAX package left these to XLA, so the port
leaves them to cuFFT: no hand-written kernel belongs here.
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
