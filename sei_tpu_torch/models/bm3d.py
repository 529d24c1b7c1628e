"""BM3D denoising and BM3D-DEB deblurring (counterpart of
``sei_tpu/models/bm3d.py``, the JAX package's from-scratch version of Dabov
et al. 2007/2008, not the Tampere binary the reference wraps).

Per image plane: reflect-pad by search + patch; on a stride-4 grid of
reference 8x8 patches, match each against the 81 candidates of a 9x9 grid
of offsets (step 3) within +-12 px by their SSD to the pilot's patch, keep
the 8 closest, 2-D DCT per patch + Haar across the group, hard-threshold
(stage 1) or Wiener-shrink against the stage-1 pilot (stage 2), invert,
and aggregate the weighted patches.  Deblurring: a regularized inverse in
Fourier, then both stages at the inverse's effective noise level.

Vectorised over every plane, reference and candidate at once:

- the block matching is one gather of every (reference, candidate) patch
  of the pilot, their SSDs summed in float64 (so the ranking is the same on
  any device, bar exact ties), and a stable sort, which keeps the lower
  candidate first on a tie, as ``lax.top_k`` does;
- the aggregation is deterministic, with no atomics: for each of the 81
  offsets in turn, one ``F.fold`` (col2im, a gather per output pixel) of
  the weighted patches that chose it over the stride grid, added into the
  numerator and the denominator.  The JAX loop adds patch by patch in a
  fixed order; the sums here come in another fixed order, so the two agree
  to f32 roundoff and the port repeats itself bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fft_conv import psf_to_otf

PATCH, STRIDE, SEARCH, GROUP = 8, 4, 12, 8


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n, n), float64."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    m[0] /= math.sqrt(2.0)
    return m


def haar_matrix(n: int) -> np.ndarray:
    """Orthonormal Haar transform for the group axis (n a power of 2),
    float64."""
    if n & (n - 1):
        raise ValueError(f"Haar transform of {n}: not a power of 2")
    m = np.array([[1.0]])
    while m.shape[0] < n:
        m = np.vstack([np.kron(m, [1.0, 1.0]), np.kron(np.eye(m.shape[0]), [1.0, -1.0])])
        m /= math.sqrt(2.0)
    return m


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """numpy's ``reflect`` pad of 0..n-1 by ``pad`` on both sides, repeated
    as far as needed (``F.pad`` needs pad < n)."""
    return np.pad(np.arange(n), pad, mode="reflect")


def bm3d_denoise(z: torch.Tensor, sigma, *, patch: int = PATCH, stride: int = STRIDE,
                 search: int = SEARCH, k: int = GROUP, two_stage: bool = True) -> torch.Tensor:
    """BM3D of (..., H, W) planes in [0, 1], each on its own, in their
    dtype; ``sigma`` a float or a 0-d tensor."""
    *lead, h, w = z.shape
    p, pad, dev = patch, search + patch, z.device
    zp = z.reshape(-1, h, w)
    zp = zp[:, _reflect_index(h, pad)][:, :, _reflect_index(w, pad)]
    ys, xs = np.arange(0, h, stride), np.arange(0, w, stride)
    ref = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2) + pad  # (R, 2)
    steps = np.arange(-search, search + 1, 3)
    offs = np.stack(np.meshgrid(steps, steps, indexing="ij"), -1).reshape(-1, 2)  # (C, 2)
    ar = np.arange(p)
    # (R, C, p) rows and columns of every candidate patch
    rows = torch.as_tensor(ref[:, None, 0, None] + offs[None, :, 0, None] + ar, device=dev)
    cols = torch.as_tensor(ref[:, None, 1, None] + offs[None, :, 1, None] + ar, device=dev)
    offs_t = torch.as_tensor(offs, device=dev)
    dct = torch.as_tensor(dct_matrix(p), dtype=z.dtype, device=dev)
    haar = torch.as_tensor(haar_matrix(k), dtype=z.dtype, device=dev)
    zero = int(np.flatnonzero((offs == 0).all(1))[0])

    def patches(img, r, c):  # (N, Hp, Wp) at (R, C', p) rows/cols -> (N, R, C', p, p)
        return img[:, r[..., :, None], c[..., None, :]]

    def select(pilot):
        cand = patches(pilot, rows, cols).double()
        ssd = ((cand - cand[:, :, zero:zero + 1]) ** 2).sum((-2, -1))
        return torch.sort(ssd, dim=-1, stable=True).indices[..., :k]  # (N, R, k)

    def group(img, sel):
        n = img.shape[0]
        r = rows.expand(n, -1, -1, -1).gather(2, sel[..., None].expand(-1, -1, -1, p))
        c = cols.expand(n, -1, -1, -1).gather(2, sel[..., None].expand(-1, -1, -1, p))
        return img[torch.arange(n, device=dev)[:, None, None, None, None],
                   r[..., :, None], c[..., None, :]]

    def transform(grp):  # 2-D DCT per patch, then Haar across the group
        return torch.einsum("gk,...kad->...gad", haar, dct @ grp @ dct.T)

    def itransform(coef):
        return dct.T @ torch.einsum("kg,...gad->...kad", haar.T, coef) @ dct

    def aggregate(ests, wgts, sel, img):
        """Sum of the weighted patch estimates over the padded plane, offset
        by offset (module docstring)."""
        n = img.shape[0]
        num, den = torch.zeros_like(img), torch.zeros_like(img)
        span = ((len(ys) - 1) * stride + p, (len(xs) - 1) * stride + p)
        ones = torch.ones(p * p, device=dev, dtype=img.dtype)
        for ci, (dy, dx) in enumerate(offs):
            chose = (sel == ci).to(img.dtype)  # (N, R, k), at most one 1 per row
            est = torch.einsum("nrk,nrkab->nrab", chose, ests) * wgts[..., None, None]
            wgt = chose.sum(-1) * wgts  # (N, R)
            cols_ = torch.cat([est.reshape(n, -1, p * p),
                               wgt[..., None] * ones], 0).transpose(1, 2)
            canvas = F.fold(cols_, span, p, stride=stride)[:, 0]  # (2N, *span)
            y0, x0 = int(ref[0, 0] + dy), int(ref[0, 1] + dx)
            num[:, y0:y0 + span[0], x0:x0 + span[1]] += canvas[:n]
            den[:, y0:y0 + span[0], x0:x0 + span[1]] += canvas[n:]
        return torch.where(den > 0, num / torch.clamp(den, min=1e-8), img)

    def stage(img, pilot, wiener):
        sel = select(pilot)
        coef = transform(group(img, sel))
        if not wiener:
            keep = coef.abs() > 2.7 * sigma
            coef = torch.where(keep, coef, torch.zeros_like(coef))
            wgt = 1.0 / (keep.sum((-3, -2, -1)).to(img.dtype) + 1.0)
        else:
            pcoef = transform(group(pilot, sel))
            shrink = pcoef**2 / (pcoef**2 + sigma**2)
            coef = coef * shrink
            wgt = 1.0 / ((shrink**2).sum((-3, -2, -1)) * sigma**2 + 1e-8)
        return aggregate(itransform(coef), wgt, sel, img)

    out = stage(zp, zp, False)
    if two_stage:
        out = stage(zp, out, True)
    return out[:, pad:pad + h, pad:pad + w].reshape(*lead, h, w)


def bm3d_rgb(z: torch.Tensor, sigma, **kw) -> torch.Tensor:
    """BM3D of each channel of (C, H, W) (or (B, C, H, W)) on its own."""
    return bm3d_denoise(z, sigma, **kw)


def bm3d_deblur(y: torch.Tensor, kernel: torch.Tensor, sigma: float,
                reg: float = 4e-3) -> torch.Tensor:
    """BM3D-DEB, simplified: the regularized inverse conj(K) / (|K|^2 + reg)
    of the (B, C, H, W) measurement, clipped to [-0.5, 1.5], then BM3D of
    every plane at sigma times the inverse's noise gain
    sqrt(mean(|ri|^2))."""
    shape = tuple(y.shape[-2:])
    otf = psf_to_otf(kernel.to(y.dtype), shape)
    ri = torch.conj(otf) / (otf.abs() ** 2 + reg)
    x_ri = torch.fft.irfft2(ri * torch.fft.rfft2(y, dim=(-2, -1)), s=shape, dim=(-2, -1))
    sigma_eff = sigma * torch.sqrt(torch.mean(ri.abs() ** 2))
    return bm3d_rgb(torch.clamp(x_ri, -0.5, 1.5), sigma_eff)


def bm3d_model(physics, *, sigma_psd: float):
    """The BM3D model kind: deblurring only."""
    if physics.task != "deblurring":
        raise ValueError("the BM3D baseline is for deblurring")
    return lambda y: bm3d_deblur(y, physics.kernel, sigma_psd)
