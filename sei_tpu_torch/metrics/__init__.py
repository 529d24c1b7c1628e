"""Evaluation metrics: Y-channel PSNR/SSIM (counterpart of
``sei_tpu/metrics/__init__.py``).

kornia ``rgb_to_ycbcr`` channel 0; torchmetrics PSNR (data_range 1) and SSIM
defaults (11x11 Gaussian window, sigma 1.5, k1 0.01, k2 0.03) computed as the
valid-window map averaged over the interior; centre-crop registration; 8-bit
quantize and clamp.  The separable SSIM filter runs as two banded matmuls in
full f32 (TF32 is off on the GPU), as the reference does at HIGHEST
precision: the variance cancellation mu_xx - mu_x^2 breaks at TF32 rounding.
LPIPS needs pretrained weights that are not in the repository and returns
NaN, as in the JAX package without weights.
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """Y channel of YCbCr (kornia convention), x: (..., 3, H, W) in [0, 1]."""
    return 0.299 * x[..., 0, :, :] + 0.587 * x[..., 1, :, :] + 0.114 * x[..., 2, :, :]


def psnr(x_hat: torch.Tensor, x: torch.Tensor, *, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((x_hat - x) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def psnr_y(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return psnr(rgb_to_y(x_hat), rgb_to_y(x))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    dist = np.arange(start=(1 - size) / 2, stop=(1 + size) / 2, step=1, dtype=np.float64)
    g = np.exp(-((dist / sigma) ** 2) / 2)
    return g / g.sum()


def _band(n: int, win: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    k = win.shape[0]
    m = np.zeros((n - k + 1, n), dtype=np.float64)
    for i in range(n - k + 1):
        m[i, i:i + k] = win
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def _sep_valid(img: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    return bh @ img @ bw.T


def ssim(x_hat: torch.Tensor, x: torch.Tensor, *, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Gaussian-window SSIM over the last two axes (torchmetrics defaults)."""
    win = _gaussian_window(kernel_size, sigma)
    bh = _band(x.shape[-2], win, x)
    bw = _band(x.shape[-1], win, x)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _sep_valid(x_hat, bh, bw)
    mu_y = _sep_valid(x, bh, bw)
    mu_xx = _sep_valid(x_hat * x_hat, bh, bw)
    mu_yy = _sep_valid(x * x, bh, bw)
    mu_xy = _sep_valid(x_hat * x, bh, bw)
    sx = mu_xx - mu_x * mu_x
    sy = mu_yy - mu_y * mu_y
    sxy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sx + sy + c2)
    return torch.mean(num / den)


def ssim_y(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ssim(rgb_to_y(x_hat), rgb_to_y(x))


def register(x: torch.Tensor, x_hat: torch.Tensor):
    """Centre-crop both to the common size."""
    hmin = min(x.shape[-2], x_hat.shape[-2])
    wmin = min(x.shape[-1], x_hat.shape[-1])

    def cc(t):
        top = (t.shape[-2] - hmin) // 2
        left = (t.shape[-1] - wmin) // 2
        return t[..., top:top + hmin, left:left + wmin]

    return cc(x), cc(x_hat)


def quantize_and_clamp(im: torch.Tensor) -> torch.Tensor:
    """8-bit quantize (round half to even) then clamp to [0, 1]."""
    return torch.clamp(torch.round(im * 255.0) / 255.0, 0.0, 1.0)


def compute_metrics(x: torch.Tensor, x_hat: torch.Tensor):
    """(psnr, ssim, lpips) as Python floats on registered images."""
    x, x_hat = register(x, x_hat)
    return float(psnr_y(x, x_hat)), float(ssim_y(x, x_hat)), float("nan")
