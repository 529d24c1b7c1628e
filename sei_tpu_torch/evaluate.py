"""The evaluation protocol: counterpart of ``demo/test.py`` (:130-243) and
``sei_tpu/train/validate.py`` (:22-78).

For each ground-truth image: seeded degradation, reflect-pad the measurement
to a multiple of ``pad_bucket`` (64), restore, crop back, 8-bit quantize and
clamp both images, then Y-channel PSNR and SSIM.  Strip tiling above
``MAX_EVAL_HEIGHT`` rows (the reference's ``eval_tile_height``) is not ported
yet; such images raise.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .metrics import compute_metrics, quantize_and_clamp
from .models.swinir import reflect_pad

MAX_EVAL_HEIGHT = 768


@dataclasses.dataclass
class EvalResult:
    psnr: list
    ssim: list

    @property
    def psnr_mean(self) -> float:
        return float(np.mean(self.psnr))

    @property
    def ssim_mean(self) -> float:
        return float(np.mean(self.ssim))


def restore(model, y: torch.Tensor, *, pad_bucket: int = 64) -> torch.Tensor:
    """Model output for a (B, 3, h, w) measurement, reflect-padded up to a
    multiple of ``pad_bucket`` and cropped back to (h, w)."""
    h, w = y.shape[-2:]
    if h > MAX_EVAL_HEIGHT:
        raise NotImplementedError(
            f"{h} rows > {MAX_EVAL_HEIGHT}: strip tiling is not ported yet "
            "(ROADMAP, Queue 1: eval at large sizes)")
    y = reflect_pad(y, (-h) % pad_bucket, (-w) % pad_bucket)
    return model(y)[..., :h, :w]


def evaluate_pairs(model, pairs: Iterable, *, pad_bucket: int = 64) -> EvalResult:
    """Score (ground truth (3, H, W), measurement (3, H, W)) pairs."""
    psnrs, ssims = [], []
    for x, y in pairs:
        x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=model.device)
        x_hat = quantize_and_clamp(restore(model, y[None], pad_bucket=pad_bucket))[0]
        p, s, _ = compute_metrics(quantize_and_clamp(x), x_hat)
        psnrs.append(p)
        ssims.append(s)
    return EvalResult(psnrs, ssims)


def evaluate(model, physics, images: Sequence, *, pad_bucket: int = 64,
             seeds: Optional[Sequence[int]] = None) -> EvalResult:
    """Degrade each (3, H, W) image with its seed (default: its index), then
    restore and score it as :func:`evaluate_pairs` does."""
    seeds = range(len(images)) if seeds is None else seeds

    def pairs():
        for x, seed in zip(images, seeds):
            x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
            yield x, physics.randomly_degrade(x[None], seed)[0]

    return evaluate_pairs(model, pairs(), pad_bucket=pad_bucket)
