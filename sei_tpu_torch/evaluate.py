"""The evaluation protocol: counterpart of ``demo/test.py`` (:130-243) and
``sei_tpu/train/validate.py`` (:22-78).

For each ground-truth image: seeded degradation of the whole image (for SR
the ground truth is then cut to the measurement's size times the rate),
reflect-pad the measurement to a multiple of ``pad_bucket`` (64; a model
with nothing trained, such as ``Identity`` or ``Upsample``, runs at the
measurement's own size), restore, crop back to the measurement's size times
the model's ``scale``, 8-bit quantize and clamp both images, then Y-channel
PSNR and SSIM.  A trainable model's measurement of more than
``eval_tile_height`` rows (768) is restored by halo strips instead
(:func:`sei_tpu_torch.parallel.tiling.tiled_apply`, ``demo/test.py:157-167``):
``max(2, ceil(h / 768))`` strips, a halo of ``min(64, (h - strip) // 2)``
rows, the strips unpadded (SwinIR pads them to its window itself); any
other model runs whole at any height.

The test command line's wrappers (``demo/test.py:179-205``):
:func:`eval_apply` with ``noise2inverse`` restores through the
Noise2Inverse ensemble (:mod:`sei_tpu_torch.noise2inverse`), and
:func:`r2r_average` is ``--r2r``'s mean of ``itercount`` restorations of
y + sigma / 2 * n, n drawn from one generator through the whole eval.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from .metrics import compute_metrics, quantize_and_clamp
from .models.swinir import reflect_pad
from .noise2inverse import noise2inverse_model
from .parallel.tiling import tiled_apply

EVAL_TILE_HEIGHT = 768  # the JAX package's --eval_tile_height default


@dataclasses.dataclass
class EvalResult:
    psnr: list
    ssim: list
    lpips: list = dataclasses.field(default_factory=list)  # NaN without LPIPS weights

    @property
    def psnr_mean(self) -> float:
        return float(np.mean(self.psnr))

    @property
    def ssim_mean(self) -> float:
        return float(np.mean(self.ssim))


def tile_plan(h: int, eval_tile_height: int = EVAL_TILE_HEIGHT) -> tuple[int, int]:
    """(strips, halo) of ``demo/test.py:162-164`` for a measurement of ``h``
    rows."""
    n_tiles = max(2, -(-h // eval_tile_height))
    strip = -(-h // n_tiles)
    return n_tiles, min(64, (h - strip) // 2)


def restore(model, y: torch.Tensor, *, pad_bucket: int = 64,
            eval_tile_height: int = EVAL_TILE_HEIGHT) -> torch.Tensor:
    """Model output for a (B, 3, h, w) measurement: a trainable model's
    input reflect-padded up to a multiple of ``pad_bucket`` (0: not padded;
    a model with ``trainable`` False is never padded), the output cropped
    back to (h * scale, w * scale) (``scale``: the model's, default 1).  A
    trainable model with ``pad_bucket`` > 0 restores a single measurement
    of more than ``eval_tile_height`` rows by halo strips (:func:`tile_plan`),
    unpadded, as ``demo/test.py:157-167`` does."""
    h, w = y.shape[-2:]
    f = getattr(model, "scale", 1)
    if pad_bucket > 0 and getattr(model, "trainable", True):
        if h > eval_tile_height:
            n_tiles, halo = tile_plan(h, eval_tile_height)
            return tiled_apply(model, y, n_tiles=n_tiles, halo=halo, out_scale=f)
        y = reflect_pad(y, (-h) % pad_bucket, (-w) % pad_bucket)
    return model(y)[..., :h * f, :w * f]


def eval_apply(model, physics=None, *, pad_bucket: int = 64,
               eval_tile_height: int = EVAL_TILE_HEIGHT,
               noise2inverse: bool = False) -> Callable:
    """The restoration of a (B, 3, h, w) measurement: :func:`restore`, or
    with ``noise2inverse`` the Noise2Inverse ensemble of it (4 row combs,
    each backprojected by the physics' inverse filter or ``A_dagger``)."""
    def apply(y):
        return restore(model, y, pad_bucket=pad_bucket, eval_tile_height=eval_tile_height)

    if not noise2inverse:
        return apply
    return noise2inverse_model(apply, task=physics.task, kernel=physics.kernel,
                               degradation_inverse_fn=physics.A_dagger)


def r2r_average(apply: Callable, y: torch.Tensor, *, sigma: float, itercount: int,
                generator: Optional[torch.Generator] = None,
                normals: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """``--r2r``: the mean of ``itercount`` restorations of y + 0.5 * pert,
    pert = sigma * N(0, I) of y's shape drawn from ``generator`` (on y's
    device) for each, or taken from ``normals`` (the N(0, I) draws)."""
    acc = None
    for t in range(itercount):
        n = (torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)
             if normals is None else normals[t])
        out = apply(y + 0.5 * (sigma * n))
        acc = out if acc is None else acc + out
    return acc / itercount


def score_pair(model, x, y, *, pad_bucket: int = 64,
               eval_tile_height: int = EVAL_TILE_HEIGHT, apply: Optional[Callable] = None,
               lpips=None):
    """(PSNR, SSIM, LPIPS, quantized estimate (3, H, W)) of one (ground
    truth, measurement) pair, each (3, H, W); ``apply`` (a batch
    restoration, such as :func:`eval_apply`'s) in place of :func:`restore`;
    ``lpips`` as :func:`~sei_tpu_torch.metrics.compute_metrics` takes it
    (None: NaN)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=model.device)
    if apply is None:
        apply = eval_apply(model, pad_bucket=pad_bucket, eval_tile_height=eval_tile_height)
    x_hat = quantize_and_clamp(apply(y[None]))[0]
    p, s, d = compute_metrics(quantize_and_clamp(x), x_hat, lpips=lpips)
    return p, s, d, x_hat


def evaluate_pairs(model, pairs: Iterable, *, pad_bucket: int = 64,
                   eval_tile_height: int = EVAL_TILE_HEIGHT) -> EvalResult:
    """Score (ground truth (3, H, W), measurement (3, H, W)) pairs."""
    psnrs, ssims = [], []
    for x, y in pairs:
        p, s = score_pair(model, x, y, pad_bucket=pad_bucket,
                          eval_tile_height=eval_tile_height)[:2]
        psnrs.append(p)
        ssims.append(s)
    return EvalResult(psnrs, ssims)


def degraded_pair(physics, x: torch.Tensor, seed: Optional[int], *,
                  even: bool = False):
    """(ground truth, measurement) of a (3, H, W) image: the whole image
    degraded with ``seed``, then the ground truth cut to the measurement's
    size times the SR rate (``demo/test.py:100-121``); ``even`` (the
    Noise2Inverse eval of deblurring) cuts both to even sizes."""
    y = physics.randomly_degrade(x[None], seed)[0]
    rate = physics.rate if physics.task == "sr" else 1
    x = x[..., : y.shape[-2] * rate, : y.shape[-1] * rate]
    if even:
        y = y[..., : 2 * (y.shape[-2] // 2), : 2 * (y.shape[-1] // 2)]
        x = x[..., : y.shape[-2] * rate, : y.shape[-1] * rate]
    return x, y


def evaluate(model, physics, images: Sequence, *, pad_bucket: int = 64,
             eval_tile_height: int = EVAL_TILE_HEIGHT,
             seeds: Optional[Sequence[int]] = None) -> EvalResult:
    """Degrade each (3, H, W) image with its seed (default: its index), then
    restore and score it as :func:`evaluate_pairs` does."""
    seeds = range(len(images)) if seeds is None else seeds

    def pairs():
        for x, seed in zip(images, seeds):
            x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
            yield degraded_pair(physics, x, seed)

    return evaluate_pairs(model, pairs(), pad_bucket=pad_bucket,
                          eval_tile_height=eval_tile_height)
