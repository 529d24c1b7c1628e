"""In-training validation (counterpart of ``sei_tpu/train/validate.py``).

Every ``eval_interval`` epochs the trainer scores the val split with the
test protocol (each image degraded with its own seed, for SR the ground
truth cut to the measurement's size times the rate, reflect-pad to the 64
bucket, 8-bit quantize and clamp, Y PSNR/SSIM: the pairs and the scores of
``python -m sei_tpu_torch.cli.test``), appends the means to
``validation.csv`` and keeps the best-PSNR state as ``checkpoints/ckp_best.pt``.

The hook runs eagerly between the step's CUDA-graph replays, in the model's
own compute dtype, with the module in eval mode (no drop-path, so no
training stream moves) and back in training mode afterwards.  Its
measurements are made once, at construction.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data import image_seed
from ..evaluate import degraded_pair, evaluate_pairs


class ValidationHook:
    """``hook(model) -> (mean PSNR, mean SSIM)`` over a frozen val set.

    ``gt``: the val split (a :class:`~sei_tpu_torch.data.GroundTruthDataset`);
    ``max_images`` caps how many of its first images are used.  The pairs
    live on the physics' device."""

    def __init__(self, gt, physics, *, max_images: Optional[int] = None):
        n = len(gt) if max_images is None else min(len(gt), max_images)
        self.pairs = [
            degraded_pair(physics, torch.as_tensor(gt[i], dtype=torch.float32,
                                                   device=physics.device),
                          image_seed(0, gt.unique_id(i)))
            for i in range(n)]

    def __len__(self) -> int:
        return len(self.pairs)

    def __call__(self, model) -> tuple[float, float]:
        module = model.module
        training = module.training
        module.eval()
        try:
            result = evaluate_pairs(model, self.pairs)
        finally:
            module.train(training)
        return result.psnr_mean, result.ssim_mean
