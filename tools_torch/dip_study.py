#!/usr/bin/env python
"""The Deep Image Prior's full-score spread on one GPU.

``FULL_RUN_TASK=baselines bash full_run_torch.sh`` scores the port's DIP
(4000 Adam steps from a latent and decoder drawn from seed 0) on the first
five validation images of the dead-leaves Div2K stand-in at deblurring
Gaussian_R2, noise 5, beside the JAX package's run on a TPU.  This script
restores the same five measurements (``cli.test``'s seeds and scoring)
with other draws, seeds ``--seeds``, and once more from seed 0 with every
convolution's operands rounded to bf16 before an f32 product, as a TPU's
default-precision f32 convolution multiplies them (the JAX DIP sets no
precision).  One line per variant: each image's PSNR / SSIM and the means,
beside the card's name and power limit.

    python tools_torch/dip_study.py --datasets_dir _full_run/datasets --seeds 1 2
"""

from __future__ import annotations

import argparse
import subprocess
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from sei_tpu_torch.data import GroundTruthDataset, image_seed
from sei_tpu_torch.evaluate import degraded_pair, score_pair
from sei_tpu_torch.models import FunctionalModel, baselines
from sei_tpu_torch.physics import get_physics

INDICES = (0, 1, 2, 3, 4)


def bf16_operands():
    """``F`` for :mod:`sei_tpu_torch.models.baselines` whose conv2d rounds
    its input and weight to bf16 (products and sums stay f32)."""
    def conv2d(x, w, b=None, **kw):
        return F.conv2d(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), b, **kw)

    return types.SimpleNamespace(conv2d=conv2d, relu=F.relu)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets_dir", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--iterations", type=int, default=4000)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    physics = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    gt = GroundTruthDataset("div2k", datasets_dir=args.datasets_dir, split="val")
    pairs = [degraded_pair(physics, torch.as_tensor(gt[i], device=physics.device),
                           image_seed(0, gt.unique_id(i))) for i in INDICES]
    solve = baselines.dip_model(physics, iterations=args.iterations)
    variants = [(f"seed {s}", s, False) for s in args.seeds] + [("seed 0, bf16 operands", 0, True)]
    for label, seed, bf16 in variants:
        baselines.F = bf16_operands() if bf16 else F
        t0 = time.perf_counter()

        def fn(y, seed=seed):
            sizes = baselines.conv_decoder_sizes((16, 16), tuple(y.shape[-2:]), 7)
            init = baselines.dip_init(y.shape[0], sizes, device=y.device,
                                      generator=torch.Generator().manual_seed(seed))
            return solve(y, init=init)

        model = FunctionalModel(fn, "DeepImagePrior", physics.device)
        scores = [score_pair(model, x, y)[:2] for x, y in pairs]
        torch.cuda.synchronize()
        p, s = np.array(scores).T
        print(f"DIP {label}, {args.iterations} steps: PSNR {np.round(p, 2).tolist()} mean "
              f"{p.mean():.2f}; SSIM {np.round(s, 4).tolist()} mean {s.mean():.4f}; "
              f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    baselines.F = F


if __name__ == "__main__":
    main()
