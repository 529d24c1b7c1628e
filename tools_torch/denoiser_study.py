#!/usr/bin/env python
"""The denoiser priors' spread over trainings, on one GPU.

``FULL_RUN_TASK=denoisers bash full_run_torch.sh`` trains one DRUNet
(``cli.train_drunet`` at the JAX script's defaults, seed 0) and scores
PlugAndPlay, DiffPIR_DRUNet and DPS with it on the first five validation
images of the dead-leaves Div2K stand-in, beside the JAX package's scores
from its own trainings on a TPU.  This script trains the same recipe again
in variants and scores each the same way (``cli.test``, in this process):

* ``seed S``: the port's recipe from seed S (seed 0 repeats the full run's
  training, which should give its loss lines again);
* ``bf16 S``: seed S with every DRUNet convolution's operands rounded to
  bf16 before an f32 product (forward, and the backward's products through
  the casts' gradients), as a TPU's default-precision f32 convolution
  multiplies them (the JAX DRUNet sets no precision); scored with f32
  convolutions and again with bf16 operands.

Each trained DRUNet is also probed: its denoising MSE on 64 seeded 64 px
validation crops at fixed noise levels (and MSE / sigma^2), and the
recipe's loss averaged over ``--probe_batches`` training batches drawn as
the trainer draws them, which the trainers' single-batch loss lines can
only sample.  One line per result, beside the card's name and power limit.

    python tools_torch/denoiser_study.py --datasets_dir _full_run/datasets \\
        --out_dir _full_run/study --variants "seed 0" "seed 1" "bf16 0"
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sei_tpu_torch.bench import nvidia_smi  # noqa: E402
from sei_tpu_torch.cli import test as cli_test  # noqa: E402
from sei_tpu_torch.cli import train_drunet  # noqa: E402
from sei_tpu_torch.data import GroundTruthDataset  # noqa: E402
from sei_tpu_torch.train import denoisers as dn  # noqa: E402

KINDS = ("PlugAndPlay", "DiffPIR_DRUNet", "DPS")
PROBE_SIGMAS = (5, 10, 15, 25, 35, 50)  # / 255
PROBE_CROPS, CROP = 64, 64


@contextlib.contextmanager
def bf16_operands(on: bool):
    """Every ``nn.Conv2d`` / ``nn.ConvTranspose2d`` multiplies bf16-rounded
    operands while ``on`` (sums stay f32)."""
    if not on:
        yield
        return

    def r(t):
        return t.to(torch.bfloat16).to(t.dtype)

    conv_fwd, tconv_fwd = nn.Conv2d._conv_forward, nn.ConvTranspose2d.forward

    def conv(self, x, w, b):
        return conv_fwd(self, r(x), r(w), b)

    def tconv(self, x, output_size=None):
        return F.conv_transpose2d(r(x), r(self.weight), self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)

    nn.Conv2d._conv_forward, nn.ConvTranspose2d.forward = conv, tconv
    try:
        yield
    finally:
        nn.Conv2d._conv_forward, nn.ConvTranspose2d.forward = conv_fwd, tconv_fwd


@torch.no_grad()
def probe(net, val: dn.CropCache, train: dn.CropCache, batches: int) -> str:
    gen = torch.Generator(device="cuda").manual_seed(12345)
    x = dn.sample_crops(val, PROBE_CROPS, CROP, gen)
    parts = []
    for s in PROBE_SIGMAS:
        sigma = s / 255.0
        y = x + sigma * torch.randn(x.shape, generator=gen, device=x.device)
        mse = float(torch.mean((net(y, sigma) - x) ** 2))
        parts.append(f"{s}: {mse:.3e} ({mse / sigma**2:.3f})")
    losses = [dn.drunet_loss(net, *dn.drunet_draws(train, gen, batch=16, crop=CROP,
                                                   sigma_max=55.0 / 255.0,
                                                   sigma_dist="uniform"), False)
              for _ in range(batches)]
    mean = float(torch.stack(losses).mean())
    return (f"val MSE (MSE / sigma^2) at sigma*255 {'; '.join(parts)}; the recipe's loss over "
            f"{batches} training batches {mean:.4e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--variants", nargs="+", default=["seed 0", "seed 1", "bf16 0"])
    ap.add_argument("--probe_batches", type=int, default=200)
    args = ap.parse_args()
    smi = nvidia_smi()
    os.makedirs(args.out_dir, exist_ok=True)
    val = dn.load_cache(GroundTruthDataset("div2k", datasets_dir=args.datasets_dir,
                                           split="val").load_all(), "cuda")
    train = dn.load_cache(GroundTruthDataset("div2k", datasets_dir=args.datasets_dir,
                                             split="train").load_all(), "cuda")
    for variant in args.variants:
        kind, seed = variant.split()
        bf16 = kind == "bf16"
        path = os.path.join(args.out_dir, f"drunet_{kind}{seed}.npz")
        t0 = time.perf_counter()
        with bf16_operands(bf16), contextlib.redirect_stdout(io.StringIO()) as log:
            net, logged = train_drunet.main(["--datasets_dir", args.datasets_dir, "--out", path,
                                             "--seed", seed])
        rate = [line for line in log.getvalue().splitlines() if line.startswith("trained")]
        print(f"{variant}: loss lines {[f'{v:.3e}' for _, v in logged]}; {rate[0]}", flush=True)
        net.eval()
        with bf16_operands(bf16):
            print(f"{variant}: {probe(net, val, train, args.probe_batches)}; {smi}", flush=True)
        del net
        for eval_bf16 in ((False, True) if bf16 else (False,)):
            scores = []
            for kind_ in KINDS:
                argv = ["--task", "deblurring", "--kernel", "Gaussian_R2", "--noise_level", "5",
                        "--dataset", "div2k", "--GroundTruthDataset__datasets_dir",
                        args.datasets_dir, "--model_kind", kind_, "--indices", "0,1,2,3,4"]
                os.environ["SEI_DRUNET_WEIGHTS"] = path
                with bf16_operands(eval_bf16), contextlib.redirect_stdout(io.StringIO()):
                    got = cli_test.main(argv)
                scores.append(f"{kind_} {np.mean(got.psnr):.2f} / {np.mean(got.ssim):.4f}")
            print(f"{variant}, scored with {'bf16-operand' if eval_bf16 else 'f32'} convolutions "
                  f"(val images 0-4): {'; '.join(scores)}; {time.perf_counter() - t0:.1f} s "
                  f"since its training began; {smi}", flush=True)


if __name__ == "__main__":
    main()
