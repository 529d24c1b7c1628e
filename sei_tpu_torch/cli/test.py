"""Evaluation command line (counterpart of ``demo/test.py``, the same flags).

    python -m sei_tpu_torch.cli.test --task deblurring --kernel Gaussian_R2 \\
        --dataset div2k --weights runs/deblur_r2/weights.pt

Each ground-truth image of the split (``--indices`` a comma-separated
subset) is degraded with its own seed (its unique id, or 0 with
``--no-SyntheticDataset__unique_seeds``; a draw of the global generator
with ``--no-SyntheticDataset__deterministic_measurements``; for ``--task
sr`` the ground truth is then cut to the measurement's size times the
rate), reflect-padded to a
multiple of ``--eval_pad_bucket`` (not for ``Identity`` and ``Upsample``),
restored, cropped to the measurement's size times the model's scale, 8-bit
quantized and scored by Y PSNR/SSIM
(:func:`sei_tpu_torch.evaluate.score_pair`).  A directory given
as ``--dataset`` holds measurements only: they are restored, not scored.
``--save_images`` writes ``ground_truth/``, ``predictors/`` and
``estimates/`` under ``--out_dir``; ``--save_psf`` the PSF scaled to a
maximum of 1.  The summary lines are ``demo/test.py``'s.  LPIPS needs
local AlexNet and head weights (``--lpips_weights``,
:mod:`sei_tpu_torch.metrics.lpips`); without them its line says n/a.  A
trainable model restores a measurement of more than ``--eval_tile_height``
rows (768) by halo strips instead of padding it (``demo/test.py:157-167``,
:func:`sei_tpu_torch.evaluate.restore`); every other kind (``Identity``,
``Upsample`` and the baselines) runs whole at the measurement's own shape.

``--model_kind`` takes every kind of ``sei_tpu_torch.models.KINDS``:
``Proposed`` (``--ProposedModel__architecture Transformer`` or
``Convolutional`` with the ``--ConvolutionalModel__*`` flags),
``Identity``, ``Upsample``, ``InverseFilter``, ``TV`` (``--tv_lambd``,
``--tv_max_iter``), ``DeepImagePrior`` (``--dip_iterations``), ``BM3D``,
and ``PlugAndPlay``, ``DiffPIR_DRUNet``, ``DPS`` (a DRUNet named by
``SEI_DRUNET_WEIGHTS``) and ``DiffPIR_DiffUNet`` (a guided-diffusion UNet
named by ``SEI_DIFFUNET_WEIGHTS``).

``--noise2inverse`` restores through the Noise2Inverse ensemble (4 row
combs, backprojected; for deblurring both images are first cut to even
sizes), ``--r2r --r2r_itercount N`` scores the mean of N restorations of
y + sigma / 2 * n, n from one generator seeded 1 for the whole eval
(``demo/test.py:117-120, 179-205``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import DefaultArgParser, add_test_args
from ..data import FolderDataset, image_seed, write_image
from ..evaluate import EvalResult, degraded_pair, eval_apply, r2r_average, score_pair
from ..metrics import quantize_and_clamp
from ..metrics.lpips import LPIPS
from ..models import get_model
from ..train.checkpoint import get_weights
from .train import conv_blueprint, ground_truth, setup, swinir_overrides


def build(args):
    """(device, physics, model, LPIPS) of the parsed flags: the physics None
    for a folder of measurements, the model's ``--weights`` loaded, the
    LPIPS None without ``--lpips_weights``."""
    device, physics = setup(args, with_physics=not os.path.isdir(args.dataset))
    lpips = LPIPS(args.lpips_weights, device) if args.lpips_weights else None
    model = get_model(kind=args.model_kind, architecture=args.ProposedModel__architecture,
                      task=args.task, sr_factor=args.sr_factor, device=device,
                      homogeneous_swinir=args.homogeneous_swinir,
                      swinir_overrides=swinir_overrides(args), physics=physics,
                      noise_level=args.noise_level, conv_blueprint=conv_blueprint(args),
                      dip_iterations=args.dip_iterations, tv_lambd=args.tv_lambd,
                      tv_max_iter=args.tv_max_iter, kernel_name=args.kernel)
    if args.weights is not None:
        model.load_weights(get_weights(args.weights))
    return device, physics, model, lpips


def main(argv=None) -> EvalResult:
    """Evaluate as the flags say; prints the summary and returns each
    scored image's PSNR, SSIM and LPIPS."""
    parser = DefaultArgParser(prog="python -m sei_tpu_torch.cli.test")
    add_test_args(parser)
    args = parser.parse_args(argv)
    _, physics, model, lpips = build(args)

    names = {}
    if physics is None:
        src = FolderDataset(args.dataset)
        n = len(src)

        def get_pair(i):
            names[i] = src.basename(i)
            return None, torch.as_tensor(src.load(i), device=model.device)

    else:
        gt = ground_truth(args, args.GroundTruthDataset__split)
        n = len(gt)

        def get_pair(i):
            x = torch.as_tensor(gt[i], device=model.device)
            seed = None
            if args.SyntheticDataset__deterministic_measurements:
                seed = image_seed(0, gt.unique_id(i) if args.SyntheticDataset__unique_seeds else 0)
            return degraded_pair(physics, x, seed,
                                 even=args.noise2inverse and physics.task == "deblurring")

    if args.save_psf:
        if args.out_dir is None or physics is None or physics.task != "deblurring":
            raise ValueError("--save_psf needs --out_dir and a deblurring physics")
        k = physics.kernel.cpu().numpy()
        write_image(os.path.join(args.out_dir, "psf.png"), (k / k.max())[None])

    if (args.noise2inverse or args.r2r) and physics is None:
        raise ValueError("--noise2inverse and --r2r need the physics: a dataset of ground truth")
    apply = eval_apply(model, physics, pad_bucket=args.eval_pad_bucket,
                       eval_tile_height=args.eval_tile_height,
                       noise2inverse=args.noise2inverse)
    if args.r2r:
        r2r_gen = torch.Generator(device=model.device).manual_seed(1)
        restore_one = apply

        def apply(y):
            return r2r_average(restore_one, y, sigma=physics.sigma,
                               itercount=args.r2r_itercount, generator=r2r_gen)

    indices = range(n) if args.indices is None else [int(i) for i in args.indices.split(",")]
    psnrs, ssims, dists = [], [], []
    for i in indices:
        x, y = get_pair(i)
        if x is None:
            x_hat = quantize_and_clamp(apply(y[None]))[0]
        else:
            p, s, d, x_hat = score_pair(model, x, y, apply=apply, lpips=lpips)
            psnrs.append(p)
            ssims.append(s)
            dists.append(d)
            if args.print_all_metrics:
                print(f"METRICS_{i}: PSNR: {p:.2f}, SSIM: {s:.4f}, LIPS: {d:.4f}")
        if args.save_images:
            if args.out_dir is None:
                raise ValueError("--save_images needs --out_dir")
            name = names.get(i, f"{i}.png")
            if x is not None:
                write_image(os.path.join(args.out_dir, "ground_truth", name),
                            quantize_and_clamp(x).cpu().numpy())
            write_image(os.path.join(args.out_dir, "predictors", name),
                        quantize_and_clamp(y).cpu().numpy())
            write_image(os.path.join(args.out_dir, "estimates", name), x_hat.cpu().numpy())

    if psnrs:
        print(f"N: {len(psnrs)}")
        print(f"PSNR: {np.mean(psnrs):.2f}")
        print(f"PSNR std: {np.std(psnrs):.2f}")
        print(f"SSIM: {np.mean(ssims):.4f}")
        print(f"SSIM std: {np.std(ssims):.4f}")
        if not np.all(np.isnan(dists)):
            print(f"LPIPS: {np.nanmean(dists):.4f}")
            print(f"LPIPS std: {np.nanstd(dists):.4f}")
        else:
            print("LPIPS: n/a (no local LPIPS weights; pass --lpips_weights)")
    return EvalResult(psnrs, ssims, dists)


if __name__ == "__main__":
    main(sys.argv[1:])
