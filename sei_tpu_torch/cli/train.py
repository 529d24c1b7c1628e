"""Training command line (counterpart of ``demo/train.py``, the same flags).

The paper's main configuration, on the GPU:

    python -m sei_tpu_torch.cli.train --task deblurring --kernel Gaussian_R2 \\
        --method proposed --dataset div2k --out_dir runs/deblur_r2

A tiny run on the CPU:

    python -m sei_tpu_torch.cli.train --device cpu --task deblurring \\
        --kernel Gaussian_R2 --method proposed --dataset gt_folder:DIR \\
        --GroundTruthDataset__size 64 --SwinIR__embed_dim 12 --SwinIR__depths 2 \\
        --SwinIR__num_heads 2 --SwinIR__window_size 4 --epochs 1 --out_dir run

The steps of ``demo/train.py:64-333``: physics, model (``--bf16``: bf16
compute, f32 params; ``--ProposedModel__architecture Convolutional`` the
Convolutional UNet of the ``--ConvolutionalModel__*`` flags, which stays
f32 under ``--bf16`` and writes its own names to ``weights.pt``),
``--weights``, loss, :class:`GroundTruthDataset`, the
device cache (each image degraded once with its own seed), the defaults of
``sei_tpu_torch.config``, then :class:`~sei_tpu_torch.train.Trainer`, one
CUDA graph per ``--scan_steps`` steps on the GPU.  Outputs under
``--out_dir``: ``training.csv``, ``checkpoints/ckp_*.pt`` and, at the end,
``weights.pt`` in the reference's format.

``--eval_interval N`` scores the val split (``all`` for a ``gt_folder:``
dataset; its first ``--eval_count`` images) after every N-th epoch and the
last, between the step's graph replays (``demo/train.py:236-268``):
``validation.csv`` and ``checkpoints/ckp_best.pt`` under ``--out_dir``.  A
dataset without a val split prints "eval_interval disabled" and trains on.
``--method proposed --ProposedLoss__sure_alternative r2r`` trains with
R2R-EI in place of SURE.

``--task sr --sr_factor F`` trains the SR SwinIR (pixelshuffle head) on
``--Loss__crop_size`` (48) px crops of the measurement and the aligned
``F`` times larger crops of the ground truth (``demo/train.py:194-201``);
``--homogeneous_swinir`` a rate-1 SwinIR on the bicubic pre-upsampled
measurement (48 px crops); ``--sure_rate_hotfix``, ``--partial_sure_sr``
and ``--physics_true_adjoint`` as in the JAX package.

``--task invert_a_tomography_like_filter`` trains on the CT-like ramp
filter's measurements (no kernel), ``--no-physics_v2`` deblurs with the
spatial blur.  The training modes of ``demo/train.py:140-300``: ``--method
css`` trains on (y, degrade(y)); ``--method ei-shift|ei-rotate`` (or
``--ProposedLoss__transforms Shifts|Rotations|Rotations+Shifts``) is
``proposed`` with that EI group; ``--ScalingTransform__kind normal`` builds
one loss (and one CUDA graph) per rate, 0.75 and 0.5, picked per dispatch
as the JAX trainer picks them; ``--no-SyntheticDataset__deterministic_measurements``
degrades the images anew at every step; ``--supervised_l1`` trains
``supervised`` with the L1 loss.  ``--fine_tuning`` (SGD at 1e-2 by
default) with ``--fine_tuning_params`` trains ``conv_last`` only and with
``--weights_distance_loss`` adds the distance to the starting weights (lambda
1); a directory given as ``--dataset`` holds measurements only and needs
``--fine_tuning`` and ``proposed`` (one ``--PrepareTrainingPairs__crop_size``
crop of each, drawn from ``--seed``).

``--RESUME CKP`` (with ``--lr``) resumes as the JAX package does: the LR is
pinned with the schedule off unless ``--RESUME_keep_schedule``, and the run
restarts at the checkpoint's ``epoch`` entry, so the epoch it was written
after runs again (``sei_tpu/train/trainer.py:476-485``).
``--profile_dir DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json``.

``--data_parallel_devices 0,1,..`` trains data-parallel
(:mod:`sei_tpu_torch.parallel`): this command starts one process (rank)
per listed device, rank r on ``cuda:<device r>`` (NCCL) or, under
``--device cpu``, on the CPU (gloo); they meet through the file
``--out_dir/dist_init`` and together compute the one-process run's steps
over the same global ``--batch_size``.  Rank 0 writes the outputs and
prints; :func:`main` then returns None.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..config import (DefaultArgParser, add_train_args, default_checkpoint_interval,
                      default_epochs, default_lr, default_optimizer)
from ..data import GroundTruthDataset, build_device_cache, build_finetuning_cache
from ..device import resolve_device
from ..losses import get_loss, normalize_method
from ..models import KIND_ALIASES, get_model
from ..parallel import DataParallel, init
from ..physics import get_physics
from ..train import Trainer
from ..train.checkpoint import get_weights
from ..train.optim import trainable_mask
from ..train.validate import ValidationHook


def swinir_overrides(args) -> dict:
    """The ``--SwinIR__*`` flags as ``get_model``'s overrides."""
    return {"embed_dim": args.SwinIR__embed_dim, "depths": args.SwinIR__depths,
            "num_heads": args.SwinIR__num_heads, "window_size": args.SwinIR__window_size,
            "drop_path_rate": args.SwinIR__drop_path_rate}


def conv_blueprint(args) -> dict:
    """The ``--ConvolutionalModel__*`` flags as ``get_model``'s blueprint."""
    return {"residual": args.ConvolutionalModel__residual,
            "inner_residual": args.ConvolutionalModel__inner_residual,
            "num_conv_blocks": args.ConvolutionalModel__num_conv_blocks,
            "inout_convs": args.ConvolutionalModel__inout_convs,
            "hidden_channels": args.ConvolutionalModel__hidden_channels,
            "scales": args.ConvolutionalModel__scales}


def setup(args, *, with_physics: bool = True):
    """Resolve the device (made current, for a ``cuda:N``); then the physics
    (None without ``with_physics``), as every command line builds it."""
    device = resolve_device(args.device)
    if device.index is not None:
        torch.cuda.set_device(device)
    physics = None
    if with_physics:
        physics = get_physics(task=args.task, noise_level=args.noise_level, kernel=args.kernel,
                              sr_factor=args.sr_factor, physics_v2=args.physics_v2,
                              physics_true_adjoint=args.physics_true_adjoint,
                              antialias=args.physics_antialias, device=device)
    return device, physics


def build_model(args, device: torch.device):
    """The model the training flags ask for on ``device``, its ``--weights``
    loaded."""
    if KIND_ALIASES.get(args.model_kind, args.model_kind) != "Proposed":
        raise ValueError(f"--model_kind {args.model_kind}: nothing to train")
    model = get_model(kind=args.model_kind, architecture=args.ProposedModel__architecture,
                      task=args.task, sr_factor=args.sr_factor, device=device, seed=args.seed,
                      homogeneous_swinir=args.homogeneous_swinir,
                      swinir_overrides=swinir_overrides(args),
                      conv_blueprint=conv_blueprint(args),
                      dtype=torch.bfloat16 if args.bf16 else None)
    if args.weights is not None:
        model.load_weights(get_weights(args.weights))
    return model


def ground_truth(args, split: str, duplicates_count=None) -> GroundTruthDataset:
    """The flags' dataset split (``duplicates_count``: a single image's
    copies, default the flag's)."""
    if duplicates_count is None:
        duplicates_count = args.SingleImageDataset__duplicates_count
    return GroundTruthDataset(
        dataset_name=args.dataset, datasets_dir=args.GroundTruthDataset__datasets_dir,
        split=split, download=args.GroundTruthDataset__download,
        size=args.GroundTruthDataset__size, memoize_gt=args.memoize_gt,
        single_image_blueprint={"image_path": args.SingleImageDataset__image_path,
                                "duplicates_count": duplicates_count})


def validation_hook(args, physics):
    """The in-training validation of ``--eval_interval``, or None (off, or
    no val split: the JAX package's message, and training goes on)."""
    if not args.eval_interval:
        return None
    split = "all" if args.dataset.startswith("gt_folder:") else "val"
    try:
        return ValidationHook(ground_truth(args, split, duplicates_count=1), physics,
                              max_images=args.eval_count)
    except (ValueError, AssertionError) as e:
        print(f"eval_interval disabled (no val split): {e}")
        return None


def parse(argv=None):
    parser = DefaultArgParser(prog="python -m sei_tpu_torch.cli.train")
    add_train_args(parser)
    return parser.parse_args(argv)


def data_parallel_devices(args) -> list:
    return [int(d) for d in args.data_parallel_devices.split(",")]


def main(argv=None) -> Optional[dict]:
    """Train as the flags say; returns the trainer, its ``train`` stats and
    each step's loss (device tensors, in step order), or None after a
    data-parallel run (``--data_parallel_devices``), whose ranks ran in
    processes of their own."""
    args = parse(argv)
    if args.data_parallel_devices is None:
        return train(args)
    if not args.out_dir:
        raise ValueError("--data_parallel_devices needs --out_dir (the ranks meet through a "
                         "file there)")
    resolve_device(args.device)  # no GPU: raise here, not in the ranks
    os.makedirs(args.out_dir, exist_ok=True)
    init_file = os.path.join(args.out_dir, "dist_init")
    if os.path.exists(init_file):  # a finished or failed run's
        os.remove(init_file)
    argv = list(sys.argv[1:] if argv is None else argv)
    # fresh interpreters (run_rank pickled by its import path); raises if a rank fails
    torch.multiprocessing.spawn(run_rank, args=(argv, init_file),
                                nprocs=len(data_parallel_devices(args)), join=True)
    return None


def run_rank(rank: int, argv: list, init_file: str) -> None:
    """Rank ``rank`` of a data-parallel run: join the process group, then
    train as :func:`main` does."""
    args = parse(argv)
    devices = data_parallel_devices(args)
    if args.device != "cpu":
        args.device = f"cuda:{devices[rank]}"
    dp = init(rank, len(devices), init_file, resolve_device(args.device))
    try:
        train(args, data_parallel=dp)
    finally:
        torch.distributed.destroy_process_group()


def train(args, data_parallel: Optional[DataParallel] = None) -> dict:
    """One process's training run for the parsed flags."""
    device, physics = setup(args)
    leader = data_parallel is None or data_parallel.rank == 0
    method, transforms = normalize_method(args.method, args.ProposedLoss__transforms)
    if os.path.isdir(args.dataset):
        if not args.fine_tuning:
            raise ValueError("Datasets of predictors only are only supported for fine-tuning")
        if method != "proposed":
            raise ValueError("Fine-tuning is only supported for the proposed method")
    if args.fine_tuning_params and not args.fine_tuning:
        raise ValueError("Fine-tuning parameters are only supported for fine-tuning")
    if args.weights_distance_loss and not args.fine_tuning:
        raise ValueError("Weights distance loss is only supported for fine-tuning")
    if args.RESUME is not None and args.lr is None:
        raise ValueError("RESUME requires an explicit --lr")

    model = build_model(args, device)

    loss_kwargs = dict(
        method=method, physics=physics, noise_level=args.noise_level,
        partial_sure=args.partial_sure, partial_sure_sr=args.partial_sure_sr,
        sure_margin=args.sure_margin, sure_cropped_div=args.sure_cropped_div,
        sure_averaged_cst=args.sure_averaged_cst, stop_gradient=args.ProposedLoss__stop_gradient,
        sure_alternative=args.ProposedLoss__sure_alternative,
        alpha_tradeoff=args.ProposedLoss__alpha_tradeoff, transforms=transforms,
        scaling_kind=args.ScalingTransform__kind,
        scaling_antialias=args.ScalingTransform__antialias,
        crop_training_pairs=args.Loss__crop_training_pairs, crop_size=args.Loss__crop_size,
        supervised_l1=args.supervised_l1, sure_rate_hotfix=args.sure_rate_hotfix)
    normal_rate_losses = None
    if (transforms == "Scaling_Transforms" and args.ScalingTransform__kind == "normal"
            and method == "proposed"):
        normal_rate_losses = [get_loss(**loss_kwargs, fixed_normal_rate=r) for r in (0.75, 0.5)]
        loss_fn = normal_rate_losses[0]
    else:
        loss_fn = get_loss(**loss_kwargs)

    eval_hook = None
    if os.path.isdir(args.dataset):
        cache = build_finetuning_cache(args.dataset, args.PrepareTrainingPairs__crop_size,
                                       np.random.default_rng(args.seed), device=device)
        data_crop = args.PrepareTrainingPairs__crop_size
    else:
        gt = ground_truth(args, args.GroundTruthDataset__split)
        cache = build_device_cache(
            gt, physics, seed=args.seed, unique_seeds=args.SyntheticDataset__unique_seeds,
            upsample_y_to_x=args.homogeneous_swinir and args.task == "sr")
        eval_hook = validation_hook(args, physics)
        # the dataset crop, y side: SR crops the loss's 48 px directly,
        # deblurring 256 then the loss 48 (demo/train.py:194-201)
        data_crop = (args.Loss__crop_size if args.task == "sr"
                     else args.PrepareTrainingPairs__crop_size)
        if args.homogeneous_swinir:
            data_crop = 48

    epochs = args.epochs if args.epochs is not None else default_epochs(args.dataset)
    lr = args.lr if args.lr is not None else default_lr(args.task, args.fine_tuning)
    optimizer = args.optimizer or default_optimizer(args.fine_tuning)
    ckpt_interval = (args.checkpoint_interval if args.checkpoint_interval is not None
                     else default_checkpoint_interval(args.dataset))
    if leader:
        print(f"\nSelected learning rate: {lr:e}\n")
        print(f"\nSelected optimizer: {optimizer}\n")

    # the reference's RESUME pins the LR and turns the schedule off
    pinned = args.RESUME is not None and not args.RESUME_keep_schedule
    trainer = Trainer(model, loss_fn, physics, cache, batch_size=args.batch_size,
                      epochs=epochs, lr=lr, optimizer=optimizer, beta2=args.optimizer_beta2,
                      lr_scheduler_kind=None if pinned else args.lr_scheduler_kind,
                      crop_size=data_crop, out_dir=args.out_dir,
                      checkpoint_interval=ckpt_interval, seed=args.seed,
                      scan_steps=args.scan_steps,
                      eval_interval=args.eval_interval if eval_hook is not None else 0,
                      eval_hook=eval_hook, css=method == "css",
                      fresh_measurements=not args.SyntheticDataset__deterministic_measurements,
                      trainable_mask=(trainable_mask(model.module)
                                      if args.fine_tuning_params else None),
                      weights_distance_lambda=1.0 if args.weights_distance_loss else None,
                      normal_rate_losses=normal_rate_losses, data_parallel=data_parallel)
    if args.RESUME is not None:
        data = trainer.load_checkpoint(args.RESUME)
        trainer.start_epoch = int(data["epoch"])  # the JAX trainer's restart epoch
        if leader:
            print("Loading checkpoint from epoch", trainer.start_epoch)

    losses = []
    profiling = contextlib.nullcontext()
    if args.profile_dir and leader:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiling = torch.profiler.profile(activities=activities)
    with profiling as prof:
        stats = trainer.train(on_step=lambda step, loss: losses.append(loss))
    if args.profile_dir and leader:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

    if leader:
        print(f"\nTrained {stats['steps']} steps in {stats['wall_time_s']:.1f}s "
              f"({stats['images_per_sec']:.1f} images/sec)\n")
    if args.out_dir and leader:
        model.save_reference_format(os.path.join(args.out_dir, "weights.pt"))
    return {"trainer": trainer, "stats": stats, "losses": losses}


if __name__ == "__main__":
    main(sys.argv[1:])
