"""The command lines' flags (counterpart of ``sei_tpu/config.py``).

The same parsers, flags, defaults and ``default_*`` helpers as the JAX
package: the reference's ``ClassName__param`` namespaced flags, the README
aliases (``--method sup|ei-shift|ei-rotate``, ``--model_kind
swinir|dip|...``) and explicit flags for the reference's environment
switches.  ``--device`` takes ``cuda`` (the default), ``cuda:N`` or ``cpu``;
nothing falls back to the CPU.  Every flag of the JAX package's parsers
is ported.
"""

from __future__ import annotations

import argparse
import re
from argparse import BooleanOptionalAction


class DefaultArgParser(argparse.ArgumentParser):
    """Shared flags for train/test/generate CLIs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument("--device", type=str, default="cuda",
                          help="cuda (default), cuda:N or cpu")
        self.add_argument("--task", type=str)
        self.add_argument("--kernel", type=str, default=None)
        self.add_argument("--physics_true_adjoint", action=BooleanOptionalAction,
                          default=False)
        self.add_argument("--physics_antialias", action=BooleanOptionalAction,
                          default=True,
                          help="antialias the SR downsampling resize (the "
                          "reference's SR physics is always antialiased; "
                          "--no-physics_antialias exposes the raw-bicubic "
                          "variant)")
        self.add_argument("--sr_factor", type=int, default=None)
        self.add_argument("--noise_level", type=int, default=5)
        self.add_argument("--dataset", type=str, default="div2k")
        self.add_argument("--GroundTruthDataset__datasets_dir", type=str,
                          default="./datasets")
        self.add_argument("--GroundTruthDataset__download", "--download",
                          action=BooleanOptionalAction, default=False)
        group = self.add_mutually_exclusive_group()
        group.add_argument("--GroundTruthDataset__size", type=int, default=256)
        group.add_argument("--GroundTruthDataset__no_resize", action="store_const",
                           dest="GroundTruthDataset__size", const=None)
        self.add_argument("--SyntheticDataset__unique_seeds",
                          action=BooleanOptionalAction, default=True)
        self.add_argument("--PrepareTrainingPairs__crop_size", type=int, default=256)
        self.add_argument("--PrepareTrainingPairs__crop_location", type=str,
                          default="random")
        self.add_argument("--model_kind", type=str, default="Proposed")
        self.add_argument("--ProposedModel__architecture", type=str,
                          default="Transformer")
        # SwinIR architecture overrides (extension: the reference CLI pins
        # the published config, making small smoke runs impossible)
        self.add_argument("--SwinIR__embed_dim", type=int, default=None)
        self.add_argument("--SwinIR__depths", type=int, nargs="+", default=None)
        self.add_argument("--SwinIR__num_heads", type=int, nargs="+", default=None)
        self.add_argument("--SwinIR__window_size", type=int, default=None)
        self.add_argument("--SwinIR__drop_path_rate", type=float, default=None)
        self.add_argument("--ConvolutionalModel__residual",
                          action=BooleanOptionalAction, default=True)
        self.add_argument("--ConvolutionalModel__inner_residual",
                          action=BooleanOptionalAction, default=True)
        self.add_argument("--ConvolutionalModel__inout_convs",
                          action=BooleanOptionalAction, default=True)
        self.add_argument("--ConvolutionalModel__hidden_channels", type=int,
                          default=32)
        self.add_argument("--ConvolutionalModel__scales", type=int, default=5)
        self.add_argument("--ConvolutionalModel__num_conv_blocks", type=int,
                          default=1)
        self.add_argument("--SingleImageDataset__image_path", type=str, default=None)
        self.add_argument("--SingleImageDataset__duplicates_count", type=int,
                          default=800)
        # DataParallel device list in the reference; here: one training
        # process (rank) per listed device (cli.train)
        self.add_argument("--data_parallel_devices", type=str, default=None)
        self.add_argument("--physics_v2", action=BooleanOptionalAction, default=True)
        # explicit spellings of the reference's env-var backdoors
        self.add_argument("--homogeneous_swinir", action=BooleanOptionalAction,
                          default=False)

    def parse_args(self, *a, **k):
        """Parse, and check ``--device`` (the entry point resolves it:
        parsing needs no GPU)."""
        args = super().parse_args(*a, **k)
        if not re.fullmatch(r"cpu|cuda(:\d+)?", args.device):
            self.error(f"--device: expected cuda, cuda:N or cpu, got {args.device!r}")
        return args


def add_train_args(parser: argparse.ArgumentParser):
    """Training flags (ref demo/train.py:33-77)."""
    parser.add_argument("--method", type=str)
    parser.add_argument("--Loss__crop_training_pairs", action=BooleanOptionalAction,
                        default=True)
    parser.add_argument("--Loss__crop_size", type=int, default=48)
    parser.add_argument("--ProposedLoss__transforms", type=str,
                        default="Scaling_Transforms")
    # README alias: --stop_gradient / --no-stop_gradient (README.md:63)
    parser.add_argument("--ProposedLoss__stop_gradient", "--stop_gradient",
                        action=BooleanOptionalAction, default=True)
    parser.add_argument("--ProposedLoss__sure_alternative", type=str, default=None)
    parser.add_argument("--ProposedLoss__alpha_tradeoff", type=float, default=1.0)
    parser.add_argument("--ScalingTransform__kind", type=str, default="padded")
    parser.add_argument("--ScalingTransform__antialias",
                        action=BooleanOptionalAction, default=False)
    parser.add_argument("--out_dir", type=str)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--checkpoint_interval", type=int, default=None)
    parser.add_argument("--memoize_gt", action=BooleanOptionalAction, default=True)
    parser.add_argument("--partial_sure", action=BooleanOptionalAction, default=True)
    parser.add_argument("--sure_cropped_div", action=BooleanOptionalAction,
                        default=True)
    parser.add_argument("--sure_averaged_cst", action=BooleanOptionalAction,
                        default=None)
    parser.add_argument("--partial_sure_sr", action=BooleanOptionalAction,
                        default=False)
    parser.add_argument("--sure_margin", type=int, default=None)
    parser.add_argument("--lr_scheduler_kind", type=str,
                        default="delayed_linear_decay")
    parser.add_argument("--optimizer_beta2", type=float, default=0.999)
    parser.add_argument("--SyntheticDataset__deterministic_measurements",
                        action=BooleanOptionalAction, default=True)
    parser.add_argument("--GroundTruthDataset__split", type=str, default="train")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--optimizer", type=str, default=None)
    parser.add_argument("--fine_tuning", action=BooleanOptionalAction, default=False)
    parser.add_argument("--fine_tuning_params", action=BooleanOptionalAction,
                        default=False)
    parser.add_argument("--weights_distance_loss", action=BooleanOptionalAction,
                        default=False)
    parser.add_argument("--RESUME", type=str, default=None)
    parser.add_argument("--RESUME_keep_schedule", action="store_true",
                        help="resume with the step-indexed LR schedule intact "
                             "(the reference's RESUME pins --lr and disables "
                             "the scheduler; this flag is for crash recovery "
                             "where schedule continuity is wanted)")
    # explicit env-hook spellings
    parser.add_argument("--supervised_l1", action=BooleanOptionalAction,
                        default=False)
    parser.add_argument("--sure_rate_hotfix", action=BooleanOptionalAction,
                        default=False)
    # extras with no reference analog
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the training run here")
    parser.add_argument("--bf16", action=BooleanOptionalAction, default=False,
                        help="bf16 compute dtype for the model (params stay f32)")
    parser.add_argument("--scan_steps", type=int, default=1,
                        help="train steps per device dispatch (one CUDA graph)")
    parser.add_argument("--eval_interval", type=int, default=0,
                        help="run the val-split eval protocol every N epochs "
                             "during training, log validation.csv, and keep "
                             "the best-PSNR state as checkpoints/ckp_best "
                             "(mechanized operating-point selection); 0=off")
    parser.add_argument("--eval_count", type=int, default=None,
                        help="cap the number of val images per in-training "
                             "eval (default: the whole val split)")


def add_test_args(parser: argparse.ArgumentParser):
    """Eval flags (ref demo/test.py:25-45)."""
    parser.add_argument("--weights", type=str)
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--indices", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--save_psf", action="store_true")
    parser.add_argument("--dip_iterations", type=int, default=None)
    parser.add_argument("--noise2inverse", action="store_true")
    parser.add_argument("--print_all_metrics", action="store_true")
    parser.add_argument("--r2r", action="store_true")
    parser.add_argument("--r2r_itercount", type=int, default=1)
    parser.add_argument("--tv_lambd", type=float, default=None)
    parser.add_argument("--tv_max_iter", type=int, default=300)
    parser.add_argument("--GroundTruthDataset__split", type=str, default="val")
    parser.add_argument("--SyntheticDataset__deterministic_measurements",
                        action=BooleanOptionalAction, default=True)
    parser.add_argument("--memoize_gt", action=BooleanOptionalAction, default=False)
    parser.add_argument("--lpips_weights", type=str, default=None)
    # reflect-pad eval inputs up to a multiple of this bucket (0 = native
    # shape per image; padding can move boundary pixels by <0.02 dB)
    parser.add_argument("--eval_pad_bucket", type=int, default=64)
    # strip-tile trainable-model eval above this height (halo 64); bounds
    # attention activation memory for full-resolution (--no_resize) images
    parser.add_argument("--eval_tile_height", type=int, default=768)


def default_epochs(dataset: str) -> int:
    return {"div2k": 500, "urban100": 4000, "ct": 100}.get(dataset, 500)


def default_checkpoint_interval(dataset: str) -> int:
    return {"urban100": 400}.get(dataset, 50)


def default_lr(task: str, fine_tuning: bool) -> float:
    if fine_tuning:
        return 1e-2
    return 2e-4 if task == "sr" else 1e-4


def default_optimizer(fine_tuning: bool) -> str:
    return "SGD" if fine_tuning else "Adam"
