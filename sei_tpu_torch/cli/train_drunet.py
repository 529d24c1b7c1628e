"""Train a blind Gaussian DRUNet denoiser (counterpart of
``experiments/train_drunet.py``) and save it as the JAX package's native
``.npz``, the weights of PlugAndPlay, DiffPIR_DRUNet and DPS:

    python -m sei_tpu_torch.cli.train_drunet --datasets_dir DIR --out runs/drunet.npz
    SEI_DRUNET_WEIGHTS=runs/drunet.npz python -m sei_tpu_torch.cli.test \\
        --model_kind PlugAndPlay ...

The recipe is the JAX script's, flag for flag (DRUNet's training in DPIR,
Zhang et al.): sigma ~ U(0, 55/255) per batch with the noise-level map,
random 64 px crops of the ``div2k`` train split (resized to a shorter side
of 256, as ``GroundTruthDataset`` does), MSE, Adam 1e-4 for 6000 steps at
batch 16; ``--sigma_dist log`` draws sigma log-uniformly on [1e-3,
sigma_max] and weights the MSE by 1 / (sigma^2 + 1e-4) (the wide range the
diffusion samplers walk).  The port adds ``--device`` (default ``cuda``;
without a GPU it raises unless ``--device cpu``) and ``--seed`` (the
initialisation, flax's defaults drawn on the CPU, and the draws'
generator on the device).  A loss line every 500 steps; at the end the
steps per second and the peak memory beside ``nvidia-smi``'s card name
and power limit.  The step runs eagerly and reads nothing on the host but
the logged losses.  The file loads in :func:`sei_tpu_torch.models.drunet.load_drunet`
and in the JAX package's ``load_drunet_native``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..bench import nvidia_smi
from ..data import GroundTruthDataset
from ..device import resolve_device
from ..models.drunet import DRUNet, save_drunet_native
from ..train import denoisers as dn
from ..train.optim import get_optimizer


def base_parser(prog: str, out: str, lr: float) -> argparse.ArgumentParser:
    """The flags both denoiser trainers share (their defaults the JAX
    scripts')."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--out", default=out)
    ap.add_argument("--datasets_dir", default="./datasets")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def prepare(args):
    """(device, the training images' cache, the CPU generator of the
    initialisation, the device generator of the draws)."""
    device = resolve_device(args.device)
    gt = GroundTruthDataset(dataset_name="div2k", datasets_dir=args.datasets_dir, split="train")
    cache = dn.load_cache(gt.load_all(), device)
    init = torch.Generator().manual_seed(args.seed)
    draws = torch.Generator(device=device).manual_seed(args.seed)
    return device, cache, init, draws


def run(args, device, net, step, save) -> list:
    """``args.steps`` steps of ``step`` with the loss lines, the rate line,
    then ``save(args.out)``; returns the logged (step, loss) pairs."""
    smi = nvidia_smi() if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logged = dn.fit(step, args.steps, suffix=f"; {smi}", log=lambda s: print(s, flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if device.type == "cuda" else "")
    print(f"trained {args.steps} steps at batch {args.batch} in {seconds:.1f} s: "
          f"{args.steps / seconds:.2f} steps/s ({seconds * 1e3 / args.steps:.2f} ms/step)"
          f"{peak}; {smi}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save(args.out)
    print("saved:", args.out, flush=True)
    return logged


def main(argv=None):
    """Train and save; returns (the network, the logged (step, loss) pairs)."""
    ap = base_parser("python -m sei_tpu_torch.cli.train_drunet", "runs/drunet.npz", 1e-4)
    ap.add_argument("--channels", type=int, nargs="+", default=[64, 128, 256, 512])
    ap.add_argument("--nb", type=int, default=4)
    ap.add_argument("--sigma_max", type=float, default=55.0 / 255.0)
    ap.add_argument("--sigma_dist", choices=["uniform", "log"], default="uniform")
    args = ap.parse_args(argv)
    device, cache, init, draws = prepare(args)
    net = dn.lecun_init_(DRUNet(channels=args.channels, nb=args.nb), init).to(device)
    opt = get_optimizer(net.parameters(), lr=args.lr)
    log_weight = args.sigma_dist == "log"

    def step():
        x, sigma, noise = dn.drunet_draws(cache, draws, batch=args.batch, crop=args.crop,
                                          sigma_max=args.sigma_max, sigma_dist=args.sigma_dist)
        return dn.train_step(net, opt, dn.drunet_loss, x, sigma, noise, log_weight)

    logged = run(args, device, net, step, lambda path: save_drunet_native(path, net))
    return net, logged


if __name__ == "__main__":
    main(sys.argv[1:])
