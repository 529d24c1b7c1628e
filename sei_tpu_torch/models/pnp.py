"""The denoiser-prior baselines' gate (counterpart of
``sei_tpu/models/pnp.py``): PlugAndPlay, DiffPIR_DRUNet, DiffPIR_DiffUNet
and DPS need pretrained weights that the repository does not hold; a local
file is named by ``SEI_DRUNET_WEIGHTS`` (a published-format
``drunet_color.pth`` or the JAX package's native ``.npz``) or
``SEI_DIFFUNET_WEIGHTS`` (a guided-diffusion checkpoint), and without it
the kind raises ``NotImplementedError`` with the JAX package's message.
"""

from __future__ import annotations

import os

import torch


def get_denoiser_model(kind: str, *, physics, noise_level: float, device: torch.device):
    if kind == "DiffPIR_DiffUNet":
        weights = os.environ.get("SEI_DIFFUNET_WEIGHTS")
        needed = ("a guided-diffusion UNet checkpoint (e.g. diffusion_ffhq_10m.pt) "
                  "via SEI_DIFFUNET_WEIGHTS")
    else:
        weights = os.environ.get("SEI_DRUNET_WEIGHTS")
        needed = "a local drunet_color.pth via SEI_DRUNET_WEIGHTS"
    if not weights or not os.path.exists(weights):
        raise NotImplementedError(
            f"{kind} needs a pretrained denoiser: set {needed} (no network "
            "egress in this environment; the reference downloads weights via "
            "deepinv).")
    from .denoiser_solvers import build_denoiser_baseline

    return build_denoiser_baseline(kind, weights_path=weights, physics=physics,
                                   noise_level=noise_level, device=device)
