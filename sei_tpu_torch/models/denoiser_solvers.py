"""Denoiser-prior solvers: DPIR/HQS (PnP), DiffPIR and DPS (counterpart of
``sei_tpu/models/denoiser_solvers.py``).

Eval-only reconstructions around a denoiser ``denoiser(x, sigma)``
(:class:`~sei_tpu_torch.models.drunet.DRUNet` or
:func:`~sei_tpu_torch.models.diffunet.diffunet_denoise`).  The data-fidelity
prox is the closed form in Fourier for the FFT circular blur and 20 steps of
conjugate gradients elsewhere.  Where the JAX loops draw Gaussian noise
(DiffPIR, DPS: ``PRNGKey(0)``, then a split per step), the solvers here take
the draws as ``normals`` (one N(0, I) tensor of x's shape per draw, in the
JAX loop's order), by default from a generator seeded 0 on y's device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.fft_conv import psf_to_otf


def prox_l2_blur(z, y, kernel, gamma: float):
    """argmin_x ||A x - y||^2 + gamma ||x - z||^2 for the circular blur."""
    shape = tuple(z.shape[-2:])
    otf = psf_to_otf(kernel.to(z.dtype), shape)
    num = torch.conj(otf) * torch.fft.rfft2(y, dim=(-2, -1)) \
        + gamma * torch.fft.rfft2(z, dim=(-2, -1))
    return torch.fft.irfft2(num / (otf.abs() ** 2 + gamma), s=shape, dim=(-2, -1))


def prox_l2_cg(z, y, physics, gamma: float, iters: int = 20):
    """The same prox by CG on (A^T A + gamma I) x = A^T y + gamma z from z."""
    def mv(v):
        return physics.A_adjoint(physics.A(v)) + gamma * v

    x = z
    r = physics.A_adjoint(y) + gamma * z - mv(x)
    p, rs = r, torch.sum(r * r)
    for _ in range(iters):
        ap = mv(p)
        alpha = rs / (torch.sum(p * ap) + 1e-12)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / (rs + 1e-12)) * p
        rs = rs_new
    return x


def make_data_prox(physics) -> Callable:
    if physics.task == "deblurring" and physics.v2:
        return lambda z, y, gamma: prox_l2_blur(z, y, physics.kernel, gamma)
    return lambda z, y, gamma: prox_l2_cg(z, y, physics, gamma)


def _draws(normals: Optional[Sequence[torch.Tensor]], like: torch.Tensor):
    if normals is not None:
        return iter(normals)
    g = torch.Generator(device=like.device).manual_seed(0)
    return iter(lambda: torch.randn(like.shape, generator=g, device=like.device,
                                    dtype=like.dtype), None)


def dpir_hqs(y, physics, denoiser, *, noise_level_img: float, iters: int = 8,
             lamb: float = 0.23, sigma1: float = 49.0 / 255.0):
    """DPIR half-quadratic splitting: sigma_k log-spaced from ``sigma1`` to
    the noise level, the prox at gamma_k = lamb (noise / sigma_k)^2, then
    the denoiser at sigma_k."""
    floor = max(noise_level_img, 1e-4)
    prox = make_data_prox(physics)
    x = physics.A_adjoint(y)
    for s in np.logspace(math.log10(sigma1), math.log10(floor), iters):
        x = denoiser(prox(x, y, float(lamb * (floor / s) ** 2)), float(s))
    return x


def _schedule(steps: int):
    alphas = np.cumprod(1 - np.linspace(0.1 / 1000, 20 / 1000, 1000))
    return alphas, np.linspace(0, 999, steps).astype(int)[::-1]


def diffpir(y, physics, denoiser, *, noise_level_img: float, steps: int = 100,
            lambda_: float = 7.0, zeta: float = 0.3,
            normals: Optional[Sequence[torch.Tensor]] = None):
    """The DiffPIR sampler (Zhu et al. 2023): ``steps`` normals are drawn,
    the first for x_T, one per step after that but the last."""
    alphas, seq = _schedule(steps)
    prox = make_data_prox(physics)
    x = physics.A_adjoint(y)
    draw = _draws(normals, x)
    a_T = alphas[seq[0]]
    x = math.sqrt(a_T) * x + math.sqrt(1 - a_T) * next(draw)
    for i, t in enumerate(seq):
        a_t = alphas[t]
        sigma_t = math.sqrt((1 - a_t) / a_t)
        x0 = denoiser(x / math.sqrt(a_t), sigma_t)
        x0 = prox(x0, y, lambda_ * noise_level_img**2 / max(sigma_t**2, 1e-8))
        if i == len(seq) - 1:
            return x0
        a_next = alphas[seq[i + 1]]
        eps = (x - math.sqrt(a_t) * x0) / math.sqrt(max(1 - a_t, 1e-8))
        x = math.sqrt(a_next) * x0 + math.sqrt(1 - a_next) * (
            math.sqrt(1 - zeta) * eps + math.sqrt(zeta) * next(draw))
    return x


def dps(y, physics, denoiser, *, steps: int = 100, eta: float = 1.0,
        normals: Optional[Sequence[torch.Tensor]] = None):
    """Diffusion posterior sampling (Chung et al. 2023) as deepinv's DPS:
    the diffusion in z = 2x - 1 with the [0, 1] denoiser bridged by z / 2 +
    0.5 and sigma / 2, x0 clipped to [-1, 1], the eta-noised DDIM update
    minus the gradient of ||A(x0) - y_z|| through the denoiser."""
    alphas, seq = _schedule(steps)
    ones = torch.ones_like(physics.A_adjoint(y))
    yz = 2.0 * y - physics.A(ones)
    draw = _draws(normals, ones)
    x = next(draw)
    for i, t in enumerate(seq):
        a_t = alphas[t]
        sigma_t = math.sqrt((1 - a_t) / a_t)
        with torch.enable_grad():
            xt = x.detach().requires_grad_(True)
            z = xt / math.sqrt(a_t)
            x0 = torch.clamp(2.0 * denoiser(z / 2.0 + 0.5, sigma_t / 2.0) - 1.0, -1.0, 1.0)
            r = physics.A(x0) - yz
            g, = torch.autograd.grad(torch.sqrt(torch.sum(r * r) + 1e-12), xt)
        x0 = x0.detach()
        if i == len(seq) - 1:
            return (x0 + 1.0) / 2.0
        a_next = alphas[seq[i + 1]]
        sigma_tilde = math.sqrt(max((1 - a_t / a_next) * (1 - a_next) / (1 - a_t), 0.0)) * eta
        c2 = math.sqrt(max((1 - a_next) - sigma_tilde**2, 0.0))
        eps = (x - math.sqrt(a_t) * x0) / math.sqrt(max(1 - a_t, 1e-8))
        x = math.sqrt(a_next) * x0 + c2 * eps + sigma_tilde * next(draw) - g
    return (x + 1.0) / 2.0


def make_denoiser(kind: str, weights_path: str, device: torch.device) -> Callable:
    """``denoiser(x, sigma)`` of a baseline kind: DiffPIR_DiffUNet's from a
    guided-diffusion checkpoint, the others' DRUNet from a published-format
    ``.pth`` or a native ``.npz``."""
    if kind == "DiffPIR_DiffUNet":
        from .diffunet import diffunet_denoise, load_diffunet

        net = load_diffunet(weights_path).to(device).eval()
        mult = 2 ** (len(net.cfg.channel_mult) - 1)
        return lambda x, sigma: diffunet_denoise(net, x, sigma, multiple=mult)
    from .drunet import load_drunet

    return load_drunet(weights_path).to(device).eval()


def build_denoiser_baseline(kind: str, *, weights_path: str, physics, noise_level: float,
                            device: torch.device):
    """The :class:`~sei_tpu_torch.models.FunctionalModel` of a denoiser-prior
    kind: PnP (DPIR/HQS), DiffPIR_DRUNet or DiffPIR_DiffUNet (DiffPIR), DPS,
    at the measurement's noise level."""
    from . import FunctionalModel

    denoiser = make_denoiser(kind, weights_path, device)
    sigma = noise_level / 255.0
    if kind == "PlugAndPlay":
        fn = torch.no_grad()(lambda y: dpir_hqs(y, physics, denoiser, noise_level_img=sigma))
    elif kind in ("DiffPIR_DRUNet", "DiffPIR_DiffUNet"):
        fn = torch.no_grad()(lambda y: diffpir(y, physics, denoiser, noise_level_img=sigma))
    elif kind == "DPS":
        fn = lambda y: dps(y, physics, denoiser)  # noqa: E731
    else:
        raise ValueError(kind)
    return FunctionalModel(fn, kind, device)
