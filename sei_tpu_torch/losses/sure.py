"""MC-SURE Gaussian loss (counterpart of ``sei_tpu/losses/sure.py``).

loss = ||A(f(y)) - y||^2_margin + 2 sigma^2 * div - cst
div  = mean( b * (A(f(y + tau b)) - A(f(y))) / tau ),  b ~ N(0, I)

``margin`` zeroes the probe outside an inner window and crops the MSE/div to
ignore circular-blur boundary effects; ``averaged_cst`` toggles whether the
sigma^2 constant is divided by the batch size.  The probe comes from an
explicit ``torch.Generator`` (or is passed in).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel import draw_rows, global_rows


def _crop_margin(t: torch.Tensor, m: int) -> torch.Tensor:
    return t if m == 0 else t[..., m:-m, m:-m]


def sample_probe(generator: torch.Generator, y: torch.Tensor, margin: int = 0) -> torch.Tensor:
    """The MC probe b ~ N(0, I) of y's shape, zeroed outside the margin window."""
    b = draw_rows(lambda s: torch.randn(s, generator=generator, device=generator.device,
                                        dtype=y.dtype), y.shape).to(y.device)
    if margin:
        mask = torch.zeros_like(y)
        mask[..., margin:-margin, margin:-margin] = 1.0
        b = b * mask
    return b


def mc_divergence(generator: torch.Generator, y, y1, model: Callable, A: Callable, *,
                  tau: float, margin: int = 0) -> torch.Tensor:
    """Monte-Carlo divergence estimate with a fresh probe."""
    b = sample_probe(generator, y, margin)
    y2 = A(model(y + b * tau))
    return _crop_margin(b * (y2 - y1) / tau, margin).mean()


def sure_gaussian_loss_from_outputs(y, x_net, x_tau, b, A: Callable, *, sigma: float,
                                    tau: float = 1e-2, margin: int = 0,
                                    cropped_div: bool = False,
                                    averaged_cst: bool = False) -> torch.Tensor:
    """SURE given the model outputs f(y) and f(y + tau b), so the two
    evaluations can run as one 2B forward."""
    sigma2 = sigma * sigma
    y1 = A(x_net)
    y2 = A(x_tau)
    out = _crop_margin(b * (y2 - y1) / tau, margin if cropped_div else 0)
    div = 2.0 * sigma2 * out.mean()
    mse = _crop_margin(y1 - y, margin)
    mse = torch.mean(mse * mse)
    cst = sigma2 if averaged_cst else sigma2 / global_rows(y.shape[0])
    return mse + div - cst


def sure_gaussian_loss(generator: torch.Generator, y, x_net, model: Callable, A: Callable,
                       *, sigma: float, tau: float = 1e-2, margin: int = 0,
                       cropped_div: bool = False, averaged_cst: bool = False) -> torch.Tensor:
    """SURE estimate of the measurement-space MSE (never sees ground truth)."""
    sigma2 = sigma * sigma
    y1 = A(x_net)
    div = 2.0 * sigma2 * mc_divergence(generator, y, y1, model, A, tau=tau,
                                       margin=margin if cropped_div else 0)
    mse = _crop_margin(y1 - y, margin)
    mse = torch.mean(mse * mse)
    cst = sigma2 if averaged_cst else sigma2 / global_rows(y.shape[0])
    return mse + div - cst
