"""Recorrupted-to-Recorrupted losses (counterpart of ``sei_tpu/losses/r2r.py``).

R2R:    mse(A(f(y + alpha*pert)), y - pert/alpha),  pert ~ N(0, eta^2)
R2R-EI: R2R + equivariance with consistent input noise:
        x1 = f(y + eps1), eps1 = 0.5 sigma N; x2 = T(x1) (optionally
        detached); x3 = f(A(x2) + eps2), eps2 = 1.5 sigma N; + mse(x3, x2)

``r2r_ei_loss`` is the JAX package's fused form: the R2R evaluation
f(y + pert/2) and the EI anchor f(y + eps1) are independent given y, so they
run as one 2B forward; only f(A(T(x1)) + eps2) is a second one, as its input
depends on x1's value.  It runs the same forwards and backward as
``proposed`` (SURE's 2B forward, then the EI forward).

The noises come from the trainer's ``probe`` stream (R2R takes SURE's
place, so it draws from SURE's generator: pert, eps1, then eps2), the
transform's draws from ``transform``; a :class:`LossDraws` field that is set
is used as it is (the noise as it is added to y).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel import draw_rows

ALPHA = 0.5


def _mse(a, b):
    d = a - b
    return torch.mean(d * d)


def _normal(generator: Optional[torch.Generator], like: torch.Tensor, scale: float):
    """``scale`` * N(0, I) of ``like``'s shape and dtype, drawn on the
    generator's device (a CUDA graph holds the draw)."""
    dev = like.device if generator is None else generator.device
    n = draw_rows(lambda s: torch.randn(s, generator=generator, device=dev, dtype=like.dtype),
                  like.shape)
    return scale * n.to(like.device)


def r2r_loss(y: torch.Tensor, model: Callable, A: Callable, *, eta: float,
             alpha: float = ALPHA, generator: Optional[torch.Generator] = None,
             pert: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mse(A(f(y + alpha*pert)), y - pert/alpha), ``pert`` ~ N(0, eta^2)
    from ``generator`` unless given."""
    if pert is None:
        pert = _normal(generator, y, eta)
    return _mse(A(model(y + pert * alpha)), y - pert / alpha)


def r2r_ei_loss(y: torch.Tensor, model: Callable, A: Callable, transform: Callable, *,
                sigma: float, stop_gradient: bool = True, rng=None, draws=None) -> torch.Tensor:
    """R2R + EI in the fused form (``sei_tpu/losses/r2r.py:38-71``).

    ``rng``: the trainer's streams (``probe`` for pert, eps1, eps2;
    ``transform`` for the transform's draws); ``draws``: a
    :class:`~sei_tpu_torch.losses.LossDraws` whose set fields replace the
    draws."""
    probe = None if rng is None else rng.probe
    pert = getattr(draws, "pert", None)
    pert = _normal(probe, y, sigma) if pert is None else pert
    eps1 = getattr(draws, "eps1", None)
    eps1 = _normal(probe, y, 0.5 * sigma) if eps1 is None else eps1
    x_r2r, x1 = model(torch.cat([y + pert * ALPHA, y + eps1])).chunk(2)
    loss = _mse(A(x_r2r), y - pert / ALPHA)

    x2 = transform(x1, None if rng is None else rng.transform,
                   **({} if draws is None else draws.transform_draws()))
    if stop_gradient:
        x2 = x2.detach()
    y2 = A(x2)
    eps2 = getattr(draws, "eps2", None)
    eps2 = _normal(probe, y2, 1.5 * sigma) if eps2 is None else eps2
    x3 = model(y2 + eps2)
    return loss + _mse(x3, x2)
