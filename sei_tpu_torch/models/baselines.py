"""Classical baselines that need no training (counterpart of
``sei_tpu/models/baselines.py``): InverseFilter (``physics.A_dagger``), TV
(projected gradient with a total-variation prox), and the Deep Image Prior
(a fresh ConvDecoder fitted to each measurement).  ``Identity`` and
``Upsample`` live in :mod:`sei_tpu_torch.models` as before.

Each returns a function of the measurement y (B, C, h, w) on the physics'
device; :class:`sei_tpu_torch.models.FunctionalModel` wraps it as a model
kind.  The loops run eagerly, one launch at a time: the JAX package left
them to XLA (``lax.fori_loop``), outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..train.optim import get_optimizer


def inverse_filter_model(physics):
    return lambda y: physics.A_dagger(y)


def _grad(u: torch.Tensor):
    """Forward differences, zero at the last row / column."""
    gx = torch.diff(u, dim=-1, append=u[..., -1:])
    gy = torch.diff(u, dim=-2, append=u[..., -1:, :])
    return gx, gy


def _div(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Minus the adjoint of :func:`_grad`."""
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]], dim=-1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :], -py[..., -2:-1, :]],
                   dim=-2)
    return dx + dy


def tv_prox_chambolle(x: torch.Tensor, lambd: float, iters: int = 20) -> torch.Tensor:
    """Prox of lambd * TV (isotropic) by Chambolle's dual projection, step
    1/4 (``sei_tpu/models/baselines.py:36-64``)."""
    tau = 0.25
    px = torch.zeros_like(x)
    py = torch.zeros_like(x)
    for _ in range(iters):
        gx, gy = _grad(_div(px, py) - x / lambd)
        denom = 1.0 + tau * torch.sqrt(gx * gx + gy * gy)
        px, py = (px + tau * gx) / denom, (py + tau * gy) / denom
    return x - lambd * _div(px, py)


def tv_model(physics, *, lambd: Optional[float] = None, max_iter: int = 300):
    """Proximal gradient descent on ||A x - y||^2 / 2 + lambd TV(x) from
    x0 = A^T y, step 1 (the operators' Lipschitz constant is at most 1),
    lambd 0.1 by default (``sei_tpu/models/baselines.py:67-84``)."""
    lam = 0.1 if lambd is None else lambd

    def solve(y):
        x = physics.A_adjoint(y)
        for _ in range(max_iter):
            x = tv_prox_chambolle(x - physics.A_adjoint(physics.A(x) - y), lam)
        return x

    return solve


# ---------------------------------------------------------------------------
# Deep Image Prior
# ---------------------------------------------------------------------------


def conv_decoder_sizes(in_size, out_size, layers: int) -> list:
    """deepinv ConvDecoder's geometric size schedule: layers - 2 sizes
    ceil(scale^n * in_size), then the output size."""
    sx = (out_size[0] / in_size[0]) ** (1.0 / (layers - 1))
    sy = (out_size[1] / in_size[1]) ** (1.0 / (layers - 1))
    hidden = [(int(np.ceil(sx**n * in_size[0])), int(np.ceil(sy**n * in_size[1])))
              for n in range(1, layers - 1)]
    return hidden + [tuple(out_size)]


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    """``nn.Upsample(mode="nearest")`` with its source rows and columns
    floor(i * in / out) taken in float64, as the JAX package takes them
    (``F.interpolate``'s f32 scale picks other rows at some sizes)."""
    h_in, w_in = x.shape[-2:]
    iy = np.floor(np.arange(size[0]) * (h_in / size[0])).astype(np.int64)
    ix = np.floor(np.arange(size[1]) * (w_in / size[1])).astype(np.int64)
    x = x.index_select(-2, torch.as_tensor(iy, device=x.device))
    return x.index_select(-1, torch.as_tensor(ix, device=x.device))


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d with the batch's statistics (biased variance)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale[None, :, None, None] + bias[None, :, None, None]


def conv_decoder_apply(params: dict, z: torch.Tensor, sizes: list) -> torch.Tensor:
    """deepinv ConvDecoder forward: per size, nearest upsample -> 3x3 conv ->
    ReLU -> BatchNorm; one more 3x3 conv -> ReLU -> BatchNorm at full size;
    a 1x1 head.  ``params``: ``convs`` / ``head`` ({weight (OIHW), bias}),
    ``bn_scale`` / ``bn_bias`` (one per conv)."""
    x = z
    for i in range(len(sizes) + 1):
        if i < len(sizes):
            x = nearest_resize(x, sizes[i])
        w = params["convs"][i]
        x = F.relu(F.conv2d(x, w["weight"], w["bias"], padding=1))
        x = batch_norm_train(x, params["bn_scale"][i], params["bn_bias"][i])
    return F.conv2d(x, params["head"]["weight"], params["head"]["bias"])


def dip_init(batch: int, sizes: list, *, channels: int = 32, in_size=(16, 16),
             generator: Optional[torch.Generator] = None, device=None):
    """(latent z, decoder params): z uniform in [0, 0.1), each 3x3 conv
    He-normal, the head N(0, 2 / channels), biases 0, BatchNorm 1 / 0; drawn
    on the CPU from ``generator`` (default seeded 0), then moved to
    ``device``."""
    g = torch.Generator().manual_seed(0) if generator is None else generator

    def normal(*shape, std):
        return (torch.randn(shape, generator=g) * std).to(device)

    z = (torch.rand((batch, channels, *in_size), generator=g) * 0.1).to(device)
    n_convs = len(sizes) + 1
    convs = [{"weight": normal(channels, channels, 3, 3, std=np.sqrt(2.0 / (channels * 9))),
              "bias": torch.zeros(channels, device=device)} for _ in range(n_convs)]
    params = {
        "convs": convs,
        "head": {"weight": normal(3, channels, 1, 1, std=np.sqrt(2.0 / channels)),
                 "bias": torch.zeros(3, device=device)},
        "bn_scale": [torch.ones(channels, device=device) for _ in range(n_convs)],
        "bn_bias": [torch.zeros(channels, device=device) for _ in range(n_convs)],
    }
    return z, params


def _leaves(params: dict) -> list:
    return [*(v for c in params["convs"] for v in c.values()), *params["head"].values(),
            *params["bn_scale"], *params["bn_bias"]]


def dip_model(physics, *, iterations: int = 1000, sr_factor: Optional[int] = None,
              channels: int = 32, layers: int = 7, in_size=(16, 16), lr: float = 5e-3):
    """Deep-image-prior reconstruction (``sei_tpu/models/baselines.py:149-213``):
    a fresh ConvDecoder (``layers`` blocks from ``in_size`` to the output
    size, ``channels`` wide) is fitted to each measurement by ``iterations``
    steps of Adam at ``lr`` on mean((A(f(z)) - y)^2), and f(z) returned.
    ``solve(y, init=None)``: ``init`` is (z, params) as :func:`dip_init`
    returns them (default: :func:`dip_init` seeded 0); the JAX solve draws
    them from ``PRNGKey(0)``."""

    def solve(y, init=None):
        rate = sr_factor if (sr_factor and physics.task == "sr") else 1
        sizes = conv_decoder_sizes(in_size, (y.shape[-2] * rate, y.shape[-1] * rate), layers)
        if init is None:
            init = dip_init(y.shape[0], sizes, channels=channels, in_size=in_size,
                            device=y.device)
        z, params = init
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = get_optimizer(leaves, kind="Adam", lr=lr)
        with torch.enable_grad():
            for _ in range(iterations):
                opt.zero_grad(set_to_none=True)
                r = physics.A(conv_decoder_apply(params, z, sizes)) - y
                torch.mean(r * r).backward()
                opt.step()
        with torch.no_grad():
            return conv_decoder_apply(params, z, sizes)

    return solve
