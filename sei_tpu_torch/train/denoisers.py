"""The denoiser priors' training steps (counterpart of
``experiments/train_drunet.py`` and ``experiments/train_diffunet.py``).

The JAX scripts train the networks behind PlugAndPlay, DiffPIR and DPS on
the dead-leaves Div2K stand-in: a blind Gaussian DRUNet and a DDPM
epsilon-prediction DiffUNet.  Their step is a closure inside ``main()``;
here each piece is a function on tensors, its randomness drawn from an
explicit ``torch.Generator`` on the data's device, so the command lines
(``cli/train_drunet.py``, ``cli/train_diffunet.py``) draw on the card and
the tests hand both packages the same draws.

* :func:`load_cache`: every training image zero-padded to the largest
  (hmax, wmax) and stored in float16, with each image's h and w
  (``train_drunet.py:50-64``).
* :func:`draw_crops` / :func:`take_crops`: ``batch`` images drawn
  uniformly, one offset per image in ``[0, max(h - crop + 1, 1))`` on each
  axis, and a (3, crop, crop) window of the padded image (a start clamped
  as ``lax.dynamic_slice`` clamps it), in f32 (:75-87).
* :func:`drunet_loss`: one sigma per batch, U(0, sigma_max) or
  log-uniform on [1e-3, sigma_max] (:func:`draw_sigma`); ``y = x + sigma
  n``; the MSE of ``net(y, sigma)``, divided by sigma^2 + 1e-4 in log mode
  (:88-101).
* :func:`diffunet_loss`: x0 -> 2 x0 - 1, t ~ U{0..999} per image, ``x_t =
  sqrt(abar_t) x0 + sqrt(1 - abar_t) eps`` (linear betas, T = 1000), the
  MSE of the first three output channels against eps; the variance
  channels stay at their zero init (``train_diffunet.py:101-124``).
* :func:`lecun_init_`: flax's default initialisation (truncated-normal
  LeCun kernels, zero biases, GroupNorm 1 / 0) and DiffUNet's zero-init
  output convs, so a run starts from the JAX scripts' distribution.
* Adam without a schedule, optax's defaults: ``train.optim.get_optimizer``
  at its defaults.

Nothing in a step reads the device from the host: sigma stays a 0-d tensor
(``DRUNet.forward`` broadcasts it), and :func:`fit` reads the loss only at
its logging steps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..models.diffunet import ddpm_alphas_cumprod

DDPM_STEPS = 1000
LOG_SIGMA_MIN = 1e-3
LOG_WEIGHT_EPS = 1e-4


@dataclasses.dataclass
class CropCache:
    """The training images, zero-padded: ``data`` (N, 3, hmax, wmax) float16,
    ``hs`` / ``ws`` (N,) int64, each on the training device."""

    data: torch.Tensor
    hs: torch.Tensor
    ws: torch.Tensor

    def __len__(self) -> int:
        return self.data.shape[0]


def load_cache(images: Sequence[np.ndarray], device) -> CropCache:
    """(3, h, w) images -> a :class:`CropCache` on ``device``."""
    hmax = max(im.shape[-2] for im in images)
    wmax = max(im.shape[-1] for im in images)
    xpad = np.zeros((len(images), 3, hmax, wmax), np.float16)
    for i, im in enumerate(images):
        xpad[i, :, : im.shape[-2], : im.shape[-1]] = im
    hw = torch.as_tensor([im.shape[-2:] for im in images], dtype=torch.int64)
    return CropCache(torch.from_numpy(xpad).to(device), hw[:, 0].to(device), hw[:, 1].to(device))


def draw_crops(cache: CropCache, batch: int, crop: int,
               gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image indices, row offsets, column offsets), each (batch,) int64."""
    dev = cache.data.device
    idx = torch.randint(0, len(cache), (batch,), generator=gen, device=dev)

    def offset(extent):
        hi = (extent[idx] - crop + 1).clamp_min(1)
        u = torch.rand(batch, generator=gen, device=dev, dtype=torch.float64)
        return torch.minimum((u * hi).long(), hi - 1)

    return idx, offset(cache.hs), offset(cache.ws)


def take_crops(cache: CropCache, idx: torch.Tensor, oi: torch.Tensor, oj: torch.Tensor,
               crop: int) -> torch.Tensor:
    """The (batch, 3, crop, crop) f32 windows at (oi, oj) of images ``idx``."""
    hmax, wmax = cache.data.shape[-2:]
    if crop > min(hmax, wmax):
        raise ValueError(f"crop {crop} exceeds the padded images ({hmax}x{wmax})")
    r = torch.arange(crop, device=cache.data.device)
    rows = (oi.clamp(max=hmax - crop)[:, None] + r)[:, None, :, None]
    cols = (oj.clamp(max=wmax - crop)[:, None] + r)[:, None, None, :]
    ch = torch.arange(3, device=cache.data.device)[None, :, None, None]
    return cache.data[idx[:, None, None, None], ch, rows, cols].float()


def sample_crops(cache: CropCache, batch: int, crop: int, gen: torch.Generator) -> torch.Tensor:
    return take_crops(cache, *draw_crops(cache, batch, crop, gen), crop)


def draw_sigma(gen: torch.Generator, sigma_max: float, dist: str, device) -> torch.Tensor:
    """One noise level, a 0-d f32 tensor on ``device``."""
    u = torch.rand((), generator=gen, device=device)
    if dist == "log":
        lo, hi = math.log(LOG_SIGMA_MIN), math.log(sigma_max)
        return torch.exp(u * (hi - lo) + lo)
    if dist == "uniform":
        return u * sigma_max
    raise ValueError(f"sigma_dist: uniform or log, got {dist!r}")


def drunet_loss(net, x: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor,
                log_weight: bool) -> torch.Tensor:
    mse = torch.mean((net(x + sigma * noise, sigma) - x) ** 2)
    # the residual's variance scales as sigma^2: without the weight the top
    # decade of a log range swamps the gradient
    return mse / (sigma**2 + LOG_WEIGHT_EPS) if log_weight else mse


def diffunet_loss(net, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
                  abar: torch.Tensor) -> torch.Tensor:
    x0 = 2.0 * x0 - 1.0  # the diffusion's range
    a = abar[t][:, None, None, None]
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    return torch.mean((net(xt, t)[:, :3] - eps) ** 2)


def ddpm_abar(device) -> torch.Tensor:
    return torch.as_tensor(ddpm_alphas_cumprod(DDPM_STEPS), dtype=torch.float32, device=device)


def drunet_draws(cache: CropCache, gen: torch.Generator, *, batch: int, crop: int,
                 sigma_max: float, sigma_dist: str) -> tuple:
    """One step's (x, sigma, noise)."""
    x = sample_crops(cache, batch, crop, gen)
    sigma = draw_sigma(gen, sigma_max, sigma_dist, x.device)
    return x, sigma, torch.randn(x.shape, generator=gen, device=x.device)


def diffunet_draws(cache: CropCache, gen: torch.Generator, *, batch: int, crop: int) -> tuple:
    """One step's (x0, t, eps)."""
    x0 = sample_crops(cache, batch, crop, gen)
    t = torch.randint(0, DDPM_STEPS, (batch,), generator=gen, device=x0.device)
    return x0, t, torch.randn(x0.shape, generator=gen, device=x0.device)


def lecun_init_(net: torch.nn.Module, gen: torch.Generator,
                zero: Callable[[str], bool] = lambda name: False) -> torch.nn.Module:
    """flax's defaults on ``net`` in place: each conv / linear kernel from a
    normal truncated at 2 std, std sqrt(1 / fan_in) / 0.8796 (flax's
    ``lecun_normal``; fan_in = in x kh x kw, a transposed conv's too), the
    modules ``zero`` names all zero, every bias 0, GroupNorm 1 / 0."""
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                torch.nn.Linear)):
                w = m.weight
                if zero(name):
                    w.zero_()
                else:
                    fan_in = (w[:, 0] if isinstance(m, torch.nn.ConvTranspose2d) else w[0]).numel()
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return net


def diffunet_zero_init(name: str) -> bool:
    """DiffUNet's zero-initialised kernels: each residual block's output
    conv, each attention's projection and the final conv."""
    return name == "out.2" or name.endswith(("out_layers.3", "proj_out"))


def train_step(net: torch.nn.Module, opt: torch.optim.Optimizer, loss_fn: Callable,
               *draws) -> torch.Tensor:
    """One Adam step on ``loss_fn(net, *draws)``; returns the loss, detached
    and left on the device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(net, *draws)
    loss.backward()
    opt.step()
    return loss.detach()


def fit(step: Callable[[], torch.Tensor], steps: int, *, log_every: int = 500,
        suffix: str = "", log=print) -> List[Tuple[int, float]]:
    """``steps`` calls of ``step``; every ``log_every`` steps one line,
    ``step i/steps loss L (r it/s)`` as the JAX scripts print it (then
    ``suffix``).  Returns the logged (step, loss) pairs; the loss is read
    on the host at those steps only."""
    logged = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step()
        if (i + 1) % log_every == 0:
            value = float(loss)
            logged.append((i + 1, value))
            log(f"step {i + 1}/{steps} loss {value:.3e} "
                f"({(i + 1) / (time.perf_counter() - t0):.1f} it/s){suffix}")
    return logged
