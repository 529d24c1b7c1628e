"""Training losses (counterpart of ``sei_tpu/losses/__init__.py``).

  supervised / css / noise2inverse -> MSE on the (x, y) pair (supervised
                with ``supervised_l1``: the mean absolute error);
  sure       -> MC-SURE in measurement space;
  proposed   -> SURE + EI under a transform group (the padded scaling
                transform by default; ``transforms`` ``Rotations``,
                ``Shifts`` or ``Rotations+Shifts``, the EI-rotate and
                EI-shift baselines; the ``normal`` scaling kind at the fixed
                ``fixed_normal_rate``, one loss per rate), with optional
                stop-gradient on the transformed branch; with
                ``sure_alternative="r2r"`` R2R-EI in SURE's place
                (:mod:`.r2r`: one 2B forward on [y + pert/2, y + eps1], then
                the EI forward; ``alpha_tradeoff`` does not apply there, as in
                the JAX package).

A loss is ``loss(x, y, model, rng=None, draws=None) -> scalar``: ``model``
maps a measurement batch to an estimate, ``rng`` holds the trainer's
generators (:class:`sei_tpu_torch.rng.Streams`: ``crop``, ``probe``,
``transform``), and ``draws`` (:class:`LossDraws`) can pass any random input
explicitly instead (the golden tests hand both packages the same draws).
The pre-loss aligned 48-px crop of the reference is applied first (for SR
x cropped ``rate`` times as large, ``xy_size_ratio``).  Each draw takes the
shape of what it acts on: the SURE probe and R2R's noises y's, the scaling
parameters the estimate's (``rate`` times y's size for SR).  A
``sure_alternative`` other than ``"r2r"`` keeps SURE, as the JAX package
does; ``sure_rate_hotfix`` (the reference's ``_TEMPORARY_HOTFIX``) scales
``proposed``'s SURE term by ``rate ** 2``.  :mod:`.weights_distance` is the
fine-tuning regularizer the trainer adds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..transforms import crop_pair_batch, get_ei_transform
from .r2r import r2r_ei_loss, r2r_loss
from .sure import (  # noqa: F401
    mc_divergence,
    sample_probe,
    sure_gaussian_loss,
    sure_gaussian_loss_from_outputs,
)
from .weights_distance import weights_distance_loss

METHOD_ALIASES = {
    "sup": "supervised",
    "ei-shift": ("proposed", "Shifts"),
    "ei-rotate": ("proposed", "Rotations"),
}
METHODS = ("supervised", "css", "noise2inverse", "sure", "proposed")
TAU = 1e-2


def normalize_method(method: str, transforms: str) -> tuple[str, str]:
    """Resolve README aliases to (method, ProposedLoss__transforms)."""
    if method in METHOD_ALIASES:
        v = METHOD_ALIASES[method]
        return v if isinstance(v, tuple) else (v, transforms)
    if method not in METHODS:
        raise ValueError(f"Unknown method: {method}")
    return method, transforms


def _mse(a, b):
    d = a - b
    return torch.mean(d * d)


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


@dataclasses.dataclass
class LossDraws:
    """The random inputs of one loss evaluation; a field left None is drawn
    from the matching generator of ``rng``."""

    crop: Optional[torch.Tensor] = None     # (B, 2) int offsets of the loss crop
    probe: Optional[torch.Tensor] = None    # SURE probe b, the cropped y's shape
    rates: Optional[torch.Tensor] = None    # (B,) scaling rates
    centers: Optional[torch.Tensor] = None  # (B, 2) scaling centers (cx, cy)
    angle: Optional[torch.Tensor] = None    # 0-d rotation angle in degrees
    shifts: Optional[torch.Tensor] = None   # (2,) cyclic shift (rows, columns)
    # R2R-EI's noises as added to the cropped y: pert ~ N(0, sigma^2),
    # eps1 ~ N(0, (sigma / 2)^2), eps2 ~ N(0, (3 sigma / 2)^2)
    pert: Optional[torch.Tensor] = None
    eps1: Optional[torch.Tensor] = None
    eps2: Optional[torch.Tensor] = None

    def transform_draws(self) -> dict:
        """The draws a transform takes, by keyword."""
        return {"rates": self.rates, "centers": self.centers, "angle": self.angle,
                "shifts": self.shifts}


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Everything ``get_loss`` derives from flags."""

    method: str = "proposed"
    noise_level: float = 5.0
    sure_cropped_div: bool = True
    sure_averaged_cst: bool = False
    sure_margin: int = 0
    stop_gradient: bool = True
    sure_alternative: Optional[str] = None
    alpha_tradeoff: float = 1.0
    transforms: str = "Scaling_Transforms"
    scaling_kind: str = "padded"
    scaling_antialias: bool = False
    crop_training_pairs: bool = True
    crop_size: int = 48
    xy_size_ratio: int = 1
    supervised_l1: bool = False
    sure_rate_hotfix: Optional[float] = None  # SURE term times this squared
    # the normal scaling kind's rate: its output size depends on it, so each
    # rate is a loss of its own (the trainer's normal_rate_losses)
    fixed_normal_rate: Optional[float] = None

    @property
    def sigma(self) -> float:
        return self.noise_level / 255.0

    def _sure(self, y, model, A, rng, draws: LossDraws):
        """SURE with f(y) and f(y + tau b) as one 2B forward -> (loss, x_net)."""
        b = draws.probe
        if b is None:
            b = sample_probe(rng.probe, y, self.sure_margin if self.sure_cropped_div else 0)
        x_net, x_tau = model(torch.cat([y, y + b * TAU])).chunk(2)
        loss = sure_gaussian_loss_from_outputs(
            y, x_net, x_tau, b, A, sigma=self.sigma, tau=TAU,
            margin=self.sure_margin, cropped_div=self.sure_cropped_div,
            averaged_cst=self.sure_averaged_cst)
        return loss, x_net

    def build(self, A: Callable) -> Callable:
        """Return ``loss(x, y, model, rng=None, draws=None) -> scalar``."""
        method = self.method
        if method in ("supervised", "css", "noise2inverse"):
            metric = _l1 if method == "supervised" and self.supervised_l1 else _mse

            def fn(x, y, model, rng, draws):
                return metric(model(y), x)

        elif method == "sure":

            def fn(x, y, model, rng, draws):
                return self._sure(y, model, A, rng, draws)[0]

        elif method == "proposed":
            transform = get_ei_transform(self.transforms, kind=self.scaling_kind,
                                         antialias=self.scaling_antialias,
                                         normal_rate=self.fixed_normal_rate)

            if self.sure_alternative == "r2r":

                def fn(x, y, model, rng, draws):
                    return r2r_ei_loss(y, model, A, transform, sigma=self.sigma,
                                       stop_gradient=self.stop_gradient, rng=rng, draws=draws)

            else:

                def fn(x, y, model, rng, draws):
                    loss, x_net = self._sure(y, model, A, rng, draws)
                    if self.sure_rate_hotfix is not None:
                        loss = self.sure_rate_hotfix ** 2 * loss
                    # EI term: x2 = T(x_net) (stop-grad optional), x3 =
                    # f(A(x2)).  This forward cannot join the 2B one: its
                    # input depends on x_net's value.
                    x2 = transform(x_net, None if rng is None else rng.transform,
                                   **draws.transform_draws())
                    if self.stop_gradient:
                        x2 = x2.detach()
                    x3 = model(A(x2))
                    return loss + self.alpha_tradeoff * _mse(x3, x2)

        else:
            raise ValueError(f"Unknown method: {method}")

        def loss(x, y, model, rng=None, draws: Optional[LossDraws] = None):
            draws = draws or LossDraws()
            if self.crop_training_pairs:
                x, y = crop_pair_batch(x, y, size=self.crop_size,
                                       xy_size_ratio=self.xy_size_ratio, offsets=draws.crop,
                                       generator=None if rng is None else rng.crop)
            return fn(x, y, model, rng, draws)

        return loss


def compute_sure_margin(*, partial_sure: bool, sure_margin: Optional[int], task: str,
                        kernel_shape: Optional[tuple] = None,
                        partial_sure_sr: bool = False) -> int:
    """The SURE margin: explicit, or half the blur kernel for deblurring."""
    if not partial_sure:
        if sure_margin is not None:
            raise ValueError("sure_margin needs partial_sure")
        return 0
    if sure_margin is not None:
        return sure_margin
    if task == "deblurring":
        if kernel_shape is None:
            raise ValueError("deblurring needs the kernel shape for the SURE margin")
        return (max(kernel_shape[-2], kernel_shape[-1]) - 1) // 2
    if task == "sr":
        return 2 if partial_sure_sr else 0
    return 0


def get_loss(*, method: str, physics, noise_level: float = 5.0,
             partial_sure: bool = True, partial_sure_sr: bool = False,
             sure_margin: Optional[int] = None, sure_cropped_div: bool = True,
             sure_averaged_cst: Optional[bool] = None, stop_gradient: bool = True,
             sure_alternative: Optional[str] = None, alpha_tradeoff: float = 1.0,
             transforms: str = "Scaling_Transforms", scaling_kind: str = "padded",
             scaling_antialias: bool = False, crop_training_pairs: bool = True,
             crop_size: int = 48, supervised_l1: bool = False,
             fixed_normal_rate: Optional[float] = None,
             sure_rate_hotfix: bool = False) -> Callable:
    """Factory mirroring ``sei_tpu.losses.get_loss``; the loss crop's ratio
    is the physics' SR rate (else 1)."""
    rate = physics.rate if physics.task == "sr" else 1
    method, transforms = normalize_method(method, transforms)
    margin = compute_sure_margin(
        partial_sure=partial_sure, sure_margin=sure_margin, task=physics.task,
        kernel_shape=None if physics.kernel is None else tuple(physics.kernel.shape),
        partial_sure_sr=partial_sure_sr)
    cfg = LossConfig(
        method=method, noise_level=noise_level, sure_cropped_div=sure_cropped_div,
        sure_averaged_cst=bool(sure_averaged_cst), sure_margin=margin,
        stop_gradient=stop_gradient, sure_alternative=sure_alternative,
        alpha_tradeoff=alpha_tradeoff, transforms=transforms, scaling_kind=scaling_kind,
        scaling_antialias=scaling_antialias, crop_training_pairs=crop_training_pairs,
        crop_size=crop_size, xy_size_ratio=rate, supervised_l1=supervised_l1,
        fixed_normal_rate=fixed_normal_rate,
        sure_rate_hotfix=float(physics.rate) if sure_rate_hotfix else None)
    return cfg.build(physics.A)


__all__ = ["LossConfig", "LossDraws", "METHODS", "compute_sure_margin", "get_loss",
           "mc_divergence", "normalize_method", "r2r_ei_loss", "r2r_loss", "sample_probe",
           "sure_gaussian_loss", "sure_gaussian_loss_from_outputs", "weights_distance_loss"]
