"""Transform groups for the equivariance loss (counterpart of
``sei_tpu/transforms/__init__.py``).

``ScalingTransform`` with ``kind="padded"`` is the paper's random rescaling
(per-image rate in {0.75, 0.5} and center, same-size output), with or
without the antialiased pre-resize; ``kind="normal"`` is one batch-wide
resize by a fixed rate (:meth:`ScalingTransform.normal_static`: the image
shrinks, so the trainer builds one step per rate).  :class:`Shift` and
:class:`Rotate` are the EI-shift and EI-rotate baselines (deepinv's
``Shift`` and ``Rotate``): one cyclic shift, or one integer angle in
1..359, for the whole batch.  Their draws come from the generator passed in
(the trainer's ``transform`` stream) and stay device tensors: the shift is a
gather, the angle's cosine and sine are taken on the device, so a CUDA graph
holds the step.

Every transform is called ``t(x, generator, **draws)``; a draw passed by
keyword (``rates`` and ``centers``; ``shifts``; ``angle``) replaces the
generator's, and the ones a transform does not take are ignored.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..ops.scaling import DEFAULT_RATES, normal_scaling_transform, padded_scaling_transform
from ..parallel import draw_rows
from .crop import crop_offsets, crop_pair_batch, pad_min_size  # noqa: F401

SCALING_KINDS = ("padded", "normal")


@dataclasses.dataclass(frozen=True)
class ScalingTransform:
    """Random downscale by a per-image rate in {0.75, 0.5} around a random
    center, same-size output (reflected bicubic resampling; ``antialias``:
    each image first resized by its rate, antialiased).  ``kind="normal"``:
    only :meth:`normal_static`, at a rate the caller fixes."""

    kind: str = "padded"
    antialias: bool = False

    def __post_init__(self):
        if self.kind not in SCALING_KINDS:
            raise ValueError(f"Unknown kind: {self.kind}")

    def sample_params(self, generator: torch.Generator, batch: int):
        """Per-image (rates, rate_idx, centers) with the reference
        distribution: index floor(n * U), center 2U - 1, drawn on the
        generator's device.  The rates are selected on the device from the
        index (no host-to-device copy, so a CUDA graph can hold the draw)."""
        n = len(DEFAULT_RATES)
        dev = generator.device
        u = draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), (batch,))
        idx = torch.floor(n * u).long().clamp(0, n - 1)
        rates = torch.full((batch,), DEFAULT_RATES[0], dtype=torch.float32, device=dev)
        for i, rate in enumerate(DEFAULT_RATES[1:], 1):
            rates = torch.where(idx == i, rate, rates)
        centers = 2.0 * draw_rows(lambda s: torch.rand(s, generator=generator, device=dev),
                                  (batch, 2)) - 1.0
        return rates, idx, centers

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, rates: Optional[torch.Tensor] = None,
                 centers: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        """Transform x (B, C, H, W); rates and centers are drawn from
        ``generator`` unless both are given."""
        if self.kind == "normal":
            raise ValueError("the normal kind's output size depends on its rate: "
                             "use normal_static")
        if rates is None or centers is None:
            rates, _, centers = self.sample_params(generator, x.shape[0])
        return padded_scaling_transform(x, rates.to(x), centers.to(x),
                                        antialias=self.antialias)

    def normal_static(self, rate: float, x: torch.Tensor) -> torch.Tensor:
        """The normal kind at a fixed rate: the whole batch resized by it."""
        return normal_scaling_transform(x, rate, antialias=self.antialias)


@dataclasses.dataclass(frozen=True)
class NormalScaling:
    """The normal kind as a transform of the loss: the batch resized by the
    fixed ``rate`` (no draw)."""

    rate: float
    antialias: bool = False

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 **_) -> torch.Tensor:
        return normal_scaling_transform(x, self.rate, antialias=self.antialias)


def _device(generator: Optional[torch.Generator], x: torch.Tensor) -> torch.device:
    return x.device if generator is None else generator.device


def roll(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, (sh, sw), (-2, -1))`` for a device tensor ``shifts``
    = (sh, sw), as two gathers: out[i] = x[(i - s) mod n]."""
    h, w = x.shape[-2:]
    shifts = shifts.to(x.device)
    rows = torch.remainder(torch.arange(h, device=x.device) - shifts[0], h)
    cols = torch.remainder(torch.arange(w, device=x.device) - shifts[1], w)
    return x.index_select(-2, rows).index_select(-1, cols)


def sample_shifts(generator: Optional[torch.Generator], h: int, w: int,
                  device=None) -> torch.Tensor:
    """(sh, sw) uniform over [0, h) x [0, w), an int64 device tensor."""
    dev = device if generator is None else generator.device
    sh = torch.randint(0, h, (1,), generator=generator, device=dev)
    sw = torch.randint(0, w, (1,), generator=generator, device=dev)
    return torch.cat([sh, sw])


@dataclasses.dataclass(frozen=True)
class Shift:
    """Random cyclic shift of the whole batch (deepinv ``Shift``)."""

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, shifts: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        if shifts is None:
            shifts = sample_shifts(generator, x.shape[-2], x.shape[-1], _device(generator, x))
        return roll(x, shifts)


def rotate_coords(h: int, w: int, angle_deg: torch.Tensor, dtype=torch.float32):
    """The source coordinates (sx, sy), each (h, w), that torchvision's
    rotation by ``angle_deg`` (counter-clockwise, about the image center)
    samples: its inverse affine map on the centered pixel grid with the
    half-pixel offset.  The angle in radians is rounded to ``dtype`` as the
    JAX package rounds it; its cosine and sine are taken in f64 and rounded
    once, which matches XLA's f32 cosine and sine more often than torch's
    own f32 ones do."""
    dev = angle_deg.device
    px = torch.arange(w, dtype=dtype, device=dev) - (w * 0.5 - 0.5)
    py = torch.arange(h, dtype=dtype, device=dev) - (h * 0.5 - 0.5)
    yy, xx = torch.meshgrid(py, px, indexing="ij")
    rot = -angle_deg.to(dtype) * (math.pi / 180.0)  # torchvision passes -angle
    ct = torch.cos(rot.double()).to(dtype)
    st = torch.sin(rot.double()).to(dtype)
    sx = ct * xx + st * yy + (w * 0.5 - 0.5)
    sy = -st * xx + ct * yy + (h * 0.5 - 0.5)
    return sx, sy


def rotate_image(x: torch.Tensor, angle_deg: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """torchvision's ``rotate(img, angle)`` of (..., H, W) (expand=False,
    fill 0, default center) as the JAX package computes it: grid_sample
    semantics with align_corners=False and zero padding; ``nearest`` rounds
    the source coordinate by floor(c + 0.5), ``bilinear`` interpolates.
    ``angle_deg`` is a 0-d tensor (degrees), on any device."""
    h, w = x.shape[-2:]
    sx, sy = rotate_coords(h, w, torch.as_tensor(angle_deg, device=x.device), x.dtype)

    def gather(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = x[..., iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
        return torch.where(inside, v, torch.zeros((), dtype=x.dtype, device=x.device))

    if mode == "nearest":
        return gather(torch.floor(sx + 0.5), torch.floor(sy + 0.5))
    if mode != "bilinear":
        raise ValueError(f"Unknown interpolation: {mode}")
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - x0, sy - y0
    top = gather(x0, y0) * (1 - tx) + gather(x0 + 1, y0) * tx
    bot = gather(x0, y0 + 1) * (1 - tx) + gather(x0 + 1, y0 + 1) * tx
    return top * (1 - ty) + bot * ty


def sample_rotate_angle(generator: Optional[torch.Generator], device=None) -> torch.Tensor:
    """deepinv v0.2.0 ``Rotate``'s draw: one integer degree uniform over
    1..359, a 0-d float32 device tensor."""
    dev = device if generator is None else generator.device
    return torch.randint(1, 360, (), generator=generator, device=dev).float()


@dataclasses.dataclass(frozen=True)
class Rotate:
    """Random rotation of the whole batch by one integer degree in 1..359
    (deepinv ``Rotate`` with torchvision's default nearest interpolation)."""

    mode: str = "nearest"

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, angle: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        if angle is None:
            angle = sample_rotate_angle(generator, _device(generator, x))
        return rotate_image(x, angle, mode=self.mode)


@dataclasses.dataclass(frozen=True)
class Combined:
    """The transforms applied in order, each with its own draws from the
    one generator (the JAX package's ``combined``, one split key each)."""

    transforms: Sequence

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 **draws) -> torch.Tensor:
        for t in self.transforms:
            x = t(x, generator, **draws)
        return x


def get_ei_transform(name: str, *, kind: str = "padded", antialias: bool = False,
                     normal_rate: Optional[float] = None):
    """Transform registry (``sei_tpu/transforms/__init__.py:164-177``);
    ``normal_rate``: the normal scaling kind's fixed rate."""
    if name == "Scaling_Transforms":
        if kind == "normal":
            if normal_rate is None:
                raise ValueError("the normal scaling kind needs a fixed rate per step: build "
                                 "one loss per rate (the trainer's normal_rate_losses)")
            return NormalScaling(normal_rate, antialias)
        return ScalingTransform(kind=kind, antialias=antialias)
    if name == "Rotations+Shifts":
        return Combined((Rotate(), Shift()))
    if name == "Rotations":
        return Rotate()
    if name == "Shifts":
        return Shift()
    raise ValueError(f"Unknown transforms: {name}")
