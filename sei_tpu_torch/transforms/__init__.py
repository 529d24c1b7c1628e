"""Transform groups for the equivariance loss (counterpart of
``sei_tpu/transforms/__init__.py``).

``ScalingTransform`` with ``kind="padded"`` is the paper's random rescaling
(per-image rate in {0.75, 0.5} and center, same-size output).  The
``normal`` kind, the antialiased pre-resize and the shift/rotate groups are
not ported yet (ROADMAP, Queue 1: data (the antialiased resize), and the
remaining methods and training modes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.scaling import padded_scaling_transform
from .crop import crop_offsets, crop_pair_batch, pad_min_size  # noqa: F401

DEFAULT_RATES = (0.75, 0.5)


@dataclasses.dataclass(frozen=True)
class ScalingTransform:
    """Random downscale by a per-image rate in {0.75, 0.5} around a random
    center, same-size output (reflected bicubic resampling)."""

    kind: str = "padded"
    antialias: bool = False

    def __post_init__(self):
        if self.kind != "padded":
            raise NotImplementedError(
                f"scaling kind {self.kind!r}: not ported yet "
                "(ROADMAP, Queue 1: remaining methods and training modes)")

    def sample_params(self, generator: torch.Generator, batch: int):
        """Per-image (rates, rate_idx, centers) with the reference
        distribution: index floor(n * U), center 2U - 1, drawn on the
        generator's device.  The rates are selected on the device from the
        index (no host-to-device copy, so a CUDA graph can hold the draw)."""
        n = len(DEFAULT_RATES)
        dev = generator.device
        u = torch.rand((batch,), generator=generator, device=dev)
        idx = torch.floor(n * u).long().clamp(0, n - 1)
        rates = torch.full((batch,), DEFAULT_RATES[0], dtype=torch.float32, device=dev)
        for i, rate in enumerate(DEFAULT_RATES[1:], 1):
            rates = torch.where(idx == i, rate, rates)
        centers = 2.0 * torch.rand((batch, 2), generator=generator, device=dev) - 1.0
        return rates, idx, centers

    def __call__(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, rates: Optional[torch.Tensor] = None,
                 centers: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Transform x (B, C, H, W); rates and centers are drawn from
        ``generator`` unless both are given."""
        if rates is None or centers is None:
            rates, _, centers = self.sample_params(generator, x.shape[0])
        return padded_scaling_transform(x, rates.to(x), centers.to(x),
                                        antialias=self.antialias)


def get_ei_transform(name: str, *, kind: str = "padded", antialias: bool = False):
    """Transform registry; only ``Scaling_Transforms`` is ported."""
    if name == "Scaling_Transforms":
        return ScalingTransform(kind=kind, antialias=antialias)
    if name in ("Rotations+Shifts", "Rotations", "Shifts"):
        raise NotImplementedError(
            f"{name}: not ported yet (ROADMAP, Queue 1: remaining methods and training "
            "modes: shift/rotate transforms)")
    raise ValueError(f"Unknown transforms: {name}")
