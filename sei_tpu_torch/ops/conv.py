"""3x3 'same' convolution: counterpart of ``sei_tpu/ops/conv_mm.py`` Conv3x3.

The JAX package computes this outside any Pallas kernel (XLA's convolution),
so the port uses cuDNN through ``nn.Conv2d``; TF32 is off
(``sei_tpu_torch.device.resolve_device``), matching the f32 reference.  With
a ``compute_dtype`` (bf16, the model's compute dtype) it casts as the flax
module with ``dtype`` does (``conv_mm.py`` :139-150, :172-173): the input and
the f32 weight are cast, the convolution's output is in that dtype, and the
bias, cast too, is added in it.  The parameters stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` on NCHW tensors, computed in
    ``compute_dtype`` when one is given."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size=3, padding=1)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if cdt is None:
            return super().forward(x)
        y = F.conv2d(x.to(cdt), self.weight.to(cdt), None, padding=1)
        return y + self.bias.to(cdt)[:, None, None]

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """The JAX package's init: Uniform(+-1/sqrt(fan_in)) weights (torch's
        kaiming_uniform(a=sqrt(5)) variance 1/(3 fan_in)), zero bias."""
        fan_in = self.in_channels * 9
        bound = fan_in ** -0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()
