"""3x3 'same' convolution: counterpart of ``sei_tpu/ops/conv_mm.py`` Conv3x3.

The JAX package computes this outside any Pallas kernel (XLA's convolution),
so the port uses cuDNN through ``nn.Conv2d``; TF32 is off
(``sei_tpu_torch.device.resolve_device``), matching the f32 reference.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` on NCHW tensors."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=3, padding=1)

    @torch.no_grad()
    def reset_from(self, generator: torch.Generator) -> None:
        """The JAX package's init: Uniform(+-1/sqrt(fan_in)) weights (torch's
        kaiming_uniform(a=sqrt(5)) variance 1/(3 fan_in)), zero bias."""
        fan_in = self.in_channels * 9
        bound = fan_in ** -0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()
