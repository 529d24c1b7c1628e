"""The ``Convolutional`` architecture of the proposed model: a ConvNeXt-style
UNet with ideal (spectral) resampling (counterpart of
``sei_tpu/models/convolutional.py``).

7x7 depthwise ConvBlocks with a LayerNorm over channels, spectral down- and
upsampling between scales, skip connections, inner and outer residuals, the
input reflect-padded to a multiple of 2^(scales-1), and for SR a spectral
upsampling head.  The resampler is the correct ideal one, as in the JAX
package (full ``fft2`` -> centred crop or zero pad -> ``ifft2(...).real``
times the area ratio), not the reference's (whose discarded ``ifftshift``
scrambles the spectrum).  NCHW throughout; the convolutions are cuDNN's,
the FFTs cuFFT's: the JAX package left all of it to XLA.

Submodules carry the flax modules' names (``Conv_0``, ``ConvBlock_3``,
``SpectralDownsample_1``, ...), so a JAX params tree maps onto the
``state_dict`` by name (:func:`jax_params_to_state_dict`).  The
initialiser is the JAX one: every conv weight uniform in +-1 / sqrt(fan in)
(variance scaling 1/3, fan in), biases zero, LayerNorms one / zero.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .swinir import reflect_pad


def _crop_or_pad(xf: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Centre-crop or zero-pad a centred (fftshifted) spectrum."""
    h, w = xf.shape[-2:]
    if out_h > h or out_w > w:
        ph0, pw0 = max(0, (out_h - h) // 2), max(0, (out_w - w) // 2)
        xf = F.pad(xf, (pw0, max(0, out_w - w - pw0), ph0, max(0, out_h - h - ph0)))
        h, w = xf.shape[-2:]
    if out_h < h or out_w < w:
        ch0, cw0 = (h - out_h) // 2, (w - out_w) // 2
        xf = xf[..., ch0:ch0 + out_h, cw0:cw0 + out_w]
    return xf


def ideal_resample(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Ideal spectral resampling of (B, C, H, W) by an integer ``rate`` (up)
    or by 1 / round(1 / rate) (down); a constant image stays constant."""
    h, w = x.shape[-2:]
    if rate >= 1:
        out_h, out_w = h * int(rate), w * int(rate)
    else:
        r = int(round(1 / rate))
        out_h, out_w = h // r, w // r
    xf = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(-2, -1)), dim=(-2, -1))
    xf = torch.fft.ifftshift(_crop_or_pad(xf, out_h, out_w), dim=(-2, -1))
    out = torch.fft.ifft2(xf, dim=(-2, -1)).real
    return (out * ((out_h * out_w) / (h * w))).to(x.dtype)


def _conv(cin: int, cout: int, k: int, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, groups=groups)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of NCHW, eps 1e-6."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight, self.bias, 1e-6)
        return x.permute(0, 3, 1, 2)


class ConvBlock(nn.Module):
    """7x7 depthwise -> LN -> 1x1 (x4) -> exact GELU -> 1x1, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = _conv(dim, dim, 7, groups=dim)
        self.ChannelLayerNorm_0 = ChannelLayerNorm(dim)
        self.Conv_1 = _conv(dim, 4 * dim, 1)
        self.Conv_2 = _conv(4 * dim, dim, 1)

    def forward(self, x):
        h = self.ChannelLayerNorm_0(self.Conv_0(x))
        return x + self.Conv_2(F.gelu(self.Conv_1(h)))


class SpectralDownsample(nn.Module):
    """LN -> 1x1 conv (C -> C * rate^2) -> ideal downsampling by ``rate``."""

    def __init__(self, in_channels: int, rate: int = 2):
        super().__init__()
        self.rate = rate
        self.ChannelLayerNorm_0 = ChannelLayerNorm(in_channels)
        self.Conv_0 = _conv(in_channels, in_channels * rate**2, 1)

    def forward(self, x):
        return ideal_resample(self.Conv_0(self.ChannelLayerNorm_0(x)), 1.0 / self.rate)


class SpectralUpsample(nn.Module):
    """Ideal upsampling by ``rate`` -> LN -> 1x1 conv (C -> out, default
    C / rate^2)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, rate: int = 2):
        super().__init__()
        self.rate = rate
        self.ChannelLayerNorm_0 = ChannelLayerNorm(in_channels)
        self.Conv_0 = _conv(in_channels, out_channels or in_channels // rate**2, 1)

    def forward(self, x):
        return self.Conv_0(self.ChannelLayerNorm_0(ideal_resample(x, float(self.rate))))


class UNet(nn.Module):
    def __init__(self, *, in_channels: int, hidden_channels: int, inout_convs: bool,
                 scales: int, num_conv_blocks: int, rate: int, residual: bool,
                 inner_residual: bool):
        super().__init__()
        self.inout_convs, self.scales, self.residual = inout_convs, scales, residual
        self.inner_residual, self.num_conv_blocks = inner_residual, num_conv_blocks
        ch = hidden_channels if inout_convs else in_channels
        if inout_convs:
            self.Conv_0 = _conv(in_channels, hidden_channels, 3)
        blocks, downs, ups = [], [], []
        for _ in range(scales - 1):
            blocks += [ch] * num_conv_blocks
            downs.append(SpectralDownsample(ch, rate))
            ch *= rate**2
        blocks += [ch] * num_conv_blocks
        for _ in range(scales - 1):
            ups.append(SpectralUpsample(ch, rate=rate))
            ch //= rate**2
            blocks += [ch] * num_conv_blocks
        for i, dim in enumerate(blocks):
            setattr(self, f"ConvBlock_{i}", ConvBlock(dim))
        for i, m in enumerate(downs):
            setattr(self, f"SpectralDownsample_{i}", m)
        for i, m in enumerate(ups):
            setattr(self, f"SpectralUpsample_{i}", m)
        if inout_convs:
            self.Conv_1 = _conv(hidden_channels, in_channels, 3)

    def forward(self, x):
        x0 = x
        if self.inout_convs:
            x = self.Conv_0(x)
        block = iter(range(self.num_conv_blocks * (2 * self.scales - 1)))

        def conv_seq(x):
            for _ in range(self.num_conv_blocks):
                x = getattr(self, f"ConvBlock_{next(block)}")(x)
            return x

        skips = []
        for i in range(self.scales - 1):
            xb, x = x, conv_seq(x)
            if self.inner_residual:
                x = x + xb
            skips.append(x)
            x = getattr(self, f"SpectralDownsample_{i}")(x)
        x = conv_seq(x)
        for i in range(self.scales - 1):
            x = getattr(self, f"SpectralUpsample_{i}")(x) + skips.pop()
            x = conv_seq(x)
        if self.inout_convs:
            x = self.Conv_1(x)
        return x + x0 if self.residual else x


class ConvolutionalModel(nn.Module):
    """The reference's Convolutional architecture on NCHW measurements.
    ``upscale`` is the SR rate (1: no head); ``forward`` takes and ignores
    the trainer's ``generator`` (the network draws nothing)."""

    def __init__(self, *, in_channels: int = 3, upsampling_rate: int = 1, residual: bool = True,
                 inner_residual: bool = True, num_conv_blocks: int = 1,
                 hidden_channels: int = 32, inout_convs: bool = True, scales: int = 5):
        super().__init__()
        self.upscale, self.scales = upsampling_rate, scales
        if upsampling_rate != 1:
            self.SpectralUpsample_0 = SpectralUpsample(in_channels, in_channels,
                                                       upsampling_rate)
        self.UNet_0 = UNet(in_channels=in_channels, hidden_channels=hidden_channels,
                           inout_convs=inout_convs, scales=scales,
                           num_conv_blocks=num_conv_blocks, rate=2, residual=residual,
                           inner_residual=inner_residual)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initialiser (module docstring), drawn on the CPU from
        ``generator`` in the modules' order."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    bound = 1.0 / np.sqrt(fan_in)
                    w = torch.rand(m.weight.shape, generator=generator) * (2 * bound) - bound
                    m.weight.copy_(w)
                    m.bias.zero_()
                elif isinstance(m, ChannelLayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def forward(self, y, generator: Optional[torch.Generator] = None):
        if self.upscale != 1:
            y = self.SpectralUpsample_0(y)
        div = 2 ** (self.scales - 1)
        h, w = y.shape[-2:]
        x = self.UNet_0(reflect_pad(y, (-h) % div, (-w) % div))
        return x[..., :h, :w]


def _torch_name(path: tuple) -> str:
    # a flax ChannelLayerNorm holds its LayerNorm one level down
    return ".".join(p for p in path if p != "LayerNorm_0")


def jax_params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ConvolutionalModel params tree (numpy leaves) as
    this module's ``state_dict``: conv kernels HWIO -> OIHW, LayerNorm
    ``scale`` -> ``weight``."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            v = np.array(v, dtype=np.float32)
            if k == "kernel":
                v = v.transpose(3, 2, 0, 1)
            leaf = "bias" if k == "bias" else "weight"
            out[f"{_torch_name(path)}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(v))

    walk(params, ())
    return out
