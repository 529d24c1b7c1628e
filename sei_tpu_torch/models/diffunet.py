"""DiffUNet: the guided-diffusion UNet of DiffPIR_DiffUNet (counterpart of
``sei_tpu/models/diffunet.py``).

OpenAI's guided-diffusion ``UNetModel`` (Dhariwal & Nichol 2021) under its
torch checkpoint's names (``time_embed``, ``input_blocks``, ``middle_block``,
``output_blocks``, ``out``), so a published checkpoint such as DiffPIR's
``diffusion_ffhq_10m.pt`` loads with ``load_state_dict``; its
hyper-parameters are read from the checkpoint's shapes
(:func:`diffunet_config_from_state_dict`).  GroupNorm(32) + SiLU, residual
blocks with scale-shift norm, global self-attention (the legacy QKV split,
q and k each scaled by hd^-1/4, the softmax in f32) at the attended
resolutions, nearest-neighbour upsampling.

:func:`diffunet_denoise` is deepinv's ``DiffUNet.forward(x, sigma)``: [0, 1]
images to the diffusion's [-1, 1], sigma to the nearest DDPM timestep by
sqrt(1 - abar_t) / sqrt(abar_t) (linear betas 1e-4..0.02, T = 1000), the
epsilon prediction to the x0 estimate; the input edge-padded to the UNet's
multiple 2^(levels-1) and the estimate cropped back.  :func:`save_diffunet`
writes a checkpoint in that layout (the trainer's output).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, guided-diffusion's convention: cat([cos, sin])."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@dataclasses.dataclass(frozen=True)
class DiffUNetConfig:
    in_channels: int = 3
    out_channels: int = 6  # learn_sigma: (eps, var) stacked
    model_channels: int = 128
    num_res_blocks: int = 1
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4)
    attention_ds: Sequence[int] = (16,)  # downsample factors with attention
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True

    def __post_init__(self):
        bad = [m * self.model_channels for m in self.channel_mult
               if (m * self.model_channels) % 32]
        if bad:
            raise ValueError("model_channels x channel_mult must be multiples of 32 "
                             f"(GroupNorm(32) architecture); offending widths: {bad}")


def _norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, scale_shift: bool):
        super().__init__()
        self.scale_shift = scale_shift
        self.in_layers = nn.Sequential(_norm(in_ch), nn.SiLU(), nn.Conv2d(in_ch, out_ch, 3,
                                                                          padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_ch, (2 if scale_shift else 1) * out_ch))
        self.out_layers = nn.Sequential(_norm(out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (nn.Identity() if in_ch == out_ch
                                else nn.Conv2d(in_ch, out_ch, 1))

    def forward(self, x, emb):
        h = self.in_layers(x)
        e = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=1)
            h = norm(h) * (1.0 + scale) + shift
        else:
            h = norm(h + e)
        return self.skip_connection(x) + rest(h)


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, num_head_channels: int):
        super().__init__()
        self.heads = max(ch // num_head_channels, 1)
        self.norm = _norm(ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(self.norm(x).reshape(b, c, h * w))  # (b, 3c, t)
        hd = c // self.heads
        q, k, v = qkv.reshape(b * self.heads, 3 * hd, h * w).split(hd, dim=1)
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        att = torch.einsum("bct,bcs->bts", q * scale, k * scale).float().softmax(-1)
        out = torch.einsum("bts,bcs->bct", att.to(v.dtype), v).reshape(b, c, h * w)
        return x + self.proj_out(out).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, -2).repeat_interleave(2, -1))


class EmbSequential(nn.Sequential):
    """guided-diffusion's ``TimestepEmbedSequential``: the residual blocks
    take the timestep embedding."""

    def forward(self, x, emb):
        for m in self:
            x = m(x, emb) if isinstance(m, ResBlock) else m(x)
        return x


class DiffUNet(nn.Module):
    """Guided-diffusion UNetModel, NCHW: ``net(x, timesteps)``."""

    def __init__(self, cfg: DiffUNetConfig = DiffUNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch0, emb_ch = cfg.model_channels, 4 * cfg.model_channels

        def res(cin, cout):
            return ResBlock(cin, cout, emb_ch, cfg.use_scale_shift_norm)

        def attn(ch):
            return AttentionBlock(ch, cfg.num_head_channels)

        self.time_embed = nn.Sequential(nn.Linear(ch0, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        blocks = [EmbSequential(nn.Conv2d(cfg.in_channels, ch0, 3, padding=1))]
        chans, ch, ds = [ch0], ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                blocks.append(EmbSequential(*layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                blocks.append(EmbSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = EmbSequential(res(ch, ch), attn(ch), res(ch, ch))
        blocks = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_ds:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                blocks.append(EmbSequential(*layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(_norm(ch), nn.SiLU(),
                                 nn.Conv2d(ch, cfg.out_channels, 3, padding=1))

    def forward(self, x, timesteps):
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels))
        hs, h = [], x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)


def ddpm_alphas_cumprod(T: int = 1000) -> np.ndarray:
    betas = np.linspace(1e-4, 0.02, T, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def diffunet_denoise(net, x: torch.Tensor, sigma: float, *, multiple: int,
                     T: int = 1000) -> torch.Tensor:
    """deepinv ``DiffUNet.forward(x, sigma)``: the x0 estimate in [0, 1] of
    (B, 3, H, W) images at noise level ``sigma`` (module docstring);
    ``multiple`` is 2^(len(channel_mult) - 1)."""
    h, w = x.shape[-2:]
    x = F.pad(x, (0, (-w) % multiple, 0, (-h) % multiple), mode="replicate")
    abar = torch.as_tensor(ddpm_alphas_cumprod(T), dtype=torch.float32, device=x.device)
    reduced = torch.sqrt(1.0 - abar) / torch.sqrt(abar)
    t = torch.argmin(torch.abs(reduced - 2.0 * sigma))
    xt = torch.sqrt(abar[t]) * (2.0 * x - 1.0)
    eps = net(xt, t.expand(x.shape[0]))[:, :3]
    x0 = (xt - torch.sqrt(1.0 - abar[t]) * eps) / torch.sqrt(abar[t])
    return torch.clamp((x0 + 1.0) / 2.0, 0.0, 1.0)[..., :h, :w]


def diffunet_config_from_state_dict(sd) -> DiffUNetConfig:
    """The UNet's hyper-parameters from a guided-diffusion state_dict's
    shapes (``num_head_channels`` leaves no trace: 64, as every published
    checkpoint)."""
    ch0 = sd["input_blocks.0.0.weight"].shape[0]
    in_ch = sd["input_blocks.0.0.weight"].shape[1]
    n_in = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"input_blocks\.(\d+)\.", k)))
    mults, res_per_level, run, attention_ds, ds = [], None, 0, set(), 1
    for i in range(1, n_in):
        if f"input_blocks.{i}.0.op.weight" in sd:  # Downsample
            mults.append(sd[f"input_blocks.{i - 1}.0.out_layers.3.weight"].shape[0] // ch0)
            res_per_level = run if res_per_level is None else res_per_level
            run, ds = 0, ds * 2
        else:
            run += 1
            if f"input_blocks.{i}.1.norm.weight" in sd:
                attention_ds.add(ds)
    mults.append(sd[f"input_blocks.{n_in - 1}.0.out_layers.3.weight"].shape[0] // ch0)
    res_per_level = run if res_per_level is None else res_per_level
    emb_out = sd["input_blocks.1.0.emb_layers.1.weight"].shape[0]
    res_out = sd["input_blocks.1.0.out_layers.3.weight"].shape[0]
    return DiffUNetConfig(in_channels=in_ch, out_channels=sd["out.2.weight"].shape[0],
                          model_channels=ch0, num_res_blocks=res_per_level,
                          channel_mult=tuple(mults), attention_ds=tuple(sorted(attention_ds)),
                          num_head_channels=64, use_scale_shift_norm=emb_out == 2 * res_out)


def save_diffunet(path: str, net: DiffUNet) -> None:
    """Write ``net``'s state_dict, f32 CPU tensors under the guided-diffusion
    names: what :func:`load_diffunet` and the JAX package's
    ``torch_diffunet_to_flax`` / ``diffunet_config_from_state_dict`` read."""
    torch.save({k: v.detach().to("cpu", torch.float32) for k, v in net.state_dict().items()},
               path)


def load_diffunet(path: str) -> DiffUNet:
    """A DiffUNet (on the CPU) from a guided-diffusion checkpoint."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}
    net = DiffUNet(diffunet_config_from_state_dict(sd))
    net.load_state_dict(sd, strict=True)
    return net
