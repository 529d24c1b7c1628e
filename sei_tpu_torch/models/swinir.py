"""SwinIR restoration transformer in PyTorch (counterpart of
``sei_tpu/models/swinir.py``).

Shallow 3x3 conv -> residual Swin transformer blocks (RSTB: windowed MSA with
relative position bias, shifted windows, LN, 2-layer MLP, then a 3x3 conv
and a residual) -> conv + global input residual.  The public API is NCHW in
[0, 1]; the transformer trunk works on NHWC tokens, as in the JAX package.

Parameter names are the reference torch ``state_dict`` names that
``sei_tpu.models.torch_io.flax_swinir_to_torch`` emits (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.*``,
``layers.{i}.conv``, ``norm``, ``conv_after_body``, ``conv_last``), so a
published checkpoint loads with ``load_state_dict``; the attention mask and
relative position index are recomputed, not stored.

``dtype`` is the compute dtype, as the flax module's field: None (f32), or
``torch.bfloat16``, the JAX package's training recipe (``demo/train.py
--bf16``).  The parameters stay f32 either way; in bf16 the convolutions,
the LayerNorms (f32 statistics, bf16 output) and the trunk run in bf16, and
the output is f32 again (``x + conv_last(...)``, the input residual in f32).

``fused_trunk`` (default on) runs the blocks of each RSTB through
``sei_tpu_torch.ops.swin_trunk.swin_trunk``, the chain of CUDA kernels; the
TPU package turned its fused trunk off above 64x64 tokens for its VMEM
budget, which does not apply here, so the port has no size gate.  With
``fused_trunk=False`` the blocks run as modules (LayerNorm/Linear plus the
``window_attention`` kernel).  ``forward(x, plain=True)`` runs the plain
PyTorch version of every kernel on any device (the reference the kernel path
is held against on the card); it is differentiable, by torch autograd
through the plain ops, as the kernel path is through the kernels' backward.

In training mode (``module.train()``) stochastic depth draws its keep masks
from the ``generator`` handed to ``forward`` (the trainer owns one dropout
stream); a training forward with a drop-path rate above 0 and no generator
raises.  The SR pixelshuffle head is not ported yet, nor the module path
(``fused_trunk=False``) in bf16.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import _torch_attention, window_attention
from ..ops.conv import Conv3x3
from ..ops.swin_trunk import swin_trunk, trunk_reference

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask (-100/0) for shifted windows."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = win.shape[-1]
    b = win.shape[0] // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i % period
    return torch.where(m < n, m, period - m)


def reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad the last two axes at the bottom/right in numpy's ``reflect`` mode,
    for any pad size (``F.pad`` refuses pads >= the input size)."""
    if not (pad_h or pad_w):
        return x
    h, w = x.shape[-2:]
    x = x.index_select(-2, _reflect_index(h, pad_h, x.device))
    return x.index_select(-1, _reflect_index(w, pad_w, x.device))


def _norm_in(norm: nn.LayerNorm, x: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """LayerNorm ``norm`` with its output in the compute dtype ``cdt``: the
    statistics in f32 as flax's ``nn.LayerNorm(dtype=...)`` keeps them."""
    if cdt is None:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(cdt)


def _trunc02(t: torch.Tensor, g: torch.Generator) -> None:
    # flax truncated_normal(0.02): a standard normal cut at +-2, times 0.02
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=g)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "rpi", torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def relative_bias(self) -> torch.Tensor:
        """(nh, N, N) bias expanded from the table."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.rpi]
        return b.view(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x, mask: Optional[torch.Tensor], plain: bool = False):
        b_, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attend = _torch_attention if plain else window_attention
        out = attend(q, k, v, self.relative_bias(), mask)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


def _need_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("drop-path in training mode draws from a torch.Generator: "
                         "pass generator=... to forward")
    return generator


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws from ``generator`` (on its own device), moved to ``device``."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch (identity in eval)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _uniform(shape, _need_generator(generator), x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio, drop_path):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask: Optional[torch.Tensor], plain: bool = False,
                generator: Optional[torch.Generator] = None):
        # x: (B, H, W, C) with H, W multiples of the window
        b, h, w, c = x.shape
        ws = self.window_size
        shift = self.shift_size if min(h, w) > ws else 0
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        win = self.attn(window_partition(y, ws), mask if shift else None, plain)
        y = window_reverse(win, ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(y, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class _ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: the blocks, a 3x3 conv, a residual."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 drop_paths: Sequence[float], fused_trunk: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.fused_trunk = fused_trunk
        self.drop_paths = tuple(drop_paths)
        self.residual_group = _ResidualGroup(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      drop_paths[i])
            for i in range(depth))
        self.conv = Conv3x3(dim, dim, dtype)

    def stacked_params(self):
        """The blocks' weights in the trunk layout: ``PARAM_LEAVES`` stacked
        over blocks (Linear weights transposed to in x out) and rpb."""
        blocks = self.residual_group.blocks

        def st(f):
            return torch.stack([f(b) for b in blocks])

        params = {
            "ln1_s": st(lambda b: b.norm1.weight), "ln1_b": st(lambda b: b.norm1.bias),
            "qkv_w": st(lambda b: b.attn.qkv.weight.t()), "qkv_b": st(lambda b: b.attn.qkv.bias),
            "proj_w": st(lambda b: b.attn.proj.weight.t()), "proj_b": st(lambda b: b.attn.proj.bias),
            "ln2_s": st(lambda b: b.norm2.weight), "ln2_b": st(lambda b: b.norm2.bias),
            "fc1_w": st(lambda b: b.mlp.fc1.weight.t()), "fc1_b": st(lambda b: b.mlp.fc1.bias),
            "fc2_w": st(lambda b: b.mlp.fc2.weight.t()), "fc2_b": st(lambda b: b.mlp.fc2.bias),
        }
        return params, st(lambda b: b.attn.relative_bias())

    def _drop_path_masks(self, b: int, device,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(D, 2, B) keep factors, (attention, MLP) branch drawn independently
        (the JAX trunk's one bernoulli draw of that shape)."""
        d = len(self.drop_paths)
        if not self.training or max(self.drop_paths) == 0.0:
            return torch.ones((d, 2, b), device=device)
        keep = (1.0 - torch.tensor(self.drop_paths, device=device))[:, None, None]
        u = _uniform((d, 2, b), _need_generator(generator), device)
        return (u < keep).float() / keep

    def forward(self, x, mask: Optional[torch.Tensor], plain: bool = False,
                generator: Optional[torch.Generator] = None):
        res = x
        if self.fused_trunk:
            params, rpb = self.stacked_params()
            trunk = trunk_reference if plain else swin_trunk
            x = trunk(x.contiguous(), params, rpb, mask,
                      self._drop_path_masks(x.shape[0], x.device, generator),
                      num_heads=self.num_heads, window_size=self.window_size)
        else:
            for blk in self.residual_group.blocks:
                x = blk(x, mask, plain, generator)
        x = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x + res


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinIR(nn.Module):
    """SwinIR on RGB with the denoise/deblur head (``upsampler=None``),
    NCHW API."""

    def __init__(self, *, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, drop_path_rate: float = 0.1,
                 upsampler: Optional[str] = None,
                 fused_trunk: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if upsampler is not None:
            raise NotImplementedError(
                "SwinIR pixelshuffle (SR) head: not ported yet (ROADMAP, Queue 1: SR)")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"SwinIR: compute dtype {dtype} (float32 or bfloat16)")
        dtype = None if dtype == torch.float32 else dtype
        if dtype is not None and not fused_trunk:
            raise NotImplementedError(
                "SwinIR module path (fused_trunk=False) in bf16: not ported "
                "(ROADMAP, Queue 1 item 16)")
        self.compute_dtype = dtype
        self.window_size = window_size
        self.register_buffer("mean", torch.tensor(RGB_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.conv_first = Conv3x3(3, embed_dim, dtype)
        self.patch_embed = _PatchEmbed(embed_dim)
        layers, d0 = [], 0
        for depth, nh in zip(depths, num_heads):
            layers.append(RSTB(embed_dim, depth, nh, window_size, mlp_ratio,
                               dpr[d0:d0 + depth], fused_trunk, dtype))
            d0 += depth
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = Conv3x3(embed_dim, embed_dim, dtype)
        self.conv_last = Conv3x3(embed_dim, 3, dtype)
        self._mask = (None, None)  # (key, tensor) of the last image size

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator``: trunc-normal(0.02)
        Linear weights and bias tables, zero biases, unit LayerNorms,
        Uniform(+-1/sqrt(fan_in)) conv weights with zero bias."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _trunc02(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, WindowAttention):
                _trunc02(m.relative_position_bias_table, generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Conv3x3):
                m.reset_from(generator)

    def _shift_mask(self, h: int, w: int, device) -> Optional[torch.Tensor]:
        ws = self.window_size
        if min(h, w) <= ws:
            return None
        key = (h, w, str(device))
        if self._mask[0] != key:
            self._mask = (key, torch.from_numpy(shift_attn_mask(h, w, ws, ws // 2)).to(device))
        return self._mask[1]

    def forward(self, x: torch.Tensor, plain: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # x: (B, C, H, W) in [0, 1]; ``generator`` feeds drop-path in training
        h_in, w_in = x.shape[-2:]
        ws = self.window_size
        x = reflect_pad(x, (-h_in) % ws, (-w_in) % ws)
        x = x - self.mean
        cdt = self.compute_dtype
        feat = self.conv_first(x)
        f = _norm_in(self.patch_embed.norm, feat.permute(0, 2, 3, 1), cdt).contiguous()
        mask = self._shift_mask(f.shape[1], f.shape[2], f.device)
        for layer in self.layers:
            f = layer(f, mask, plain, generator)
        f = _norm_in(self.norm, f, cdt).permute(0, 3, 1, 2)
        res = self.conv_after_body(f) + feat
        out = x + self.conv_last(res)  # f32: the input residual promotes
        out = out + self.mean
        return out[..., :h_in, :w_in]
