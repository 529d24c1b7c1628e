"""Swin trunk forward on Hopper: a chain of hand-written CUDA kernels per block.

Counterpart of ``sei_tpu/ops/swin_trunk.py`` (the eval primal, ``_fwd_pallas``
-> ``_fwd_kernel`` at :1035 / :931 with ``mode="none"``, called from
``_trunk_pallas`` :1213-1219).  The TPU kernel keeps a whole image group
resident in VMEM across all D blocks of an RSTB.  On Hopper one 256x320x180
f32 image is 59 MB against 227 KB of shared memory per block, so each
SwinBlock is instead a chain of seven launches of three kernels:

    ln_rows(LN1, shift + window partition on the load)   -> a    (T, C)
    gemm_bias_epilogue(a, qkv_w, qkv_b, "none")          -> qkv  (T, 3C)
    window_attn_fwd(q, k, v strided from qkv, rpb, mask) -> att  (T, C)
    gemm_bias_epilogue(att, proj_w, proj_b, "residual",
                       window reverse + unshift on the store) -> x2 (B,H,W,C)
    ln_rows(LN2)                                          -> z    (T, C)
    gemm_bias_epilogue(z, fc1_w, fc1_b, "gelu")           -> h    (T, 2C)
    gemm_bias_epilogue(h, fc2_w, fc2_b, "residual")       -> out  (B,H,W,C)

T = B*H*W tokens.  Numerics follow the reference: LN eps 1e-5 with f32
statistics, scores scaled by hd**-0.5 then rpb (+ the -100/0 shift mask)
added in f32 before an f32 softmax, exact GELU, and per-image drop-path keep
factors ``dpm (D, 2, B)`` on the (attention, MLP) residual branches.

What the TPU kernel needed and this design does not: head packing into
128-lane tiles (``pack_attn_params``, ``_head_tiling``), group/VMEM sizing
(``_pick_group``), the SMEM one-hot drop-path vector (``_dpm_group``), the
bf16 polynomial GELU (``_gelu_fast``; the eval is f32) and the profiling
skip knob.  The mask stays f32 (0 and -100 are exact either way).

Each kernel wrapper runs its plain PyTorch version for CPU tensors, and
launches its kernel (or raises) for CUDA tensors; each counts its launches
in a plain ``.launches`` int.  :func:`trunk_reference` is an independent
plain version of the whole trunk (the mirror of the JAX ``trunk_reference``
:871-887), which the kernel chain is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import require_cuda_f32
from . import _build
from .attention import _as_mask, _torch_attention, window_attn_fwd

PARAM_LEAVES = (
    "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

_EPS = 1e-5
_EPILOGUES = {"none": 0, "gelu": 1, "residual": 2}


class WindowMap(NamedTuple):
    """Token rows in shifted-window order over a (B, h, w, C) image: row r is
    token r of ``roll(x, (-shift, -shift))`` cut into ws x ws windows."""

    h: int
    w: int
    ws: int
    shift: int


def window_rows(b: int, wm: WindowMap, device) -> torch.Tensor:
    """Flat pixel index (over B*h*w) of each window-ordered token row; the
    plain version of ``row_to_pixel`` in ``csrc/common.cuh``."""
    pix = torch.arange(b * wm.h * wm.w, device=device).view(b, wm.h, wm.w)
    if wm.shift:
        pix = torch.roll(pix, (-wm.shift, -wm.shift), dims=(1, 2))
    nh_, nw_ = wm.h // wm.ws, wm.w // wm.ws
    pix = pix.view(b, nh_, wm.ws, nw_, wm.ws).permute(0, 1, 3, 2, 4)
    return pix.reshape(-1)


# -- ln_rows -------------------------------------------------------------------


def _torch_ln_rows(x, gamma, beta, window: Optional[WindowMap] = None):
    c = x.shape[-1]
    rows = x.reshape(-1, c)
    if window is not None:
        rows = rows[window_rows(x.shape[0], window, x.device)]
    mu = rows.mean(-1, keepdim=True)
    xc = rows - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + _EPS) * gamma + beta


def ln_rows(x, gamma, beta, window: Optional[WindowMap] = None):
    """LayerNorm over the last axis -> (rows, C).

    ``x``: (B, h, w, C), or (rows, C) when ``window`` is None.  With a
    ``window``, output row r is the LN of the pixel the window map names
    (shift + window partition folded into the load).

    Kernel ``ln_rows`` (``csrc/ln_rows.cu``) replaces the LN stages of
    ``sei_tpu/ops/swin_trunk.py`` ``_fwd_kernel`` (``_ln_fwd`` :242, roll and
    ``_window_tokens`` :263, :432).  Bound by bytes (one read, one write of
    each row); one warp per row, the row in registers, f32 two-pass stats.
    """
    c = x.shape[-1]
    if window is not None and (x.dim() != 4 or x.shape[1:3] != (window.h, window.w)):
        raise ValueError(f"ln_rows: x {tuple(x.shape)} does not match {window}")
    if x.device.type == "cpu":
        return _torch_ln_rows(x, gamma, beta, window)
    x = x.contiguous()
    require_cuda_f32("ln_rows", x, gamma, beta)
    if c > 256 or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"ln_rows: kernel takes C <= 256 and (C,) params; got C={c}")
    rows = x.numel() // c
    out = torch.empty((rows, c), device=x.device, dtype=x.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_ln_rows(
        x.device.index, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), rows, c, _EPS, int(window is not None),
        wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(x))
    _build.check(code, "ln_rows")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0


# -- gemm_bias_epilogue --------------------------------------------------------


def _torch_gemm_bias_epilogue(a, w, b, epilogue="none", res=None, dpm=None,
                              window: Optional[WindowMap] = None):
    y = torch.addmm(b, a, w)
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "none":
        return y
    m, n = y.shape
    res2 = res.reshape(m, n)
    rows = (torch.arange(m, device=a.device) if window is None
            else window_rows(dpm.shape[0], window, a.device))
    img = torch.arange(m, device=a.device) // (m // dpm.shape[0])
    out = res2.clone()
    out[rows] = res2[rows] + dpm[img, None] * y
    return out.view(res.shape)


def gemm_bias_epilogue(a, w, b, epilogue: str = "none", res=None, dpm=None,
                       window: Optional[WindowMap] = None):
    """``epilogue(a @ w + b)`` with f32 accumulation.

    a: (M, K); w: (K, N) (the JAX kernel layout, in x out); b: (N,).
    epilogue "none" / "gelu" (exact) -> (M, N).  "residual" ->
    ``res + dpm[img] * (a @ w + b)`` in ``res``'s shape, where ``dpm`` (B,)
    holds per-image keep factors (img = row // (M // B)) and, with a
    ``window``, row r of the product lands on the pixel the window map names
    (window reverse + unshift folded into the store).

    Kernel ``gemm_bias_epilogue`` (``csrc/gemm_bias_epilogue.cu``) replaces
    the qkv / proj / fc1 / fc2 products inside the TPU trunk kernel
    (``sei_tpu/ops/swin_trunk.py`` :448, :474, :539, :544-547).  Bound by
    FP32 operations (TF32 off); 64x64 tiles with 4x4 register tiles and the
    epilogue applied in registers.
    """
    if epilogue not in _EPILOGUES:
        raise ValueError(f"gemm_bias_epilogue: unknown epilogue {epilogue!r}")
    m, k = a.shape
    if w.shape[0] != k or b.shape != (w.shape[1],):
        raise ValueError(f"gemm_bias_epilogue: a {tuple(a.shape)} w {tuple(w.shape)} b {tuple(b.shape)}")
    n = w.shape[1]
    residual = epilogue == "residual"
    if residual:
        if res is None or dpm is None or res.numel() != m * n or m % dpm.shape[0]:
            raise ValueError("gemm_bias_epilogue: residual needs res (M*N) and dpm (B,)")
        if window is not None and res.shape != (dpm.shape[0], window.h, window.w, n):
            raise ValueError(f"gemm_bias_epilogue: res {tuple(res.shape)} does not match {window}")
    elif window is not None:
        raise ValueError("gemm_bias_epilogue: a window map needs the residual epilogue")
    if a.device.type == "cpu":
        return _torch_gemm_bias_epilogue(a, w, b, epilogue, res, dpm, window)

    a, w, b = a.contiguous(), w.contiguous(), b.contiguous()
    if residual:
        res, dpm = res.contiguous(), dpm.contiguous()
    require_cuda_f32("gemm_bias_epilogue", a, w, b, res, dpm)
    if m > 65535 * 64:
        raise ValueError(f"gemm_bias_epilogue: M={m} exceeds the kernel's grid")
    out = torch.empty(res.shape if residual else (m, n), device=a.device, dtype=a.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_bias_epilogue(
        a.device.index, a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _build.ptr(res), _build.ptr(dpm), m, k, n, _EPILOGUES[epilogue],
        m // dpm.shape[0] if residual else 0, int(window is not None),
        wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(a))
    _build.check(code, "gemm_bias_epilogue")
    gemm_bias_epilogue.launches += 1
    return out


gemm_bias_epilogue.launches = 0


def reset_launch_counts() -> None:
    """Set the launch counters of every trunk kernel to 0."""
    ln_rows.launches = 0
    gemm_bias_epilogue.launches = 0
    window_attn_fwd.launches = 0


def launch_counts() -> dict:
    return {
        "ln_rows": ln_rows.launches,
        "gemm_bias_epilogue": gemm_bias_epilogue.launches,
        "window_attn_fwd": window_attn_fwd.launches,
    }


# -- the trunk -----------------------------------------------------------------


def _check_trunk(x, params, rpb, dpm, num_heads, window_size):
    b, h, w, c = x.shape
    d = params["ln1_s"].shape[0]
    n = window_size * window_size
    if h % window_size or w % window_size:
        raise ValueError(f"swin_trunk: {h}x{w} is not a multiple of window {window_size}")
    if c % num_heads:
        raise ValueError(f"swin_trunk: C={c} not divisible by {num_heads} heads")
    if rpb.shape != (d, num_heads, n, n) or dpm.shape != (d, 2, b):
        raise ValueError(f"swin_trunk: rpb {tuple(rpb.shape)} / dpm {tuple(dpm.shape)}")
    return b, h, w, c, d, window_size // 2 if min(h, w) > window_size else 0


def swin_trunk(x, params: dict, rpb, mask, dpm, *, num_heads: int, window_size: int):
    """D SwinBlocks on x (B, H, W, C) through the kernel chain.

    params: the stacked ``PARAM_LEAVES`` (D, ...) in the JAX layout (weights
    in x out); rpb (D, nh, N, N); mask (nW, N, N) or None; dpm (D, 2, B).
    Blocks alternate no-shift / shift (shift ws//2 unless min(H, W) <= ws).
    """
    b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
    mask = _as_mask(mask, x)
    ws, nh = window_size, num_heads
    n, hd = ws * ws, c // nh
    b_ = b * (h // ws) * (w // ws)
    scale = hd ** -0.5
    x = x.contiguous()
    for i in range(d):
        p = {k: params[k][i] for k in PARAM_LEAVES}
        shifted = i % 2 == 1 and shift > 0
        wm = WindowMap(h, w, ws, shift if shifted else 0)
        a = ln_rows(x, p["ln1_s"], p["ln1_b"], window=wm)
        qkv = gemm_bias_epilogue(a, p["qkv_w"], p["qkv_b"]).view(b_, n, 3, nh, hd)
        att = torch.empty((b_, n, nh, hd), device=x.device, dtype=x.dtype)
        window_attn_fwd(qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2),
                        qkv[:, :, 2].transpose(1, 2), rpb[i],
                        mask if shifted else None, scale=scale,
                        out=att.transpose(1, 2))
        x2 = gemm_bias_epilogue(att.view(-1, c), p["proj_w"], p["proj_b"],
                                "residual", res=x, dpm=dpm[i, 0], window=wm)
        z = ln_rows(x2.view(-1, c), p["ln2_s"], p["ln2_b"])
        hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu")
        x = gemm_bias_epilogue(hid, p["fc2_w"], p["fc2_b"], "residual",
                               res=x2, dpm=dpm[i, 1])
    return x


def _window_tokens(y, ws):
    b, h, w, c = y.shape
    t = y.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, c)


def _unwindow_tokens(t, b, h, w, ws):
    c = t.shape[-1]
    y = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h, w, c)


def _ln(x, s, b):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS) * s + b


def trunk_reference(x, params: dict, rpb, mask, dpm, *, num_heads: int,
                    window_size: int):
    """Plain PyTorch trunk: the same function as :func:`swin_trunk`, written
    the straightforward way (roll, window partition, per-head attention,
    window reverse), independent of the kernels' row maps."""
    b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
    mask = _as_mask(mask, x)
    ws, nh = window_size, num_heads
    n, hd = ws * ws, c // nh
    for i in range(d):
        p = {k: params[k][i] for k in PARAM_LEAVES}
        shifted = i % 2 == 1 and shift > 0
        a = _ln(x, p["ln1_s"], p["ln1_b"])
        if shifted:
            a = torch.roll(a, (-shift, -shift), dims=(1, 2))
        tok = _window_tokens(a, ws)
        qkv = (tok @ p["qkv_w"] + p["qkv_b"]).reshape(-1, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = _torch_attention(q, k, v, rpb[i], mask if shifted else None,
                               hd ** -0.5)
        o = att.transpose(1, 2).reshape(-1, n, c) @ p["proj_w"] + p["proj_b"]
        y = _unwindow_tokens(o, b, h, w, ws)
        if shifted:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x2 = x + dpm[i, 0][:, None, None, None] * y
        m = F.gelu(_ln(x2, p["ln2_s"], p["ln2_b"]) @ p["fc1_w"] + p["fc1_b"])
        m = m @ p["fc2_w"] + p["fc2_b"]
        x = x2 + dpm[i, 1][:, None, None, None] * m
    return x


__all__ = [
    "PARAM_LEAVES", "WindowMap", "gemm_bias_epilogue", "launch_counts", "ln_rows",
    "reset_launch_counts", "swin_trunk", "trunk_reference", "window_rows",
]
