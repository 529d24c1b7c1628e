"""Swin trunk on Hopper: forward and backward as chains of hand-written CUDA
kernels per block.

Counterpart of ``sei_tpu/ops/swin_trunk.py``: the eval primal
(``_fwd_pallas`` -> ``_fwd_kernel`` at :1035 / :931, ``mode="none"``), the
training forward (mode ``xs``, :1082-1085) and the recompute backward
(``_bwd_pallas`` -> ``_bwd_kernel`` at :1110 / :979 with
``with_saved=False``), tied together by the custom VJP ``_trunk_pallas``
(:1212-1243).  The TPU kernel keeps a whole image group resident in VMEM
across all D blocks of an RSTB.  On Hopper one 256x320x180 f32 image is
59 MB against 227 KB of shared memory per block, so each SwinBlock is a
chain of launches instead.  Forward, seven launches of three kernels:

    ln_rows(LN1, shift + window partition on the load)   -> a    (T, C)
    gemm_bias_epilogue(a, qkv_w, qkv_b, "none")          -> qkv  (T, 3C)
    window_attn_fwd(q, k, v strided from qkv, rpb, mask) -> att  (T, C)
    gemm_bias_epilogue(att, proj_w, proj_b, "residual",
                       window reverse + unshift on the store) -> x2 (B,H,W,C)
    ln_rows(LN2)                                          -> z    (T, C)
    gemm_bias_epilogue(z, fc1_w, fc1_b, "gelu")           -> h    (T, 2C)
    gemm_bias_epilogue(h, fc2_w, fc2_b, "residual")       -> out  (B,H,W,C)

Backward (:class:`_TrunkFn`), per block in reverse, from the block input x
and the mid-block residual x2 that the forward kept (mode ``xs``):
recompute a, qkv, att, z and (gelu(h), h) with the forward kernels (five
launches), then

    gemm_dgrad(dout * dpm_mlp, fc2_w, GELU'(h))      -> dh   (T, 2C)
    gemm_wgrad(gelu(h), dout * dpm_mlp)               -> d fc2_w, fc2_b
    gemm_wgrad(z, dh)                                 -> d fc1_w, fc1_b
    gemm_dgrad(dh, fc1_w)                             -> dz   (T, C)
    ln_rows_bwd(x2, dz, + dout)                       -> dx2, d ln2
    gemm_dgrad(dx2[window rows] * dpm_attn, proj_w)   -> datt (T, C)
    gemm_wgrad(att, dx2[window rows] * dpm_attn)      -> d proj_w, proj_b
    window_attn_bwd(q, k, v, rpb, mask, datt)         -> dq, dk, dv, drpb
    gemm_wgrad(a, dqkv)                               -> d qkv_w, qkv_b
    gemm_dgrad(dqkv, qkv_w)                           -> da   (T, C)
    ln_rows_bwd(x[window rows], da, + dx2)            -> dx, d ln1

T = B*H*W tokens.  Numerics follow the reference: LN eps 1e-5 with f32
statistics, scores scaled by hd**-0.5 then rpb (+ the -100/0 shift mask)
added in f32 before an f32 softmax, exact GELU, and per-image drop-path keep
factors ``dpm (D, 2, B)`` on the (attention, MLP) residual branches.

What the TPU kernel needed and this design does not: head packing into
128-lane tiles (``pack_attn_params``, ``_head_tiling``), group/VMEM sizing
(``_pick_group``), the SMEM one-hot drop-path vector (``_dpm_group``), the
bf16 polynomial GELU (``_gelu_fast``; this path is f32) and the profiling
skip knob.  The mask stays f32 (0 and -100 are exact either way).  Mode
``full`` (gelu, gelu', p and tfull saved) and its backward are bf16-only in
the JAX package and wait for the port's bf16 work.

Each kernel wrapper runs its plain PyTorch version for CPU tensors, and
launches its kernel (or raises) for CUDA tensors; each counts its launches
in a plain ``.launches`` int.  :func:`trunk_reference` is an independent
plain version of the whole trunk (the mirror of the JAX ``trunk_reference``
:871-887), differentiable by torch autograd, which the kernel chain and its
backward are held against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import require_cuda_f32
from . import _build
from .attention import _as_mask, _torch_attention, window_attn_bwd, window_attn_fwd

PARAM_LEAVES = (
    "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

_EPS = 1e-5
_EPILOGUES = {"none": 0, "gelu": 1, "residual": 2}
_GELU_PRE = 3  # the "gelu" epilogue that also stores the pre-activation
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


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
                              window: Optional[WindowMap] = None, pre=None):
    y = torch.addmm(b, a, w)
    if epilogue == "gelu":
        if pre is not None:
            pre.copy_(y)
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
                       window: Optional[WindowMap] = None, pre=None):
    """``epilogue(a @ w + b)`` with f32 accumulation.

    a: (M, K); w: (K, N) (the JAX kernel layout, in x out); b: (N,).
    epilogue "none" / "gelu" (exact) -> (M, N).  "residual" ->
    ``res + dpm[img] * (a @ w + b)`` in ``res``'s shape, where ``dpm`` (B,)
    holds per-image keep factors (img = row // (M // B)) and, with a
    ``window``, row r of the product lands on the pixel the window map names
    (window reverse + unshift folded into the store).  With "gelu", a given
    ``pre`` (M, N) buffer also receives the pre-activation ``a @ w + b`` (the
    training backward's recompute: the GELU' factor of the fc2 data-grad
    reads it).

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
    if pre is not None and (epilogue != "gelu" or pre.shape != (m, n)):
        raise ValueError("gemm_bias_epilogue: pre takes the gelu epilogue and an (M, N) buffer")
    if a.device.type == "cpu":
        return _torch_gemm_bias_epilogue(a, w, b, epilogue, res, dpm, window, pre)

    a, w, b = a.contiguous(), w.contiguous(), b.contiguous()
    if residual:
        res, dpm = res.contiguous(), dpm.contiguous()
    require_cuda_f32("gemm_bias_epilogue", a, w, b, res, dpm, pre)
    if pre is not None and not pre.is_contiguous():
        raise ValueError("gemm_bias_epilogue: pre must be contiguous")
    if m > 65535 * 64:
        raise ValueError(f"gemm_bias_epilogue: M={m} exceeds the kernel's grid")
    out = torch.empty(res.shape if residual else (m, n), device=a.device, dtype=a.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_bias_epilogue(
        a.device.index, a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _build.ptr(pre), _build.ptr(res), _build.ptr(dpm), m, k, n,
        _GELU_PRE if pre is not None else _EPILOGUES[epilogue],
        m // dpm.shape[0] if residual else 0, int(window is not None),
        wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(a))
    _build.check(code, "gemm_bias_epilogue")
    gemm_bias_epilogue.launches += 1
    return out


gemm_bias_epilogue.launches = 0


# -- backward kernels ----------------------------------------------------------


def _gelu_grad(x):
    """d/dx of the exact GELU x * Phi(x)."""
    return 0.5 * (1.0 + torch.erf(x * _SQRT_HALF)) + x * torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _grad_operand(dy, n: int, scale, window: Optional[WindowMap]):
    """The (M, N) matrix whose row m is ``scale[img(m)] * dy[p(m)]``: the
    plain version of the gather + scale prologue of ``gemm_bwd.cu``."""
    rows = dy.reshape(-1, n)
    if window is not None:
        rows = rows[window_rows(dy.shape[0], window, dy.device)]
    if scale is not None:
        rows = rows * scale.repeat_interleave(rows.shape[0] // scale.shape[0])[:, None]
    return rows


def _check_grad_operand(name, dy, scale, window):
    if window is not None and (dy.dim() != 4 or dy.shape[1:3] != (window.h, window.w)):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} does not match {window}")
    if window is None and dy.dim() != 2:
        raise ValueError(f"{name}: dy must be (M, N) without a window map")
    m = dy.numel() // dy.shape[-1]
    if scale is not None and (scale.dim() != 1 or m % scale.shape[0]):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for {m} rows")
    if window is not None and scale is not None and scale.shape[0] != dy.shape[0]:
        raise ValueError(f"{name}: scale needs one entry per image")
    return m


def _torch_gemm_dgrad(dy, w, scale=None, window: Optional[WindowMap] = None, pre=None):
    out = _grad_operand(dy, w.shape[1], scale, window) @ w.t()
    return out if pre is None else out * _gelu_grad(pre)


def gemm_dgrad(dy, w, *, scale=None, window: Optional[WindowMap] = None, pre=None):
    """``(scale[img] * dy[rows]) @ w^T`` (times ``gelu'(pre)`` when given)
    -> (M, K).

    w: (K, N) in the JAX layout (in x out); dy: (M, N), or (B, h, w, N) with
    a ``window``, whose row map gathers row m from the pixel it names;
    scale: (B,) per-image factors (img = m // (M // B)); pre: (M, K).

    Kernel ``gemm_dgrad`` (``csrc/gemm_bwd.cu``) replaces the data-grad
    products of the TPU trunk's backward (``sei_tpu/ops/swin_trunk.py``
    ``_block_bwd_image`` :665, :669, :740, :803; ``_gelu_grad`` :170).
    Bound by FP32 operations; 64x64 tiles, 4x4 register tiles, the gather
    and scale on the load and GELU' in the epilogue.
    """
    k, n = w.shape
    if dy.shape[-1] != n:
        raise ValueError(f"gemm_dgrad: dy {tuple(dy.shape)} w {tuple(w.shape)}")
    m = _check_grad_operand("gemm_dgrad", dy, scale, window)
    if pre is not None and pre.shape != (m, k):
        raise ValueError(f"gemm_dgrad: pre {tuple(pre.shape)}, expected {(m, k)}")
    if dy.device.type == "cpu":
        return _torch_gemm_dgrad(dy, w, scale, window, pre)

    dy, w = dy.contiguous(), w.contiguous()
    scale = None if scale is None else scale.contiguous()
    pre = None if pre is None else pre.contiguous()
    require_cuda_f32("gemm_dgrad", dy, w, scale, pre)
    if m > 65535 * 64:
        raise ValueError(f"gemm_dgrad: M={m} exceeds the kernel's grid")
    out = torch.empty((m, k), device=dy.device, dtype=dy.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_dgrad(
        dy.device.index, dy.data_ptr(), w.data_ptr(), _build.ptr(scale), _build.ptr(pre),
        out.data_ptr(), m, n, k, m // scale.shape[0] if scale is not None else 0,
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(dy))
    _build.check(code, "gemm_dgrad")
    gemm_dgrad.launches += 1
    return out


gemm_dgrad.launches = 0


def _torch_gemm_wgrad(a, dy, scale=None, window: Optional[WindowMap] = None):
    g = _grad_operand(dy, dy.shape[-1], scale, window)
    return a.t() @ g, g.sum(0)


def gemm_wgrad(a, dy, *, scale=None, window: Optional[WindowMap] = None):
    """``(a^T g, g.sum(0))`` with ``g = scale[img] * dy[rows]``: the weight
    (K, N) and bias (N,) gradients of ``a @ w + b``.

    a: (M, K); dy, scale and window as in :func:`gemm_dgrad`.

    Kernel ``gemm_wgrad`` (``csrc/gemm_bwd.cu``) replaces the weight-grad
    products of the TPU trunk's backward (``_block_bwd_image`` :663-668,
    :786-802) and its per-group partials (``_bwd_pallas`` :1153-1174,
    summed at :1198-1203).  Bound by FP32 operations; 64x64 tiles over
    (K, N), the token axis split over the grid into partials that are
    summed here (no atomics), the bias column sums taken from the same
    staged tiles.
    """
    m, k = a.shape
    n = dy.shape[-1]
    if _check_grad_operand("gemm_wgrad", dy, scale, window) != m:
        raise ValueError(f"gemm_wgrad: a {tuple(a.shape)} dy {tuple(dy.shape)}")
    if a.device.type == "cpu":
        return _torch_gemm_wgrad(a, dy, scale, window)

    a, dy = a.contiguous(), dy.contiguous()
    scale = None if scale is None else scale.contiguous()
    require_cuda_f32("gemm_wgrad", a, dy, scale)
    tiles = -(-k // 64) * -(-n // 64)
    splits = _build.partial_count(-(-m // 256), blocks_per_partial=tiles, per_sm=4)
    dw = torch.empty((splits, k, n), device=a.device, dtype=a.dtype)
    db = torch.empty((splits, n), device=a.device, dtype=a.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_wgrad(
        a.device.index, a.data_ptr(), dy.data_ptr(), _build.ptr(scale), dw.data_ptr(),
        db.data_ptr(), m, k, n, splits, m // scale.shape[0] if scale is not None else 0,
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(a))
    _build.check(code, "gemm_wgrad")
    gemm_wgrad.launches += 1
    return dw.sum(0), db.sum(0)


gemm_wgrad.launches = 0


def _torch_ln_rows_bwd(x, gamma, dz, window: Optional[WindowMap] = None, dres=None):
    c = x.shape[-1]
    flat = x.reshape(-1, c)
    idx = None if window is None else window_rows(x.shape[0], window, x.device)
    rows = flat if idx is None else flat[idx]
    mu = rows.mean(-1, keepdim=True)
    xc = rows - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS)
    xhat = xc * inv
    g = dz * gamma
    d = (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True)) * inv
    if idx is not None:
        d = torch.empty_like(flat).index_copy_(0, idx, d)
    dx = d.view(x.shape)
    return dx if dres is None else dx + dres, (dz * xhat).sum(0), dz.sum(0)


def ln_rows_bwd(x, gamma, dz, *, window: Optional[WindowMap] = None, dres=None):
    """Backward of :func:`ln_rows` given ``dz`` = dL/d(output rows):
    (dx in ``x``'s shape, dgamma, dbeta); ``dres`` (``x``'s shape) is added
    to dx (the residual stream's gradient).

    With a ``window``, row r of ``dz`` belongs to the pixel the window map
    names: x is read there and dx written there (the window reverse +
    unshift folded into the store).

    Kernel ``ln_rows_bwd`` (``csrc/ln_rows_bwd.cu``) replaces the LN
    backward of the TPU trunk's backward (``_ln_bwd``
    ``sei_tpu/ops/swin_trunk.py:252``, called at :672 and :855-857).  Bound
    by bytes; one warp per row with the statistics recomputed from x in f32,
    dgamma/dbeta as one partial per block, summed here.
    """
    c = x.shape[-1]
    if window is not None and (x.dim() != 4 or x.shape[1:3] != (window.h, window.w)):
        raise ValueError(f"ln_rows_bwd: x {tuple(x.shape)} does not match {window}")
    rows = x.numel() // c
    if dz.shape != (rows, c) or gamma.shape != (c,):
        raise ValueError(f"ln_rows_bwd: dz {tuple(dz.shape)} gamma {tuple(gamma.shape)}")
    if dres is not None and dres.shape != x.shape:
        raise ValueError(f"ln_rows_bwd: dres {tuple(dres.shape)} vs x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return _torch_ln_rows_bwd(x, gamma, dz, window, dres)

    x, gamma, dz = x.contiguous(), gamma.contiguous(), dz.contiguous()
    dres = None if dres is None else dres.contiguous()
    require_cuda_f32("ln_rows_bwd", x, gamma, dz, dres)
    if c > 256:
        raise ValueError(f"ln_rows_bwd: kernel takes C <= 256; got C={c}")
    blocks = _build.partial_count(-(-rows // 16), per_sm=3)
    dx = torch.empty_like(x)
    dg = torch.empty((blocks, c), device=x.device, dtype=x.dtype)
    db = torch.empty((blocks, c), device=x.device, dtype=x.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_ln_rows_bwd(
        x.device.index, x.data_ptr(), gamma.data_ptr(), dz.data_ptr(), _build.ptr(dres),
        dx.data_ptr(), dg.data_ptr(), db.data_ptr(), rows, c, _EPS, blocks,
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(x))
    _build.check(code, "ln_rows_bwd")
    ln_rows_bwd.launches += 1
    return dx, dg.sum(0), db.sum(0)


ln_rows_bwd.launches = 0

KERNELS = (ln_rows, gemm_bias_epilogue, window_attn_fwd, gemm_dgrad, gemm_wgrad,
           window_attn_bwd, ln_rows_bwd)


def reset_launch_counts() -> None:
    """Set the launch counters of every trunk kernel to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


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


class _Dims(NamedTuple):
    b: int
    h: int
    w: int
    c: int
    nh: int
    ws: int

    @property
    def n(self) -> int:
        return self.ws * self.ws

    @property
    def hd(self) -> int:
        return self.c // self.nh

    @property
    def b_(self) -> int:  # windows over the batch
        return self.b * (self.h // self.ws) * (self.w // self.ws)

    @property
    def scale(self) -> float:
        return self.hd ** -0.5

    def window(self, shift: int) -> WindowMap:
        return WindowMap(self.h, self.w, self.ws, shift)


def _qkv_views(qkv, dm: _Dims):
    """q, k, v as (B_, nh, N, hd) strided views of a (T, 3C) buffer."""
    t = qkv.view(dm.b_, dm.n, 3, dm.nh, dm.hd)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(3))


def _attention(a, p, rpb_i, mask_i, dm: _Dims):
    """qkv GEMM + window attention -> (qkv (T, 3C), att (T, C))."""
    qkv = gemm_bias_epilogue(a, p["qkv_w"], p["qkv_b"])
    att = torch.empty((dm.b_, dm.n, dm.nh, dm.hd), device=a.device, dtype=a.dtype)
    window_attn_fwd(*_qkv_views(qkv, dm), rpb_i, mask_i, scale=dm.scale,
                    out=att.transpose(1, 2))
    return qkv, att.view(-1, dm.c)


def _chain_forward(x, params, rpb, mask, dpm, dm: _Dims, shift, saves=None):
    """The forward chain; appends each block's (x, x2) to ``saves`` when
    given (the TPU trunk's mode ``xs``)."""
    c = dm.c
    for i in range(params["ln1_s"].shape[0]):
        p = {k: params[k][i] for k in PARAM_LEAVES}
        shifted = i % 2 == 1 and shift > 0
        wm = dm.window(shift if shifted else 0)
        a = ln_rows(x, p["ln1_s"], p["ln1_b"], window=wm)
        _, att = _attention(a, p, rpb[i], mask if shifted else None, dm)
        x2 = gemm_bias_epilogue(att, p["proj_w"], p["proj_b"], "residual",
                                res=x, dpm=dpm[i, 0], window=wm)
        z = ln_rows(x2.view(-1, c), p["ln2_s"], p["ln2_b"])
        hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu")
        out = gemm_bias_epilogue(hid, p["fc2_w"], p["fc2_b"], "residual",
                                 res=x2, dpm=dpm[i, 1])
        if saves is not None:
            saves.append((x, x2))
        x = out
    return x


def _block_backward(dout, x, x2, p, rpb_i, mask_i, dpm_i, wm: WindowMap, dm: _Dims):
    """One block's backward (the mirror of ``_block_bwd_image``) from its
    input x and mid-block residual x2: (dx, {leaf: grad}, drpb)."""
    c = dm.c
    t = x.numel() // c
    # recompute with the forward kernels
    a = ln_rows(x, p["ln1_s"], p["ln1_b"], window=wm)
    qkv, att = _attention(a, p, rpb_i, mask_i, dm)
    z = ln_rows(x2.view(-1, c), p["ln2_s"], p["ln2_b"])
    pre = torch.empty((t, p["fc1_w"].shape[1]), device=x.device, dtype=x.dtype)
    hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu", pre=pre)
    g = {}
    # MLP branch: out = x2 + dpm_mlp * fc2(gelu(fc1(LN2(x2))))
    dmlp = dout.view(t, c)
    dh = gemm_dgrad(dmlp, p["fc2_w"], scale=dpm_i[1], pre=pre)
    g["fc2_w"], g["fc2_b"] = gemm_wgrad(hid, dmlp, scale=dpm_i[1])
    g["fc1_w"], g["fc1_b"] = gemm_wgrad(z, dh)
    dz = gemm_dgrad(dh, p["fc1_w"])
    dx2, g["ln2_s"], g["ln2_b"] = ln_rows_bwd(x2.view(t, c), p["ln2_s"], dz, dres=dmlp)
    dx2 = dx2.view(x.shape)
    # attention branch: x2 = x + dpm_attn * unwindow(proj(attention(LN1(x))))
    datt = gemm_dgrad(dx2, p["proj_w"], scale=dpm_i[0], window=wm)
    g["proj_w"], g["proj_b"] = gemm_wgrad(att, dx2, scale=dpm_i[0], window=wm)
    dqkv = torch.empty_like(qkv)
    *_, drpb = window_attn_bwd(
        *_qkv_views(qkv, dm), rpb_i, mask_i,
        datt.view(dm.b_, dm.n, dm.nh, dm.hd).transpose(1, 2), scale=dm.scale,
        out=_qkv_views(dqkv, dm))
    g["qkv_w"], g["qkv_b"] = gemm_wgrad(a, dqkv)
    da = gemm_dgrad(dqkv, p["qkv_w"])
    dx, g["ln1_s"], g["ln1_b"] = ln_rows_bwd(x, p["ln1_s"], da, window=wm, dres=dx2)
    return dx, g, drpb


class _TrunkFn(torch.autograd.Function):
    """The trunk with its backward on the kernels (the counterpart of
    ``_trunk_pallas``'s custom VJP): the forward keeps each block's x and x2,
    the backward walks the blocks in reverse and recomputes the rest.
    Returns dx, drpb and the 12 stacked parameter grads; dpm and the mask
    take none."""

    @staticmethod
    def forward(ctx, x, rpb, dpm, mask, num_heads, window_size, *leaves):
        params = dict(zip(PARAM_LEAVES, leaves))
        b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
        dm = _Dims(b, h, w, c, num_heads, window_size)
        saves = []
        y = _chain_forward(x.contiguous(), params, rpb, mask, dpm, dm, shift, saves)
        ctx.save_for_backward(rpb, dpm, *leaves)
        ctx.saves, ctx.mask, ctx.dm, ctx.shift = saves, mask, dm, shift
        return y

    @staticmethod
    def backward(ctx, dy):
        rpb, dpm, *leaves = ctx.saved_tensors
        params = dict(zip(PARAM_LEAVES, leaves))
        dm, shift = ctx.dm, ctx.shift
        d = len(ctx.saves)
        grads = {k: [None] * d for k in PARAM_LEAVES}
        drpb = [None] * d
        g = dy.contiguous()
        for i in reversed(range(d)):
            x, x2 = ctx.saves[i]
            shifted = i % 2 == 1 and shift > 0
            wm = dm.window(shift if shifted else 0)
            p = {k: params[k][i] for k in PARAM_LEAVES}
            g, gi, drpb[i] = _block_backward(g, x, x2, p, rpb[i],
                                             ctx.mask if shifted else None, dpm[i], wm, dm)
            for k in PARAM_LEAVES:
                grads[k][i] = gi[k]
        ctx.saves = None
        return (g, torch.stack(drpb), None, None, None, None,
                *(torch.stack(grads[k]) for k in PARAM_LEAVES))


def swin_trunk(x, params: dict, rpb, mask, dpm, *, num_heads: int, window_size: int):
    """D SwinBlocks on x (B, H, W, C) through the kernel chain.

    params: the stacked ``PARAM_LEAVES`` (D, ...) in the JAX layout (weights
    in x out); rpb (D, nh, N, N); mask (nW, N, N) or None; dpm (D, 2, B).
    Blocks alternate no-shift / shift (shift ws//2 unless min(H, W) <= ws).
    Differentiable in x, rpb and params: when autograd needs a gradient the
    call goes through :class:`_TrunkFn` (forward kernels that keep x and x2
    per block, backward kernels); otherwise only the forward chain runs.
    """
    mask = _as_mask(mask, x)
    leaves = [params[k] for k in PARAM_LEAVES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, rpb, *leaves)):
        return _TrunkFn.apply(x, rpb, dpm, mask, num_heads, window_size, *leaves)
    b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
    return _chain_forward(x.contiguous(), params, rpb, mask, dpm,
                          _Dims(b, h, w, c, num_heads, window_size), shift)

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
    "KERNELS", "PARAM_LEAVES", "WindowMap", "gemm_bias_epilogue", "gemm_dgrad",
    "gemm_wgrad", "launch_counts", "ln_rows", "ln_rows_bwd", "reset_launch_counts",
    "swin_trunk", "trunk_reference", "window_rows",
]
