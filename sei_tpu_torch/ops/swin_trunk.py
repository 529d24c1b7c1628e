"""Swin trunk on Hopper: forward and backward as chains of hand-written CUDA
kernels per block, in f32 or bf16.

Counterpart of ``sei_tpu/ops/swin_trunk.py``: the eval primal
(``_fwd_pallas`` -> ``_fwd_kernel`` at :1035 / :931, ``mode="none"``), the
training forwards (mode ``xs``, :1082-1085, and the save-carrying mode
``full``, :1077-1081) and the backwards (``_bwd_pallas`` -> ``_bwd_kernel``
at :1110 / :979, ``with_saved=False`` and ``True``), tied together by the
custom VJP ``_trunk_pallas`` (:1212-1243).  The TPU kernel keeps a whole
image group resident in VMEM across all D blocks of an RSTB.  On Hopper one
256x320x180 f32 image is 59 MB against 227 KB of shared memory per block, so
each SwinBlock is a chain of launches instead.  Forward, seven launches of
three kernels:

    ln_rows(LN1, shift + window partition on the load)   -> a    (T, C)
    gemm_bias_epilogue(a, qkv_w, qkv_b, "none")          -> qkv  (T, 3C)
    window_attn_fwd(q, k, v strided from qkv, rpb, mask) -> att  (T, C)
                                                 [+ p (B_, nh, N, N)]
    gemm_bias_epilogue(att, proj_w, proj_b, "residual",
                       window reverse + unshift on the store) -> x2 (B,H,W,C)
    ln_rows(LN2)                                          -> z    (T, C)
    gemm_bias_epilogue(z, fc1_w, fc1_b, "gelu")           -> h    (T, 2C)
                       ("gelu_pair" with saves: + gelu'(h) (T, 2C))
    gemm_bias_epilogue(h, fc2_w, fc2_b, "residual")       -> out  (B,H,W,C)

Backward (:class:`_TrunkFn`), per block in reverse.  With saves (mode
``full``, the default for bf16 as ``saves_on`` :1283) the forward kept x,
x2, gelu(h), gelu'(h), p and att per block, and the backward recomputes only
a (LN1), qkv and z (LN2) -- three launches, the recompute of
``_block_bwd_image`` with saves (:638, :649-653, :735).  Without saves (mode
``xs``, the f32 default) it kept x and x2 and recomputes a, qkv, z and
(gelu(h), gelu'(h)) with the forward kernels (four launches); att comes back
with the attention backward, which writes it from the p it recomputes, as
the TPU kernel derives att and ds from one p (:768-783).  (bf16 in mode
``xs`` recomputes att with a ``window_attn_fwd`` launch instead.)  Then

    gemm_dgrad(dout * dpm_mlp, fc2_w) * gelu'(h)      -> dh   (T, 2C)  f32
    gemm_wgrad(gelu(h), dout * dpm_mlp)               -> d fc2_w, fc2_b
    gemm_wgrad(z, dh)                                 -> d fc1_w, fc1_b
    gemm_dgrad(dh, fc1_w)                             -> dz   (T, C)   f32
    ln_rows_bwd(x2, dz, + dout)                       -> dx2, d ln2    f32
    gemm_dgrad(dx2[window rows] * dpm_attn, proj_w)   -> datt (T, C)
    window_attn_bwd(q, k, v, datt, saved p or rpb + mask) -> dq, dk, dv, drpb
                                                 [+ att (T, C), f32 mode xs]
    gemm_wgrad(att, dx2[window rows] * dpm_attn)      -> d proj_w, proj_b
    gemm_wgrad(a, dqkv)                               -> d qkv_w, qkv_b
    gemm_dgrad(dqkv, qkv_w)                           -> da   (T, C)
    ln_rows_bwd(x[window rows], da, + dx2)            -> dx, d ln1

T = B*H*W tokens.  Numerics follow the reference: LN eps 1e-5 with f32
statistics, scores scaled by hd**-0.5 then rpb (+ the -100/0 shift mask)
added in f32 before an f32 softmax, per-image drop-path keep factors
``dpm (D, 2, B)`` on the (attention, MLP) residual branches, f32
accumulation in every product, f32 parameter gradients.  The compute
dtype is x's: in bf16 (the JAX package's production training recipe,
``SwinIR(dtype=bfloat16)``) the activations, the saves and the GEMM weights
(cast once per trunk call) are bf16, and every value is rounded to bf16
exactly where the JAX trunk casts
(the LN outputs, qkv, p, att, the proj and fc2 outputs before the f32
residual add, the residual sums; in the backward dm, dh, the proj gradient,
ds, dq/dk/dv and da; the block gradient dx), so the kernels' plain versions
below repeat the JAX trunk's arithmetic.  The GELU is exact (erf) or the
polynomial pair ``_gelu_fast`` / ``_gelu_pair_fast``, as
:func:`use_fast_gelu` picks it (``_use_fast_gelu`` :233: ``SEI_FAST_GELU``,
unset the polynomial in bf16 and the exact form in f32).

What the TPU kernel needed and this design does not: head packing into
128-lane tiles (``pack_attn_params``, ``_head_tiling``), group/VMEM sizing
(``_pick_group``), the SMEM one-hot drop-path vector (``_dpm_group``) and the
profiling skip knob.  The mask stays f32 (0 and -100 are exact either way).

Each kernel wrapper runs its plain PyTorch version for CPU tensors, and
launches its kernel (or raises) for CUDA tensors; each counts its launches
in a plain ``.launches`` int.  :func:`trunk_reference` is an independent
plain version of the whole trunk (the mirror of the JAX ``trunk_reference``
:871-887, with its bf16 rounding points), differentiable by torch autograd,
which the kernel chain and its backward are held against.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import KERNEL_DTYPES, require_cuda
from . import _build
from .attention import _as_mask, _probs, _round, window_attn_bwd, window_attn_fwd

PARAM_LEAVES = (
    "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)
GEMM_WEIGHTS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")  # cast to the compute dtype

F32 = torch.float32
BF16 = torch.bfloat16
_EPS = 1e-5
_EPILOGUES = {"none": 0, "gelu": 1, "residual": 2, "gelu_pair": 3}
_GELU_FORMS = {False: "exact", True: "fast"}  # use_fast_gelu's value -> its name
_TILE = 64  # rows of the bf16 GEMM tiles (csrc/gemm_*.cu; the weight grad's columns too; bf16
#              dgrad is 96 wide and the f32 forward GEMM 128 x 96, for which the grid check below
#              is conservative; the f32 weight grad's kernel sizes its own grid)
_DGRAD_F32_ROWS = 96  # rows of the f32 data grad's tile (DF_BM in csrc/gemm_bwd.cu)
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _is_bf16(t) -> int:
    return int(t is not None and t.dtype == BF16)


# -- GELU ----------------------------------------------------------------------
# The port's copy of the JAX trunk's polynomial GELU (sei_tpu/ops/swin_trunk.py
# :188-230): Chebyshev-fitted odd polynomials on [-4, 4], Phi(x) = 0.5 +
# x*Q1(x^2) and x*pdf(x) = x*Q2(x^2), saturated outside; the trunk's form
# when use_fast_gelu says so, else the exact GELU.

_GELU_XC = 4.0
_C_PHI = (0.3989390292359633, -0.06647417597398475, 0.009949619744973907,
          -0.0011709367759583488, 0.00010915483414148812,
          -7.956239157270749e-06, 4.340088563312956e-07,
          -1.6419572555948384e-08, 3.7875219898373147e-10,
          -3.969025307598051e-12)
_C_XPDF = (0.3988928463183661, -0.19922337402921744, 0.04949916878279405,
           -0.008056541327475311, 0.0009400990867306437,
           -8.006941709520028e-05, 4.854256860196168e-06,
           -1.9705490399271182e-07, 4.764393641533242e-09,
           -5.154521748137964e-11)


def _horner(coefs, u):
    acc = torch.full_like(u, coefs[-1])
    for c in coefs[-2::-1]:
        acc = acc * u + c
    return acc


def _gelu_fast(x32):
    xc = x32.clamp(-_GELU_XC, _GELU_XC)
    u = xc * xc
    phi = 0.5 + xc * _horner(_C_PHI, u)
    phi = torch.where(x32 > _GELU_XC, 1.0, torch.where(x32 < -_GELU_XC, 0.0, phi))
    return x32 * phi


def _gelu_pair_fast(x32):
    """(gelu(x), gelu'(x)) of the polynomial GELU, one evaluation."""
    xc = x32.clamp(-_GELU_XC, _GELU_XC)
    u = xc * xc
    inr = x32.abs() <= _GELU_XC
    phi = torch.where(inr, 0.5 + xc * _horner(_C_PHI, u), (x32 > 0).to(x32.dtype))
    xpdf = torch.where(inr, xc * _horner(_C_XPDF, u), 0.0)
    return x32 * phi, phi + xpdf


def _gelu_pair(x32):
    """(gelu(x), gelu'(x)) of the exact GELU x * Phi(x)."""
    phi = 0.5 * (1.0 + torch.erf(x32 * _SQRT_HALF))
    return x32 * phi, phi + x32 * torch.exp(-0.5 * x32 * x32) * _INV_SQRT_2PI


def use_fast_gelu(dtype, fast_gelu: Optional[bool] = None) -> bool:
    """Whether the trunk's GELU is the polynomial pair (True) or the exact
    erf form (False), as the JAX package's ``_use_fast_gelu``
    (``sei_tpu/ops/swin_trunk.py:233-238``) decides it: an explicit
    ``fast_gelu`` wins; else ``SEI_FAST_GELU`` when set (``"0"``,
    ``"false"`` and ``""`` off, anything else on); else on for a bf16
    compute ``dtype`` only."""
    if fast_gelu is not None:
        return bool(fast_gelu)
    env = os.environ.get("SEI_FAST_GELU")
    if env is not None:
        return env not in ("0", "false", "")
    return dtype == BF16


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
    rows = rows.float()
    mu = rows.mean(-1, keepdim=True)
    xc = rows - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + _EPS) * gamma + beta).to(x.dtype)


def ln_rows(x, gamma, beta, window: Optional[WindowMap] = None):
    """LayerNorm over the last axis -> (rows, C) in x's dtype (f32
    statistics, f32 gamma/beta, the output rounded once).

    ``x``: (B, h, w, C), or (rows, C) when ``window`` is None.  With a
    ``window``, output row r is the LN of the pixel the window map names
    (shift + window partition folded into the load).

    Kernel ``ln_rows`` (``csrc/ln_rows.cu``) replaces the LN stages of
    ``sei_tpu/ops/swin_trunk.py`` ``_fwd_kernel`` (``_ln_fwd`` :242, roll and
    ``_window_tokens`` :263, :432, the bf16 cast :430, :539).  Bound by bytes
    (one read, one write of each row); one warp per row, the row in
    registers, f32 two-pass stats.
    """
    c = x.shape[-1]
    if window is not None and (x.dim() != 4 or x.shape[1:3] != (window.h, window.w)):
        raise ValueError(f"ln_rows: x {tuple(x.shape)} does not match {window}")
    if x.device.type == "cpu":
        return _torch_ln_rows(x, gamma, beta, window)
    x = x.contiguous()
    require_cuda("ln_rows", x=(x, KERNEL_DTYPES), gamma=(gamma, F32), beta=(beta, F32))
    if c > 256 or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"ln_rows: kernel takes C <= 256 and (C,) params; got C={c}")
    rows = x.numel() // c
    out = torch.empty((rows, c), device=x.device, dtype=x.dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_ln_rows(
        x.device.index, _is_bf16(x), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), rows, c, _EPS, int(window is not None),
        wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(x))
    _build.check(code, "ln_rows")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0


# -- gemm_bias_epilogue --------------------------------------------------------


def _torch_gemm_bias_epilogue(a, w, b, epilogue="none", res=None, dpm=None,
                              window: Optional[WindowMap] = None, gp=None,
                              fast_gelu: Optional[bool] = None):
    cdt = w.dtype
    y = torch.addmm(b, a.float(), w.float())
    fast = use_fast_gelu(cdt, fast_gelu)
    if epilogue == "gelu":
        return (_gelu_fast(y) if fast else F.gelu(y)).to(cdt)
    if epilogue == "gelu_pair":
        g, d = (_gelu_pair_fast if fast else _gelu_pair)(y)
        gp.copy_(d)
        return g.to(cdt)
    if epilogue == "none":
        return y.to(cdt)
    m, n = y.shape
    res2 = res.reshape(m, n).float()
    rows = (torch.arange(m, device=a.device) if window is None
            else window_rows(dpm.shape[0], window, a.device))
    img = torch.arange(m, device=a.device) // (m // dpm.shape[0])
    out = res2.clone()
    out[rows] = res2[rows] + dpm[img, None] * _round(y, cdt)
    return out.to(cdt).view(res.shape)


def gemm_bias_epilogue(a, w, b, epilogue: str = "none", res=None, dpm=None,
                       window: Optional[WindowMap] = None, gp=None,
                       fast_gelu: Optional[bool] = None):
    """``epilogue(a @ w + b)`` with f32 accumulation, in w's dtype (the
    compute dtype: f32, or bf16 with a, res and the output bf16 too).

    a: (M, K); w: (K, N) (the JAX kernel layout, in x out); b: (N,) f32.
    epilogue "none" / "gelu" -> (M, N); the GELU is the polynomial
    ``_gelu_fast`` when ``use_fast_gelu(w.dtype, fast_gelu)`` (by default
    in bf16 only), else exact (erf).  "gelu_pair": as "gelu", and the
    given ``gp`` (M, N) buffer (the compute dtype: the training forward's
    save; or f32: the recompute's) receives gelu'(a @ w + b).  "residual"
    -> ``res + dpm[img] * round(a @ w + b)`` in ``res``'s shape, summed in
    f32 and rounded again (the JAX trunk's double rounding in bf16), where
    ``dpm`` (B,) f32 holds per-image keep factors (img = row // (M // B))
    and, with a ``window``, row r of the product lands on the pixel the
    window map names (window reverse + unshift folded into the store).

    Kernel ``gemm_bias_epilogue`` (``csrc/gemm_bias_epilogue.cu``) replaces
    the qkv / proj / fc1 / fc2 products inside the TPU trunk kernel
    (``sei_tpu/ops/swin_trunk.py`` :448, :474, :539-547; the gelu/gelu'
    saves of mode ``full`` :541-545, :556-559).  Bound by FP32 operations in
    f32 (TF32 off), by bytes in bf16.  f32 runs on the CUDA cores: 128x96
    output tiles, 8x6 register tiles of FMAs per thread, 20-deep K slices
    in two shared stages (W by ``cp.async``, A through registers), the
    epilogue in registers and float4 stores at each row's pixel.  bf16 runs
    on the tensor cores: 64x64 output tiles (``mma.sync`` m16n8k16, f32
    accumulators, 32-deep K slices copied by ``cp.async`` into a ring of
    three shared buffers, the output tile staged in shared memory and
    written in packed rows at each row's pixel).
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
    if (gp is not None) != (epilogue == "gelu_pair") or (gp is not None and gp.shape != (m, n)):
        raise ValueError("gemm_bias_epilogue: the gelu_pair epilogue takes an (M, N) gp buffer")
    fast = use_fast_gelu(w.dtype, fast_gelu)
    if a.device.type == "cpu":
        return _torch_gemm_bias_epilogue(a, w, b, epilogue, res, dpm, window, gp, fast)

    a, w, b = a.contiguous(), w.contiguous(), b.contiguous()
    if residual:
        res, dpm = res.contiguous(), dpm.contiguous()
    cdt = w.dtype
    require_cuda("gemm_bias_epilogue", w=(w, KERNEL_DTYPES), a=(a, cdt), res=(res, cdt),
                 gp=(gp, (cdt, F32)), b=(b, F32), dpm=(dpm, F32))
    if gp is not None and not gp.is_contiguous():
        raise ValueError("gemm_bias_epilogue: gp must be contiguous")
    if m > 65535 * _TILE:
        raise ValueError(f"gemm_bias_epilogue: M={m} exceeds the kernel's grid")
    out = torch.empty(res.shape if residual else (m, n), device=a.device, dtype=cdt)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_bias_epilogue(
        a.device.index, _is_bf16(w), a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _build.ptr(gp), _is_bf16(gp), _build.ptr(res), _build.ptr(dpm), m, k, n,
        _EPILOGUES[epilogue], int(fast), m // dpm.shape[0] if residual else 0,
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(a))
    _build.check(code, "gemm_bias_epilogue")
    gemm_bias_epilogue.launches += 1
    if epilogue in ("gelu", "gelu_pair"):
        gemm_bias_epilogue.gelu_launches[_GELU_FORMS[fast]] += 1
    return out


gemm_bias_epilogue.launches = 0
# the "gelu" and "gelu_pair" epilogues' launches by GELU form, beside .launches
gemm_bias_epilogue.gelu_launches = dict.fromkeys(_GELU_FORMS.values(), 0)


# -- backward kernels ----------------------------------------------------------


def _grad_operand(dy, n: int, scale, window: Optional[WindowMap]):
    """The f32 (M, N) matrix whose row m is ``scale[img(m)] * dy[p(m)]``: the
    plain version of the gather + scale prologue of ``gemm_bwd.cu`` (which
    then rounds it to the compute dtype)."""
    rows = dy.reshape(-1, n)
    if window is not None:
        rows = rows[window_rows(dy.shape[0], window, dy.device)]
    rows = rows.float()
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


def _torch_gemm_dgrad(dy, w, scale=None, window: Optional[WindowMap] = None, gp=None,
                      out_dtype=None):
    g = _round(_grad_operand(dy, w.shape[1], scale, window), w.dtype)
    out = g @ w.float().t()
    if gp is not None:
        out = out * gp.float()
    return out.to(out_dtype or w.dtype)


def gemm_dgrad(dy, w, *, scale=None, window: Optional[WindowMap] = None, gp=None,
               out_dtype=None):
    """``round(scale[img] * dy[rows]) @ w^T`` (times ``gp`` when given)
    -> (M, K) in ``out_dtype`` (f32 or w's dtype, the default).

    w: (K, N) in the JAX layout (in x out), of the compute dtype; dy: (M, N),
    or (B, h, w, N) with a ``window``, whose row map gathers row m from the
    pixel it names, f32 or the compute dtype; the operand is rounded to the
    compute dtype as it is loaded.  scale: (B,) per-image factors (img =
    m // (M // B)); gp: (M, K), gelu'(h) of the fc1 pre-activation h (the
    forward's save or the recompute's), f32 or the compute dtype.

    Kernel ``gemm_dgrad`` (``csrc/gemm_bwd.cu``) replaces the data-grad
    products of the TPU trunk's backward (``sei_tpu/ops/swin_trunk.py``
    ``_block_bwd_image`` :665-666, :669, :740-741, :803).  Bound by FP32
    operations in f32, by bytes in bf16; the gather, scale and rounding on
    the load and gp in the epilogue.  f32 runs on the CUDA cores: 96x96
    output tiles, 8x6 register tiles of FMAs per thread, 20-deep slices of
    both operands read as float4 along N into registers and stored
    transposed into two shared stages, the epilogue in registers and float4
    stores; its tile is ``_DGRAD_F32_ROWS`` rows high.  bf16 runs on the
    tensor cores (``mma.sync`` m16n8k16, f32 accumulators, 64x96 tiles,
    32-deep slices of the rounded operand staged through registers and of w
    copied by ``cp.async``, two shared buffers), ``_TILE`` rows high.
    """
    k, n = w.shape
    if dy.shape[-1] != n:
        raise ValueError(f"gemm_dgrad: dy {tuple(dy.shape)} w {tuple(w.shape)}")
    m = _check_grad_operand("gemm_dgrad", dy, scale, window)
    if gp is not None and gp.shape != (m, k):
        raise ValueError(f"gemm_dgrad: gp {tuple(gp.shape)}, expected {(m, k)}")
    if dy.device.type == "cpu":
        return _torch_gemm_dgrad(dy, w, scale, window, gp, out_dtype)

    dy, w = dy.contiguous(), w.contiguous()
    scale = None if scale is None else scale.contiguous()
    gp = None if gp is None else gp.contiguous()
    cdt = w.dtype
    out_dtype = out_dtype or cdt
    require_cuda("gemm_dgrad", w=(w, KERNEL_DTYPES), dy=(dy, (cdt, F32)), gp=(gp, (cdt, F32)),
                 scale=(scale, F32))
    if out_dtype not in (cdt, F32):
        raise ValueError(f"gemm_dgrad: out_dtype {out_dtype} with {cdt} weights")
    if m > 65535 * (_TILE if cdt == BF16 else _DGRAD_F32_ROWS):
        raise ValueError(f"gemm_dgrad: M={m} exceeds the kernel's grid")
    out = torch.empty((m, k), device=dy.device, dtype=out_dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    code = _build.library().lib.sei_gemm_dgrad(
        dy.device.index, _is_bf16(w), dy.data_ptr(), _is_bf16(dy), w.data_ptr(),
        _build.ptr(scale), _build.ptr(gp), _is_bf16(gp), out.data_ptr(), _is_bf16(out),
        m, n, k, m // scale.shape[0] if scale is not None else 0,
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(dy))
    _build.check(code, "gemm_dgrad")
    gemm_dgrad.launches += 1
    return out


gemm_dgrad.launches = 0


def _torch_gemm_wgrad(a, dy, scale=None, window: Optional[WindowMap] = None,
                      db_rounded: bool = False):
    g = _grad_operand(dy, dy.shape[-1], scale, window)
    gr = _round(g, a.dtype)
    return a.float().t() @ gr, (gr if db_rounded else g).sum(0)


def gemm_wgrad(a, dy, *, scale=None, window: Optional[WindowMap] = None,
               db_rounded: bool = False):
    """``(a^T g, sum_rows)`` with ``g = round(scale[img] * dy[rows])``: the
    f32 weight (K, N) and bias (N,) gradients of ``a @ w + b``.  The bias
    gradient sums g before its rounding to the compute dtype, or after it
    with ``db_rounded`` (the JAX trunk sums the f32 dm and dh, :664, :668,
    but the rounded proj gradient and dqkv, :792, :802).

    a: (M, K) of the compute dtype; dy, scale and window as in
    :func:`gemm_dgrad`.

    Kernel ``gemm_wgrad`` (``csrc/gemm_bwd.cu``) replaces the weight-grad
    products of the TPU trunk's backward (``_block_bwd_image`` :663-668,
    :786-802) and its per-group partials (``_bwd_pallas`` :1153-1176,
    summed at :1198-1203).  Bound by FP32 operations in f32, by bytes in
    bf16; the token axis split over the grid into partials that are summed
    here in split order (no atomics), the bias column sums taken from the
    same staged slices.  f32 runs on the CUDA cores: 96x96 tiles over (K, N),
    8x6 register tiles of FMAs per thread, 28-row slices of a (by
    ``cp.async``) and of the gathered, scaled g (through registers) in two
    shared stages; as many splits as fill the card with one wave of its
    blocks (:func:`_wgrad_f32_splits`).  bf16 runs on the tensor cores
    (``mma.sync`` m16n8k16, f32 accumulators, 64x64 tiles, 32-row slices
    staged in two shared buffers).
    """
    m, k = a.shape
    n = dy.shape[-1]
    if _check_grad_operand("gemm_wgrad", dy, scale, window) != m:
        raise ValueError(f"gemm_wgrad: a {tuple(a.shape)} dy {tuple(dy.shape)}")
    if a.device.type == "cpu":
        return _torch_gemm_wgrad(a, dy, scale, window, db_rounded)

    a, dy = a.contiguous(), dy.contiguous()
    scale = None if scale is None else scale.contiguous()
    require_cuda("gemm_wgrad", a=(a, KERNEL_DTYPES), dy=(dy, (a.dtype, F32)), scale=(scale, F32))
    if m > 2 ** 31 - 1:  # the kernel takes M as a 32-bit int (its offsets are 64-bit)
        raise ValueError(f"gemm_wgrad: M={m} exceeds a 32-bit int")
    built = _build.library()
    if a.dtype == F32:
        splits = _wgrad_f32_splits(built, a.device.index, m, k, n)
    else:
        tiles = -(-k // _TILE) * -(-n // _TILE)
        splits = _build.partial_count(-(-m // 256), blocks_per_partial=tiles, per_sm=4)
    dw = torch.empty((splits, k, n), device=a.device, dtype=F32)
    db = torch.empty((splits, n), device=a.device, dtype=F32)
    wm = window or WindowMap(0, 0, 0, 0)
    code = built.lib.sei_gemm_wgrad(
        a.device.index, _is_bf16(a), a.data_ptr(), dy.data_ptr(), _is_bf16(dy),
        _build.ptr(scale), dw.data_ptr(), db.data_ptr(), m, k, n, splits,
        m // scale.shape[0] if scale is not None else 0, int(db_rounded),
        int(window is not None), wm.h, wm.w, wm.ws, wm.shift, _build.stream_of(a))
    _build.check(code, "gemm_wgrad")
    gemm_wgrad.launches += 1
    return dw.sum(0), db.sum(0)


gemm_wgrad.launches = 0


@functools.lru_cache(maxsize=None)
def _wgrad_f32_splits(built: _build.Built, device: int, m: int, k: int, n: int) -> int:
    """Partials the f32 weight grad of an (m, k) x (m, n) product writes: as
    many splits of m as fill ``device`` with one wave of the kernel's blocks,
    from the tile and the occupancy of the library ``built`` (the C entry
    ``sei_gemm_wgrad_f32_splits``), at most one per slice of m."""
    splits = built.lib.sei_gemm_wgrad_f32_splits(device, m, k, n)
    if splits <= 0:
        raise RuntimeError(f"gemm_wgrad: no split count for M={m}, K={k}, N={n}")
    return splits


def _torch_ln_rows_bwd(x, gamma, dz, window: Optional[WindowMap] = None, dres=None,
                       out_dtype=None):
    c = x.shape[-1]
    flat = x.reshape(-1, c).float()
    idx = None if window is None else window_rows(x.shape[0], window, x.device)
    rows = flat if idx is None else flat[idx]
    dz = dz.float()
    mu = rows.mean(-1, keepdim=True)
    xc = rows - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS)
    xhat = xc * inv
    g = dz * gamma
    d = (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True)) * inv
    if idx is not None:
        d = torch.empty_like(flat).index_copy_(0, idx, d)
    dx = d.view(x.shape)
    if dres is not None:
        dx = dx + dres.float()
    return dx.to(out_dtype or x.dtype), (dz * xhat).sum(0), dz.sum(0)


def ln_rows_bwd(x, gamma, dz, *, window: Optional[WindowMap] = None, dres=None,
                out_dtype=None):
    """Backward of :func:`ln_rows` given ``dz`` = dL/d(output rows):
    (dx in ``x``'s shape, dgamma, dbeta); ``dres`` (``x``'s shape) is added
    to dx (the residual stream's gradient).  x has the compute dtype; dz and
    dres are f32 or the compute dtype; dx comes out in ``out_dtype`` (f32
    or x's dtype, the default); dgamma and dbeta in f32.

    With a ``window``, row r of ``dz`` belongs to the pixel the window map
    names: x is read there and dx written there (the window reverse +
    unshift folded into the store).

    Kernel ``ln_rows_bwd`` (``csrc/ln_rows_bwd.cu``) replaces the LN
    backward of the TPU trunk's backward (``_ln_bwd``
    ``sei_tpu/ops/swin_trunk.py:252``, called at :672 and :855-857).  Bound
    by bytes; the statistics recomputed from x in f32.  f32: one warp per
    row, dgamma/dbeta as one partial per block, summed here.  bf16: 4
    channels per access, a row to a group of lanes, a cp.async ring of rows
    per warp, dgamma/dbeta summed on the device in a fixed order (no torch
    reduction); it takes C % 4 == 0 and every buffer aligned to 4 elements,
    and raises otherwise (no other kernel takes such a bf16 call).
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
        return _torch_ln_rows_bwd(x, gamma, dz, window, dres, out_dtype)

    x, gamma, dz = x.contiguous(), gamma.contiguous(), dz.contiguous()
    dres = None if dres is None else dres.contiguous()
    cdt = x.dtype
    out_dtype = out_dtype or cdt
    require_cuda("ln_rows_bwd", x=(x, KERNEL_DTYPES), dz=(dz, (cdt, F32)),
                 dres=(dres, (cdt, F32)), gamma=(gamma, F32))
    if out_dtype not in (cdt, F32):
        raise ValueError(f"ln_rows_bwd: out_dtype {out_dtype} with {cdt} x")
    if c > 256:
        raise ValueError(f"ln_rows_bwd: kernel takes C <= 256; got C={c}")
    dx = torch.empty(x.shape, device=x.device, dtype=out_dtype)
    wm = window or WindowMap(0, 0, 0, 0)
    if cdt == BF16:
        dg, db = _ln_rows_bwd_bf16(x, gamma, dz, wm, int(window is not None), dres, dx, rows, c)
    else:
        blocks = _build.partial_count(-(-rows // 16), per_sm=3)
        dg = torch.empty((blocks, c), device=x.device, dtype=F32)
        db = torch.empty((blocks, c), device=x.device, dtype=F32)
        code = _build.library().lib.sei_ln_rows_bwd(
            x.device.index, 0, x.data_ptr(), gamma.data_ptr(), dz.data_ptr(), 0,
            _build.ptr(dres), 0, dx.data_ptr(), 0, dg.data_ptr(), db.data_ptr(), rows, c,
            _EPS, blocks, int(window is not None), wm.h, wm.w, wm.ws, wm.shift,
            _build.stream_of(x))
        _build.check(code, "ln_rows_bwd")
        dg, db = dg.sum(0), db.sum(0)
    ln_rows_bwd.launches += 1
    return dx, dg, db


def _ln_rows_bwd_bf16(x, gamma, dz, wm: WindowMap, windowed: int, dres, dx, rows: int,
                      c: int):
    """The bf16 kernel's launch (one wave of blocks; the last block, or a
    second kernel, sums the blocks' partials): dgamma and dbeta."""
    if c % 4:
        raise ValueError(f"ln_rows_bwd: the bf16 kernel takes C % 4 == 0; got C={c}")
    for name, t in (("x", x), ("dz", dz), ("dres", dres), ("dx", dx)):
        if t is not None and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"ln_rows_bwd: {name} is not aligned to 4 elements")
    built = _build.library()
    flags = (_is_bf16(dz), _is_bf16(dres), _is_bf16(dx))
    blocks = _ln_bwd_bf16_blocks(built, x.device.index, *flags, rows, c)
    part = torch.empty((blocks, 2 * c), device=x.device, dtype=F32)
    dg = torch.empty(c, device=x.device, dtype=F32)
    db = torch.empty(c, device=x.device, dtype=F32)
    code = built.lib.sei_ln_rows_bwd_bf16(
        x.device.index, x.data_ptr(), gamma.data_ptr(), dz.data_ptr(), flags[0],
        _build.ptr(dres), flags[1], dx.data_ptr(), flags[2], part.data_ptr(), dg.data_ptr(),
        db.data_ptr(), rows, c, _EPS, blocks, windowed, wm.h, wm.w, wm.ws, wm.shift,
        _build.stream_of(x))
    _build.check(code, "ln_rows_bwd")
    return dg, db


@functools.lru_cache(maxsize=None)
def _ln_bwd_bf16_blocks(built: _build.Built, device: int, dz_bf16: int, dres_bf16: int,
                        dx_bf16: int, rows: int, c: int) -> int:
    """Blocks of the bf16 LN backward for ``rows`` rows: as many as ``device``
    holds at once (the kernel's occupancy for these types and C, from the
    library ``built``), never more than there are rows for."""
    per_sm = built.lib.sei_ln_rows_bwd_bf16_blocks_per_sm(device, dz_bf16, dres_bf16, dx_bf16, c)
    if per_sm <= 0:
        raise RuntimeError(f"ln_rows_bwd: the bf16 kernel fits no block on an SM (C={c})")
    rows_per_block = 32 * built.lib.sei_ln_rows_bwd_bf16_config(2) \
        // built.lib.sei_ln_rows_bwd_bf16_config(0)
    return _build.partial_count(max(1, -(-rows // rows_per_block)), per_sm=per_sm)


ln_rows_bwd.launches = 0

KERNELS = (ln_rows, gemm_bias_epilogue, window_attn_fwd, gemm_dgrad, gemm_wgrad,
           window_attn_bwd, ln_rows_bwd)


def reset_launch_counts() -> None:
    """Set the launch counters of every trunk kernel to 0 (and
    ``gemm_bias_epilogue``'s GELU launches by form)."""
    for fn in KERNELS:
        fn.launches = 0
    gemm_bias_epilogue.gelu_launches = dict.fromkeys(_GELU_FORMS.values(), 0)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def gelu_launch_counts() -> dict:
    """``gemm_bias_epilogue``'s "gelu" and "gelu_pair" launches by GELU form
    ("exact", "fast") since the last :func:`reset_launch_counts`."""
    return dict(gemm_bias_epilogue.gelu_launches)


# -- the trunk -----------------------------------------------------------------


def _check_trunk(x, params, rpb, dpm, num_heads, window_size):
    b, h, w, c = x.shape
    d = params["ln1_s"].shape[0]
    n = window_size * window_size
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"swin_trunk: x must be float32 or bfloat16, got {x.dtype}")
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
    def t(self) -> int:  # tokens over the batch
        return self.b * self.h * self.w

    @property
    def b_(self) -> int:  # windows over the batch
        return self.b * (self.h // self.ws) * (self.w // self.ws)

    @property
    def scale(self) -> float:
        return self.hd ** -0.5

    def window(self, shift: int) -> WindowMap:
        return WindowMap(self.h, self.w, self.ws, shift)


class _Saved(NamedTuple):
    """What the training forward keeps of one block: its input x and
    mid-block residual x2 (mode ``xs``), and with saves (mode ``full``)
    gelu(h), gelu'(h), the probabilities p and the attention output att."""

    x: torch.Tensor
    x2: torch.Tensor
    gelu: Optional[torch.Tensor] = None
    gelu_grad: Optional[torch.Tensor] = None
    p: Optional[torch.Tensor] = None
    att: Optional[torch.Tensor] = None


def _compute_params(params: dict, cdt: torch.dtype) -> dict:
    """The stacked params as the kernels read them: the GEMM weights cast to
    the compute dtype once per trunk call; biases and LN params stay f32."""
    return {k: params[k].to(cdt) if k in GEMM_WEIGHTS else params[k] for k in PARAM_LEAVES}


def _qkv_views(qkv, dm: _Dims):
    """q, k, v as (B_, nh, N, hd) strided views of a (T, 3C) buffer."""
    t = qkv.view(dm.b_, dm.n, 3, dm.nh, dm.hd)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(3))


def _attention(a, p, rpb_i, mask_i, dm: _Dims, p_out=None):
    """qkv GEMM + window attention -> (qkv (T, 3C), att (T, C)); ``p_out``
    receives the probabilities."""
    qkv = gemm_bias_epilogue(a, p["qkv_w"], p["qkv_b"])
    att = torch.empty((dm.b_, dm.n, dm.nh, dm.hd), device=a.device, dtype=a.dtype)
    window_attn_fwd(*_qkv_views(qkv, dm), rpb_i, mask_i, scale=dm.scale,
                    out=att.transpose(1, 2), p_out=p_out)
    return qkv, att.view(-1, dm.c)


def _chain_forward(x, params, rpb, mask, dpm, dm: _Dims, shift, fast: bool, saves=None,
                   full=False):
    """The forward chain over the compute-dtype ``params``, the GELU's form
    ``fast`` (:func:`use_fast_gelu`); appends each block's :class:`_Saved`
    to ``saves`` when given (mode ``xs``, or ``full`` with ``full``)."""
    c = dm.c
    for i in range(params["ln1_s"].shape[0]):
        p = {k: params[k][i] for k in PARAM_LEAVES}
        shifted = i % 2 == 1 and shift > 0
        wm = dm.window(shift if shifted else 0)
        a = ln_rows(x, p["ln1_s"], p["ln1_b"], window=wm)
        probs = (torch.empty((dm.b_, dm.nh, dm.n, dm.n), device=x.device, dtype=x.dtype)
                 if full else None)
        att = _attention(a, p, rpb[i], mask if shifted else None, dm, probs)[1]
        x2 = gemm_bias_epilogue(att, p["proj_w"], p["proj_b"], "residual",
                                res=x, dpm=dpm[i, 0], window=wm)
        z = ln_rows(x2.view(-1, c), p["ln2_s"], p["ln2_b"])
        gp = None
        if full:
            gp = torch.empty((dm.t, p["fc1_w"].shape[1]), device=x.device, dtype=x.dtype)
            hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu_pair", gp=gp,
                                     fast_gelu=fast)
        else:
            hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu", fast_gelu=fast)
        out = gemm_bias_epilogue(hid, p["fc2_w"], p["fc2_b"], "residual",
                                 res=x2, dpm=dpm[i, 1])
        if saves is not None:
            saves.append(_Saved(x, x2, hid, gp, probs, att) if full else _Saved(x, x2))
        # nothing of this block outlives it unless saved: at the eval's
        # tokens each buffer is GBs, and the next block allocates its own
        del a, att, x2, z, hid, gp, probs
        x = out
    return x


def _block_backward(dout, s: _Saved, p, rpb_i, mask_i, dpm_i, wm: WindowMap, dm: _Dims,
                    fast: bool):
    """One block's backward (the mirror of ``_block_bwd_image``) from its
    saves, its recompute in the forward's GELU form ``fast``: (dx in the
    compute dtype, {leaf: f32 grad}, f32 drpb)."""
    x, x2 = s.x, s.x2
    c, t = dm.c, dm.t
    # recompute with the forward kernels
    a = ln_rows(x, p["ln1_s"], p["ln1_b"], window=wm)
    att = s.att
    if s.p is None and x.dtype != F32:  # bf16 mode xs: the attention forward again
        qkv, att = _attention(a, p, rpb_i, mask_i, dm)
    else:  # mode full, and f32 mode xs, whose attention backward writes att
        qkv = gemm_bias_epilogue(a, p["qkv_w"], p["qkv_b"])
    z = ln_rows(x2.view(-1, c), p["ln2_s"], p["ln2_b"])
    if s.p is None:  # mode xs: fc1 again, gelu' in f32, in the forward's GELU form
        gp = torch.empty((t, p["fc1_w"].shape[1]), device=x.device, dtype=F32)
        hid = gemm_bias_epilogue(z, p["fc1_w"], p["fc1_b"], "gelu_pair", gp=gp, fast_gelu=fast)
    else:  # mode full: only the GEMM operands a, qkv and z
        hid, gp = s.gelu, s.gelu_grad
    g = {}
    # MLP branch: out = x2 + dpm_mlp * fc2(gelu(fc1(LN2(x2))))
    dmlp = dout.view(t, c)
    dh = gemm_dgrad(dmlp, p["fc2_w"], scale=dpm_i[1], gp=gp, out_dtype=F32)
    g["fc2_w"], g["fc2_b"] = gemm_wgrad(hid, dmlp, scale=dpm_i[1])
    g["fc1_w"], g["fc1_b"] = gemm_wgrad(z, dh)
    dz = gemm_dgrad(dh, p["fc1_w"], out_dtype=F32)
    dx2, g["ln2_s"], g["ln2_b"] = ln_rows_bwd(x2.view(t, c), p["ln2_s"], dz, dres=dmlp,
                                              out_dtype=F32)
    dx2 = dx2.view(x.shape)
    # attention branch: x2 = x + dpm_attn * unwindow(proj(attention(LN1(x))))
    datt = gemm_dgrad(dx2, p["proj_w"], scale=dpm_i[0], window=wm)
    att_out = None
    if att is None:  # att from the p the attention backward recomputes
        att = torch.empty((dm.b_, dm.n, dm.nh, dm.hd), device=x.device, dtype=x.dtype)
        att_out = att.transpose(1, 2)
        att = att.view(-1, c)
    dqkv = torch.empty_like(qkv)
    *_, drpb = window_attn_bwd(
        *_qkv_views(qkv, dm), rpb_i, mask_i,
        datt.view(dm.b_, dm.n, dm.nh, dm.hd).transpose(1, 2), scale=dm.scale,
        out=_qkv_views(dqkv, dm), p=s.p, att_out=att_out)
    g["proj_w"], g["proj_b"] = gemm_wgrad(att, dx2, scale=dpm_i[0], window=wm, db_rounded=True)
    g["qkv_w"], g["qkv_b"] = gemm_wgrad(a, dqkv)
    da = gemm_dgrad(dqkv, p["qkv_w"])
    dx, g["ln1_s"], g["ln1_b"] = ln_rows_bwd(x, p["ln1_s"], da, window=wm, dres=dx2)
    return dx, g, drpb


class _TrunkFn(torch.autograd.Function):
    """The trunk with its backward on the kernels (the counterpart of
    ``_trunk_pallas``'s custom VJP): the forward keeps each block's saves
    (mode ``full`` when ``full``, else ``xs``), the backward walks the
    blocks in reverse and recomputes the rest, in the GELU form the forward
    took (kept on ``ctx``, never read again from the environment).  Returns
    dx (x's dtype), drpb and the 12 stacked f32 parameter grads; dpm and the
    mask take none."""

    @staticmethod
    def forward(ctx, x, rpb, dpm, mask, num_heads, window_size, full, fast_gelu, *leaves):
        params = dict(zip(PARAM_LEAVES, leaves))
        b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
        dm = _Dims(b, h, w, c, num_heads, window_size)
        cparams = _compute_params(params, x.dtype)
        fast = use_fast_gelu(x.dtype, fast_gelu)
        saves = []
        y = _chain_forward(x.contiguous(), cparams, rpb, mask, dpm, dm, shift, fast, saves, full)
        ctx.save_for_backward(rpb, dpm)
        ctx.saves, ctx.params, ctx.mask, ctx.dm, ctx.shift = saves, cparams, mask, dm, shift
        ctx.fast_gelu = fast
        return y

    @staticmethod
    def backward(ctx, dy):
        rpb, dpm = ctx.saved_tensors
        params, dm, shift = ctx.params, ctx.dm, ctx.shift
        d = len(ctx.saves)
        grads = {k: [None] * d for k in PARAM_LEAVES}
        drpb = [None] * d
        g = dy.contiguous()
        for i in reversed(range(d)):
            shifted = i % 2 == 1 and shift > 0
            wm = dm.window(shift if shifted else 0)
            p = {k: params[k][i] for k in PARAM_LEAVES}
            g, gi, drpb[i] = _block_backward(g, ctx.saves[i], p, rpb[i],
                                             ctx.mask if shifted else None, dpm[i], wm, dm,
                                             ctx.fast_gelu)
            ctx.saves[i] = None  # free the block's saves as soon as they are used
            for k in PARAM_LEAVES:
                grads[k][i] = gi[k]
        ctx.saves = ctx.params = None
        return (g, torch.stack(drpb), None, None, None, None, None, None,
                *(torch.stack(grads[k]) for k in PARAM_LEAVES))


def swin_trunk(x, params: dict, rpb, mask, dpm, *, num_heads: int, window_size: int,
               saves: Optional[bool] = None, fast_gelu: Optional[bool] = None):
    """D SwinBlocks on x (B, H, W, C) through the kernel chain, in x's dtype
    (float32, or bfloat16 with f32 params, rpb, mask and dpm).

    params: the stacked ``PARAM_LEAVES`` (D, ...) in the JAX layout (weights
    in x out); rpb (D, nh, N, N); mask (nW, N, N) or None; dpm (D, 2, B).
    Blocks alternate no-shift / shift (shift ws//2 unless min(H, W) <= ws).
    Differentiable in x, rpb and params: when autograd needs a gradient the
    call goes through :class:`_TrunkFn`; otherwise only the forward chain
    runs.  ``saves`` picks the training forward's mode: True keeps gelu(h),
    gelu'(h), p and att per block for the saved-tensor backward (mode
    ``full``), False keeps x and x2 only for the recompute backward (mode
    ``xs``); None means on for bf16 and off for f32, the JAX package's
    default (``saves_on``, overridden there by ``SEI_TRUNK_SAVES``).
    ``fast_gelu`` picks the GELU's form (:func:`use_fast_gelu`: None reads
    ``SEI_FAST_GELU``, unset the polynomial in bf16 and exact in f32); the
    backward recomputes in the form its forward took.
    """
    mask = _as_mask(mask, x)
    full = x.dtype == BF16 if saves is None else bool(saves)
    leaves = [params[k] for k in PARAM_LEAVES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, rpb, *leaves)):
        return _TrunkFn.apply(x, rpb, dpm, mask, num_heads, window_size, full, fast_gelu,
                              *leaves)
    b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
    return _chain_forward(x.contiguous(), _compute_params(params, x.dtype), rpb, mask, dpm,
                          _Dims(b, h, w, c, num_heads, window_size), shift,
                          use_fast_gelu(x.dtype, fast_gelu))


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
                    window_size: int, fast_gelu: Optional[bool] = None):
    """Plain PyTorch trunk: the same function as :func:`swin_trunk`, written
    the straightforward way (roll, window partition, per-head attention,
    window reverse), independent of the kernels' row maps.  In bf16 it
    rounds where the JAX ``trunk_reference`` rounds (the products in f32 from
    bf16-rounded operands, never a torch bf16 matmul); in f32 every rounding
    is a no-op.  Its GELU is the polynomial or the exact form as
    ``use_fast_gelu(x.dtype, fast_gelu)`` says."""
    b, h, w, c, d, shift = _check_trunk(x, params, rpb, dpm, num_heads, window_size)
    mask = _as_mask(mask, x)
    cdt = x.dtype
    fast = use_fast_gelu(cdt, fast_gelu)
    ws, nh = window_size, num_heads
    n, hd = ws * ws, c // nh

    def r(t):
        return _round(t, cdt)

    x = x.float()
    for i in range(d):
        p = {k: params[k][i] for k in PARAM_LEAVES}
        shifted = i % 2 == 1 and shift > 0
        a = r(_ln(x, p["ln1_s"], p["ln1_b"]))
        if shifted:
            a = torch.roll(a, (-shift, -shift), dims=(1, 2))
        tok = _window_tokens(a, ws)
        qkv = r(tok @ r(p["qkv_w"]) + p["qkv_b"]).reshape(-1, n, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        probs = r(_probs(q, k, rpb[i], mask if shifted else None, hd ** -0.5))
        att = r(probs @ v)
        o = r(att.transpose(1, 2).reshape(-1, n, c) @ r(p["proj_w"]) + p["proj_b"])
        y = _unwindow_tokens(o, b, h, w, ws)
        if shifted:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x2 = r(x + dpm[i, 0][:, None, None, None] * y)
        hid = r(_ln(x2, p["ln2_s"], p["ln2_b"])) @ r(p["fc1_w"]) + p["fc1_b"]
        # autograd through the polynomial keeps ~20 tensors of hid's size per
        # block (tens of GB over a training step's graphs): it is recomputed
        # in the backward instead, the same operations and the same bits
        m = r(checkpoint(_gelu_fast, hid, use_reentrant=False) if fast else F.gelu(hid))
        m = r(m @ r(p["fc2_w"]) + p["fc2_b"])
        x = r(x2 + dpm[i, 1][:, None, None, None] * m)
    return x.to(cdt)


__all__ = [
    "KERNELS", "PARAM_LEAVES", "WindowMap", "gelu_launch_counts", "gemm_bias_epilogue",
    "gemm_dgrad", "gemm_wgrad", "launch_counts", "ln_rows", "ln_rows_bwd",
    "reset_launch_counts", "swin_trunk", "trunk_reference", "use_fast_gelu", "window_rows",
]
