"""Window attention forward and backward: hand-written CUDA kernels for Hopper.

Counterpart of ``sei_tpu/ops/attention.py``.  Layouts follow the JAX
package: q, k, v are (B_, nh, N, hd) with q pre-scaled; bias (nh, N, N);
optional mask (nW, N, N) indexed by window (B_ = B * nW, windows batch-major).
q, k, v, the output, the gradients and the saved probabilities share one
storage type, float32 or bfloat16 (the bf16 training recipe); bias, mask,
scores, softmax and dbias are f32.  In bf16 the probabilities are rounded
before P.V reads them and the outputs are rounded, where the JAX trunk casts
(``sei_tpu/ops/swin_trunk.py`` :467-473, :779, :797-800).

Kernel ``window_attn_fwd`` (``csrc/window_attn_fwd.cu``):
  * replaces ``sei_tpu/ops/attention.py:94`` ``_fwd_pallas`` ->
    ``_fwd_kernel`` (:65) and the attention core of the TPU trunk kernel
    (``sei_tpu/ops/swin_trunk.py`` :446-477), with the probability save of
    mode ``full`` (``p_ref``, :487-490) as ``p_out``;
  * bound on the H100: at N = 64, hd = 30 about 16 flops per byte of q/k/v/out
    in f32, near the FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so both the
    CUDA-core FMAs and the bytes count; in bf16 (989 TFLOP/s) bytes bound it;
  * design: scores and probabilities kept on chip (in device memory only
    when saved), f32 max-subtracted softmax, strided q/k/v/out so the trunk
    reads them straight from its qkv GEMM; one block per (head, group of
    windows), groups sized from the kernel's occupancy (one wave), each
    window copied by ``cp.async`` while the one before computes.  bf16
    (``window_attn_fwd_mma_kernel``, K5's attention with its p save, and
    every bf16 call without it): both products on the tensor cores
    (``mma.sync`` m16n8k16, f32 accumulators), as the TPU runs them on the
    MXU, 4 warps of 16 query rows, bias[h] in registers, the f32 softmax in
    the accumulators' layout, p rounded and packed from the accumulators
    into P.V's operand fragments, the next windows copied into a ring of
    stages; bound at T = 36864 by its 81.4 MB of q, k, v, out and p (0.0243
    ms at 3.35 TB/s).  Its scores and softmax are
    ``csrc/window_attn_bf16.cuh``'s, which the bf16 backward's recompute
    form runs too: the p it saves equals, bit for bit, the p the backward
    recomputes for dv.  f32 (``window_attn_fwd_f32_kernel``): the f32
    backward's register micro-tiles of S and P on 256 threads and its P.V
    product from a shared P tile, two stages; its p and its output equal
    the f32 backward's recomputed p and ``att_out`` bit for bit.

Kernel ``window_attn_bwd`` (``csrc/window_attn_bwd.cu``):
  * replaces ``sei_tpu/ops/attention.py:155`` ``_bwd_pallas`` ->
    ``_bwd_kernel`` (:117) and the attention part of the TPU trunk's backward
    (``sei_tpu/ops/swin_trunk.py`` :733-805), with p recomputed
    (``with_saved=False``) or read from the forward's save (``p``,
    ``with_saved=True``: no q k^T, no softmax);
  * bound on the H100: ~23 flops per byte of q/k/v/do/dq/dk/dv in f32, at the
    FP32 ridge again; bytes in bf16 (~21 flops per byte against the tensor
    cores' ridge of 295);
  * design: one block per (head, group of windows), p recomputed with the
    forward's softmax or loaded, dbias summed over the
    group's windows in registers and written as one partial per block; the
    wrapper sums the partials (no atomics, so the gradient repeats run to
    run).  f32 (``window_attn_bwd_f32_kernel``): register micro-tiles of
    S, P, dP and dS on 256 threads, the 64x32 products two at a time from
    shared P / dS tiles, each window staged by ``cp.async``; it can also
    write att = P.V from the p it recomputes (``att_out``), so the trunk's
    f32 recompute backward launches no attention forward.  bf16
    (``window_attn_bwd_mma_kernel``, saved or recomputed p): the products
    on the tensor cores (``mma.sync`` m16n8k16, f32 accumulators), 4 warps
    of 16 query and key rows each, dS from the accumulators straight into
    dQ's operand fragments, the next two windows copied by ``cp.async``
    during this one.

:func:`window_attention` is the differentiable op (a ``torch.autograd.Function``
whose forward is ``window_attn_fwd`` and whose backward is
``window_attn_bwd``), the counterpart of ``_window_attention_pallas``
(:204-220).  On a CPU tensor each wrapper runs its plain PyTorch version
(:func:`_torch_attention`, the mirror of ``_xla_attention`` :29-39, and
:func:`_torch_attention_bwd`), which multiplies in f32 and rounds where the
kernels round; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..device import KERNEL_DTYPES, require_cuda
from . import _build

F32 = torch.float32


def _probs(q, k, bias, mask, scale: float):
    """f32 softmax(scale * q k^T + bias (+ mask)) from q, k of any float type."""
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    attn = attn + bias[None]
    if mask is not None:
        b_, nh, n, _ = attn.shape
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, nh, n, n) + mask[None, :, None]
        attn = attn.view(b_, nh, n, n)
    return torch.softmax(attn, dim=-1)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and carried on in f32 (a no-op for f32)."""
    return t.to(dtype).float()


def _torch_attention(q, k, v, bias, mask, scale: float = 1.0, p_out=None):
    """Plain version: softmax(scale * q k^T + bias (+ mask)) v, f32 scores;
    p rounded to q's dtype before P.V (and copied to ``p_out`` when given),
    the output rounded to it."""
    p = _round(_probs(q, k, bias, mask, scale), q.dtype)
    if p_out is not None:
        p_out.copy_(p)
    return torch.matmul(p, v.float()).to(q.dtype)


def _torch_attention_bwd(q, k, v, bias, mask, do, scale: float = 1.0, p=None,
                         with_att: bool = False):
    """Plain version of the backward (the mirror of ``_bwd_kernel`` and of
    the trunk backward's attention, :754-805): (dq, dk, dv, dbias) with p
    recomputed, or the saved ``p``, and dbias summed over windows; with
    ``with_att`` also att = P.V from the same p, as :func:`_torch_attention`
    computes it (the TPU trunk's ``t_parts``, :768-772)."""
    cdt = q.dtype
    p32 = _probs(q, k, bias, mask, scale) if p is None else p.float()
    pc = _round(p32, cdt)
    do32 = do.float()
    dv = torch.matmul(pc.transpose(-2, -1), do32)
    dp = torch.matmul(do32, v.float().transpose(-2, -1))
    ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    dsc = _round(ds, cdt)
    dq = torch.matmul(dsc, k.float()) * scale
    dk = torch.matmul(dsc.transpose(-2, -1), q.float()) * scale
    grads = (dq.to(cdt), dk.to(cdt), dv.to(cdt), ds.sum(0))
    if not with_att:
        return grads
    return (*grads, torch.matmul(pc, v.float()).to(cdt))


def _as_mask(mask, like: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(np.ascontiguousarray(mask, np.float32))
    return mask.to(device=like.device, dtype=torch.float32)


def _check_shapes(name, q, k, v, bias, mask):
    b_, nh, n, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v shapes {q.shape} {k.shape} {v.shape}")
    if bias.shape != (nh, n, n):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)}")
    if mask is not None and (mask.shape[1:] != (n, n) or b_ % mask.shape[0]):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)} for B_={b_}")
    return b_, nh, n, hd


def _check_probs(name, p, q):
    b_, nh, n, _ = q.shape
    if p is not None and (p.shape != (b_, nh, n, n) or not p.is_contiguous()):
        raise ValueError(f"{name}: p must be a contiguous {(b_, nh, n, n)} tensor")


def window_attn_fwd(q, k, v, bias, mask=None, *, scale: float = 1.0, out=None, p_out=None):
    """softmax(scale * q k^T + bias[h] (+ mask[w % nW])) v -> (B_, nh, N, hd).

    q, k, v and ``out`` may be strided views (the head-dim stride must be 1);
    ``out`` is written in place when given.  ``p_out`` (B_, nh, N, N),
    contiguous, of q's dtype, receives the probabilities as P.V read them
    (the training forward's save).  CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    mask = _as_mask(mask, q)
    b_, nh, n, hd = _check_shapes("window_attn_fwd", q, k, v, bias, mask)
    _check_probs("window_attn_fwd", p_out, q)
    if q.device.type == "cpu":
        res = _torch_attention(q, k, v, bias, mask, scale, p_out)
        if out is None:
            return res
        out.copy_(res)
        return out

    if out is None:
        out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    bias = bias.contiguous()
    mask = None if mask is None else mask.contiguous()
    cdt = q.dtype
    require_cuda("window_attn_fwd", q=(q, KERNEL_DTYPES), k=(k, cdt), v=(v, cdt),
                 out=(out, cdt), p_out=(p_out, cdt), bias=(bias, F32), mask=(mask, F32))
    if out.shape != q.shape:
        raise ValueError(f"window_attn_fwd: out shape {tuple(out.shape)}")
    if n > 64 or hd > 32:
        raise ValueError(f"window_attn_fwd: kernel takes N <= 64, hd <= 32; got {n}, {hd}")
    built = _build.library()
    # one block per (head, group of windows), as many as the kernel fits on
    # the card at once: one wave
    per_sm = _blocks_per_sm(built, q.device.index, "fwd_f32" if cdt == F32 else "fwd_bf16")
    groups = _build.partial_count(b_, blocks_per_partial=nh, per_sm=per_sm)
    code = built.lib.sei_window_attn_fwd(
        q.device.index, int(cdt == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _build.ptr(mask), out.data_ptr(), _build.ptr(p_out),
        b_, nh, n, hd, 0 if mask is None else mask.shape[0], groups,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _build.stream_of(q))
    _build.check(code, "window_attn_fwd")
    window_attn_fwd.launches += 1
    return out


window_attn_fwd.launches = 0


def window_attn_bwd(q, k, v, bias, mask, do, *, scale: float = 1.0, out=None, p=None,
                    att_out=None):
    """Gradients of :func:`window_attn_fwd` given ``do`` = dL/d(output):
    (dq, dk, dv, dbias), dbias (nh, N, N) f32, summed over all windows.

    q, k, v, do and the (dq, dk, dv) buffers of ``out`` may be strided views
    (head-dim stride 1); ``out`` is written in place when given.  ``p``: the
    forward's saved probabilities (``p_out``), read in place of recomputing
    them from q, k, bias and mask.  ``att_out`` (f32 only; q's shape, may be
    strided) receives the attention output P.V from the same p, what
    :func:`window_attn_fwd` returns for these inputs.  CPU tensors take the
    plain version; CUDA tensors launch the kernel, which writes one dbias
    partial per block; the partials are summed here.
    """
    mask = _as_mask(mask, q)
    b_, nh, n, hd = _check_shapes("window_attn_bwd", q, k, v, bias, mask)
    _check_probs("window_attn_bwd", p, q)
    if do.shape != q.shape:
        raise ValueError(f"window_attn_bwd: do shape {tuple(do.shape)}")
    if out is not None and any(t.shape != q.shape for t in out):
        raise ValueError("window_attn_bwd: out buffers must have q's shape")
    if att_out is not None and att_out.shape != q.shape:
        raise ValueError(f"window_attn_bwd: att_out shape {tuple(att_out.shape)}")
    if q.device.type == "cpu":
        res = _torch_attention_bwd(q, k, v, bias, mask, do, scale, p,
                                   with_att=att_out is not None)
        if att_out is not None:
            att_out.copy_(res[4])
        dq, dk, dv, dbias = res[:4]
        if out is None:
            return dq, dk, dv, dbias
        for buf, g in zip(out, (dq, dk, dv)):
            buf.copy_(g)
        return (*out, dbias)

    if out is None:
        out = tuple(torch.empty(q.shape, device=q.device, dtype=q.dtype) for _ in range(3))
    dq, dk, dv = out
    bias = bias.contiguous()
    mask = None if mask is None else mask.contiguous()
    cdt = q.dtype
    if att_out is not None and cdt != F32:
        raise ValueError("window_attn_bwd: att_out is f32 only on CUDA")
    require_cuda("window_attn_bwd", q=(q, KERNEL_DTYPES), k=(k, cdt), v=(v, cdt), do=(do, cdt),
                 dq=(dq, cdt), dk=(dk, cdt), dv=(dv, cdt), p=(p, cdt), att_out=(att_out, F32),
                 bias=(bias, F32), mask=(mask, F32))
    if n > 64 or hd > 32:
        raise ValueError(f"window_attn_bwd: kernel takes N <= 64, hd <= 32; got {n}, {hd}")
    built = _build.library()
    # as many blocks as the kernel fits on an SM: one wave
    if cdt == torch.bfloat16:
        per_sm = _blocks_per_sm(built, q.device.index, "bwd_bf16")
    else:
        per_sm = _blocks_per_sm(built, q.device.index, "bwd_f32", int(att_out is not None))
    groups = _build.partial_count(b_, blocks_per_partial=nh, per_sm=per_sm)
    part = torch.empty((groups, nh, n, n), device=q.device, dtype=torch.float32)
    strided = (q, k, v, do, dq, dk, dv, q if att_out is None else att_out)
    code = built.lib.sei_window_attn_bwd(
        q.device.index, int(cdt == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _build.ptr(mask), _build.ptr(p), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _build.ptr(att_out), part.data_ptr(), b_, nh, n, hd,
        0 if mask is None else mask.shape[0], groups,
        *(s for t in strided for s in t.stride()[:3]), float(scale), _build.stream_of(q))
    _build.check(code, "window_attn_bwd")
    window_attn_bwd.launches += 1
    return dq, dk, dv, part.sum(0)


window_attn_bwd.launches = 0


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(built: _build.Built, device: int, kernel: str, *args: int) -> int:
    """Blocks of ``kernel`` (``"fwd_f32"``, ``"fwd_bf16"``, ``"bwd_f32"`` with
    or without the att store, ``"bwd_bf16"``) that one SM of ``device``
    holds, from the CUDA occupancy calculator."""
    n = getattr(built.lib, f"sei_window_attn_{kernel}_blocks_per_sm")(device, *args)
    if n <= 0:
        raise RuntimeError(f"window_attn_{kernel}: the kernel fits no block on an SM")
    return n


class _WindowAttentionFn(torch.autograd.Function):
    """forward ``window_attn_fwd``, backward ``window_attn_bwd``; the mask
    and scale take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask, ctx.scale = mask, scale
        return window_attn_fwd(q, k, v, bias, mask, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attn_bwd(q, k, v, bias, ctx.mask, do.contiguous(),
                                            scale=ctx.scale)
        return dq, dk, dv, dbias, None, None


def window_attention(q, k, v, bias, mask=None, *, scale: float = 1.0):
    """Differentiable window attention under the JAX package's name: q/k/v
    (B_, nh, N, hd) (q pre-scaled there; ``scale`` multiplies the scores
    here), bias (nh, N, N), mask (nW, N, N) array or None."""
    return _WindowAttentionFn.apply(q, k, v, bias, _as_mask(mask, q), scale)
