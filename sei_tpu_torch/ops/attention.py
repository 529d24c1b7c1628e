"""Window attention forward: a hand-written CUDA kernel for Hopper.

Counterpart of ``sei_tpu/ops/attention.py``.  Layouts follow the JAX
package: q, k, v are (B_, nh, N, hd) with q pre-scaled; bias (nh, N, N);
optional mask (nW, N, N) indexed by window (B_ = B * nW, windows batch-major).

Kernel ``window_attn_fwd`` (``csrc/window_attn_fwd.cu``):
  * replaces ``sei_tpu/ops/attention.py:94`` ``_fwd_pallas`` ->
    ``_fwd_kernel`` (:65) and the attention core of the TPU trunk kernel
    (``sei_tpu/ops/swin_trunk.py`` :446-477);
  * bound on the H100: at N = 64, hd = 30 about 16 flops per byte of q/k/v/out,
    near the FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so both the CUDA-core
    FMAs and the bytes count;
  * design: one block per (window, head), scores and probabilities kept in
    shared memory (never in device memory), f32 max-subtracted softmax,
    strided q/k/v/out so the trunk reads them straight from its qkv GEMM.

Kernel ``window_attn_bwd`` (``csrc/window_attn_bwd.cu``):
  * replaces ``sei_tpu/ops/attention.py:155`` ``_bwd_pallas`` ->
    ``_bwd_kernel`` (:117) and the attention part of the TPU trunk's backward
    (``sei_tpu/ops/swin_trunk.py`` :733-805);
  * bound on the H100: ~23 flops per byte of q/k/v/do/dq/dk/dv, at the FP32
    ridge again;
  * design: one block per (head, group of windows), p recomputed in shared
    memory (bit-identical to the forward's), dbias summed over the group's
    windows in registers and written as one partial per block; the wrapper
    sums the partials (no atomics, so the gradient repeats run to run).

:func:`window_attention` is the differentiable op (a ``torch.autograd.Function``
whose forward is ``window_attn_fwd`` and whose backward is
``window_attn_bwd``), the counterpart of ``_window_attention_pallas``
(:204-220).  On a CPU tensor each wrapper runs its plain PyTorch version
(:func:`_torch_attention`, the mirror of ``_xla_attention`` :29-39, and
:func:`_torch_attention_bwd`); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import require_cuda_f32
from . import _build


def _probs(q, k, bias, mask, scale: float):
    attn = torch.matmul(q, k.transpose(-2, -1)) * scale
    attn = attn + bias[None]
    if mask is not None:
        b_, nh, n, _ = attn.shape
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, nh, n, n) + mask[None, :, None]
        attn = attn.view(b_, nh, n, n)
    return torch.softmax(attn, dim=-1)


def _torch_attention(q, k, v, bias, mask, scale: float = 1.0):
    """Plain version: softmax(scale * q k^T + bias (+ mask)) v, f32 scores."""
    return torch.matmul(_probs(q, k, bias, mask, scale), v)


def _torch_attention_bwd(q, k, v, bias, mask, do, scale: float = 1.0):
    """Plain version of the backward (the mirror of ``_bwd_kernel``):
    (dq, dk, dv, dbias) with p recomputed and dbias summed over windows."""
    p = _probs(q, k, bias, mask, scale)
    dv = torch.matmul(p.transpose(-2, -1), do)
    dp = torch.matmul(do, v.transpose(-2, -1))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-2, -1), q) * scale
    return dq, dk, dv, ds.sum(0)


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


def window_attn_fwd(q, k, v, bias, mask=None, *, scale: float = 1.0, out=None):
    """softmax(scale * q k^T + bias[h] (+ mask[w % nW])) v -> (B_, nh, N, hd).

    q, k, v and ``out`` may be strided views (the head-dim stride must be 1);
    ``out`` is written in place when given.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    mask = _as_mask(mask, q)
    b_, nh, n, hd = _check_shapes("window_attn_fwd", q, k, v, bias, mask)
    if q.device.type == "cpu":
        res = _torch_attention(q, k, v, bias, mask, scale)
        if out is None:
            return res
        out.copy_(res)
        return out

    if out is None:
        out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    bias = bias.contiguous()
    mask = None if mask is None else mask.contiguous()
    require_cuda_f32("window_attn_fwd", q, k, v, bias, mask, out)
    if out.shape != q.shape:
        raise ValueError(f"window_attn_fwd: out shape {tuple(out.shape)}")
    if n > 64 or hd > 32:
        raise ValueError(f"window_attn_fwd: kernel takes N <= 64, hd <= 32; got {n}, {hd}")
    lib = _build.library().lib
    code = lib.sei_window_attn_fwd(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), _build.ptr(mask), out.data_ptr(),
        b_, nh, n, hd, 0 if mask is None else mask.shape[0],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _build.stream_of(q))
    _build.check(code, "window_attn_fwd")
    window_attn_fwd.launches += 1
    return out


window_attn_fwd.launches = 0


def window_attn_bwd(q, k, v, bias, mask, do, *, scale: float = 1.0, out=None):
    """Gradients of :func:`window_attn_fwd` given ``do`` = dL/d(output):
    (dq, dk, dv, dbias), dbias (nh, N, N) summed over all windows.

    q, k, v, do and the (dq, dk, dv) buffers of ``out`` may be strided views
    (head-dim stride 1); ``out`` is written in place when given.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    writes one dbias partial per block; the partials are summed here.
    """
    mask = _as_mask(mask, q)
    b_, nh, n, hd = _check_shapes("window_attn_bwd", q, k, v, bias, mask)
    if do.shape != q.shape:
        raise ValueError(f"window_attn_bwd: do shape {tuple(do.shape)}")
    if out is not None and any(t.shape != q.shape for t in out):
        raise ValueError("window_attn_bwd: out buffers must have q's shape")
    if q.device.type == "cpu":
        dq, dk, dv, dbias = _torch_attention_bwd(q, k, v, bias, mask, do, scale)
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
    require_cuda_f32("window_attn_bwd", q, k, v, bias, mask, do, dq, dk, dv)
    if n > 64 or hd > 32:
        raise ValueError(f"window_attn_bwd: kernel takes N <= 64, hd <= 32; got {n}, {hd}")
    groups = _build.partial_count(b_, blocks_per_partial=nh, per_sm=3)
    part = torch.empty((groups, nh, n, n), device=q.device, dtype=torch.float32)
    code = _build.library().lib.sei_window_attn_bwd(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        _build.ptr(mask), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        part.data_ptr(), b_, nh, n, hd, 0 if mask is None else mask.shape[0], groups,
        *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]),
        float(scale), _build.stream_of(q))
    _build.check(code, "window_attn_bwd")
    window_attn_bwd.launches += 1
    return dq, dk, dv, part.sum(0)


window_attn_bwd.launches = 0


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
