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

On a CPU tensor the wrapper runs the plain PyTorch version
(:func:`_torch_attention`, the mirror of ``_xla_attention`` :29-39); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import require_cuda_f32
from . import _build


def _torch_attention(q, k, v, bias, mask, scale: float = 1.0):
    """Plain version: softmax(scale * q k^T + bias (+ mask)) v, f32 scores."""
    attn = torch.matmul(q, k.transpose(-2, -1)) * scale
    attn = attn + bias[None]
    if mask is not None:
        b_, nh, n, _ = attn.shape
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, nh, n, n) + mask[None, :, None]
        attn = attn.view(b_, nh, n, n)
    return torch.matmul(torch.softmax(attn, dim=-1), v)


def _as_mask(mask, like: torch.Tensor) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(np.ascontiguousarray(mask, np.float32))
    return mask.to(device=like.device, dtype=torch.float32)


def window_attn_fwd(q, k, v, bias, mask=None, *, scale: float = 1.0, out=None):
    """softmax(scale * q k^T + bias[h] (+ mask[w % nW])) v -> (B_, nh, N, hd).

    q, k, v and ``out`` may be strided views (the head-dim stride must be 1);
    ``out`` is written in place when given.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    mask = _as_mask(mask, q)
    b_, nh, n, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attn_fwd: q/k/v shapes {q.shape} {k.shape} {v.shape}")
    if bias.shape != (nh, n, n):
        raise ValueError(f"window_attn_fwd: bias shape {tuple(bias.shape)}")
    if mask is not None and (mask.shape[1:] != (n, n) or b_ % mask.shape[0]):
        raise ValueError(f"window_attn_fwd: mask shape {tuple(mask.shape)} for B_={b_}")
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


# The JAX package's name for the same call: q/k/v (B_, nh, N, hd) with q
# pre-scaled, bias (nh, N, N), mask (nW, N, N) array or None.
window_attention = window_attn_fwd
