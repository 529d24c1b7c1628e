"""Launch-overhead probes: a copy kernel and a trunk skeleton, hand-written
CUDA kernels for Hopper (``csrc/launch_probe.cu``).

Counterparts of the JAX package's TPU probes, which measured the fixed cost
of a ``pallas_call`` and of the trunk kernel's scaffolding apart from its
compute.  On the H100 the same question is what one launch through the
port's ``ctypes`` route (``ops/_build.py``) costs the host and the device,
against what a block of work costs.

Kernel ``copy_probe`` replaces the copy kernels of
``experiments/perf_probe_r3p.py:48`` (``one_copy``), ``perf_probe_r3q.py:50``
(``one_copy``) and ``perf_probe_r3m.py:98`` (``mk_copy``, ``y = x``): bound by
bytes, a grid-stride loop of 16-byte accesses over ``blocks`` thread blocks,
the elements before the first 16-byte boundary and after the last whole
16 bytes one at a time.

Kernel ``trunk_skeleton`` replaces the trunk skeletons of
``experiments/perf_probe_r3r.py:98`` (``mk_a``) and ``perf_probe_r3s.py:104``
(``mk``): the trunk's argument list without compute, variants by flag (v_a /
v_e body-less, v_b with the xs/xs2 outputs, v_d with the staged residual
body, v_g with its drop-path reads).  r3r's v_c (scratch allocation) and v_f
(a 1-D grid) have no GPU counterpart: a CUDA block has no VMEM scratch to
allocate, and a launch has no sequential grid.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, counting launches in ``.launches``.
Both kernels compute in f32 and round once per stored value, so on the card
they equal their plain versions exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import KERNEL_DTYPES, require_cuda
from . import _build
from .swin_trunk import PARAM_LEAVES, _is_bf16

F32 = torch.float32


# -- copy_probe ----------------------------------------------------------------


def _torch_copy_probe(x: torch.Tensor, add: bool = True) -> torch.Tensor:
    return (x.float() + (1.0 if add else 0.0)).to(x.dtype)


def _output_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous tensor of x's shape and dtype whose first
    element lies as far from a 16-byte boundary as x's (a view into a
    buffer one 16-byte pack longer), so the kernel's 16-byte accesses align
    on both."""
    per = 16 // x.element_size()
    off = (x.data_ptr() % 16) // x.element_size()
    buf = torch.empty(x.numel() + per, device=x.device, dtype=x.dtype)
    return buf[off:off + x.numel()].view(x.shape)


def copy_probe(x: torch.Tensor, *, blocks: int, add: bool = True) -> torch.Tensor:
    """``y = x + 1`` (``add``) or ``y = x``, in x's dtype (f32 or bf16, the
    sum in f32 and rounded once), on ``blocks`` thread blocks.  On the card
    y starts as far from a 16-byte boundary as x does."""
    if blocks < 1:
        raise ValueError(f"copy_probe: blocks must be >= 1, got {blocks}")
    if x.device.type == "cpu":
        return _torch_copy_probe(x, add)
    require_cuda("copy_probe", x=(x, KERNEL_DTYPES))
    if not x.is_contiguous():
        raise ValueError("copy_probe: x must be contiguous")
    y = _output_like(x)
    code = _build.library().lib.sei_copy_probe(
        x.device.index, _is_bf16(x), x.data_ptr(), y.data_ptr(), x.numel(), blocks, int(add),
        _build.stream_of(x))
    _build.check(code, "copy_probe")
    copy_probe.launches += 1
    return y


copy_probe.launches = 0


# -- trunk_skeleton ------------------------------------------------------------


def _torch_trunk_skeleton(x, dpm, depth: int, outputs: bool, body: bool, dpm_reads: bool):
    cdt = x.dtype
    xs = xs2 = None
    if outputs:
        xs = torch.zeros((depth, *x.shape), device=x.device, dtype=cdt)
        xs2 = torch.zeros_like(xs)
    if not body:
        return (x.float() + 1.0).to(cdt), xs, xs2
    v = x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    for j in range(depth):
        a = dpm[j, 0].view(shape) if dpm_reads else 1.0
        m = dpm[j, 1].view(shape) if dpm_reads else 1.0
        x2 = (v.float() + 0.5 * a).to(cdt)
        if outputs:
            xs[j], xs2[j] = v, x2
        v = (x2.float() + 0.25 * m).to(cdt)
    return v, xs, xs2


def trunk_skeleton(x: torch.Tensor, params: Optional[dict] = None, rpb=None, mask=None,
                   dpm=None, *, outputs: bool = False, body: bool = False,
                   dpm_reads: bool = False):
    """The trunk call's scaffolding on x (B, H, W, C), f32 or bf16: the
    stacked ``params`` (``PARAM_LEAVES``, D blocks), rpb, mask and dpm
    (D, 2, B) are the trunk's arguments, but no weight enters the result.

    Without ``body``: ``y = x + 1``, and with ``outputs`` xs, xs2 (D, B, H,
    W, C) of zeros (v_a, v_b; ``params=None`` and no other input: v_e).
    With ``body``: for each block j, ``xs[j] = x``, ``x2 = rnd(x + 0.5 a)``,
    ``xs2[j] = x2``, ``x = rnd(x2 + 0.25 m)``, and y = x after D blocks,
    where a = m = 1 (v_d), or with ``dpm_reads`` a = dpm[j, 0, b] and
    m = dpm[j, 1, b] for image b (v_g).  Returns y, or (y, xs, xs2) with
    ``outputs``.
    """
    if params is None and (outputs or body or any(t is not None for t in (rpb, mask, dpm))):
        raise ValueError("trunk_skeleton: without params only the body-less copy of x (v_e)")
    if dpm_reads and (not body or dpm is None):
        raise ValueError("trunk_skeleton: dpm_reads needs the body and dpm")
    if x.dim() != 4:
        raise ValueError(f"trunk_skeleton: x must be (B, H, W, C), got {tuple(x.shape)}")
    depth = 0 if params is None else params["ln1_s"].shape[0]
    if dpm is not None and dpm.shape != (depth, 2, x.shape[0]):
        raise ValueError(f"trunk_skeleton: dpm {tuple(dpm.shape)}, expected {(depth, 2, x.shape[0])}")
    if x.device.type == "cpu":
        y, xs, xs2 = _torch_trunk_skeleton(x, dpm, depth, outputs, body, dpm_reads)
        return (y, xs, xs2) if outputs else y

    leaves = [None] * len(PARAM_LEAVES) if params is None else [params[k] for k in PARAM_LEAVES]
    require_cuda("trunk_skeleton", x=(x, KERNEL_DTYPES), rpb=(rpb, F32), mask=(mask, F32),
                 dpm=(dpm, F32), **{k: (t, F32) for k, t in zip(PARAM_LEAVES, leaves)})
    if not x.is_contiguous() or (dpm is not None and not dpm.is_contiguous()):
        raise ValueError("trunk_skeleton: x and dpm must be contiguous")
    y = torch.empty_like(x)
    xs = xs2 = None
    if outputs:
        xs = torch.empty((depth, *x.shape), device=x.device, dtype=x.dtype)
        xs2 = torch.empty_like(xs)
    code = _build.library().lib.sei_trunk_skeleton(
        x.device.index, _is_bf16(x), x.data_ptr(), *map(_build.ptr, leaves), _build.ptr(rpb),
        _build.ptr(mask), _build.ptr(dpm), y.data_ptr(), _build.ptr(xs), _build.ptr(xs2),
        x.numel(), x.numel() // x.shape[0], depth, x.shape[0], int(body), int(dpm_reads),
        _build.stream_of(x))
    _build.check(code, "trunk_skeleton")
    trunk_skeleton.launches += 1
    return (y, xs, xs2) if outputs else y


trunk_skeleton.launches = 0

KERNELS = (copy_probe, trunk_skeleton)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["KERNELS", "copy_probe", "launch_counts", "reset_launch_counts", "trunk_skeleton"]
