"""The spatial blur (``--no-physics_v2``), counterpart of
``sei_tpu/physics/conv.py``.

A true convolution (the kernel flipped) of every channel by one 2-D kernel,
after circular, reflect or replicate padding, or with none (``valid``);
even-sized and 1-wide kernels are zero-extended to odd sizes first, as the
reference does.  The forward is a depthwise ``F.conv2d`` (cuDNN).  The JAX
package takes the exact adjoint by ``jax.linear_transpose``; here it is built
by hand: the depthwise ``F.conv_transpose2d`` of the same kernel, then the
padding folded back onto the image (the wrapped borders added for circular,
the mirrored rows and columns for reflect, the border sums onto the edge
for replicate).  The JAX package left all of this to XLA, so the port
leaves it to cuDNN: no hand-written kernel belongs here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PADDINGS = ("circular", "reflect", "replicate", "valid")


def extend_filter(k: torch.Tensor) -> torch.Tensor:
    """Zero-extend a (h, w) kernel to odd sizes: a 1-wide axis to 3 (the
    kernel in the middle), an even axis by one zero at its end."""
    h, w = k.shape
    h_new, w_new, oh, ow = h, w, 0, 0
    if w == 1:
        w_new, ow = 3, 1
    elif w % 2 == 0:
        w_new += 1
    if h == 1:
        h_new, oh = 3, 1
    elif h % 2 == 0:
        h_new += 1
    out = torch.zeros((h_new, w_new), dtype=k.dtype, device=k.device)
    out[oh:h + oh, ow:w + ow] = k
    return out


def _depthwise(kernel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The extended, flipped kernel as a (C, 1, kh, kw) depthwise weight."""
    k = extend_filter(kernel.to(like.dtype).reshape(kernel.shape[-2], kernel.shape[-1]))
    k = torch.flip(k, (0, 1))
    return k[None, None].expand(like.shape[1], 1, *k.shape).contiguous()


def _check(padding: str) -> None:
    if padding not in PADDINGS:
        raise ValueError(f"Unknown padding: {padding}")


def blur_spatial(x: torch.Tensor, kernel: torch.Tensor, *,
                 padding: str = "circular") -> torch.Tensor:
    """True convolution of x (B, C, H, W) by one 2-D kernel, every channel;
    the output is x's size, or smaller by the extended kernel's size - 1
    for ``valid``."""
    _check(padding)
    kd = _depthwise(kernel, x)
    if padding != "valid":
        ph, pw = (kd.shape[-2] - 1) // 2, (kd.shape[-1] - 1) // 2
        x = F.pad(x, (pw, pw, ph, ph), mode=padding)
    return F.conv2d(x, kd, groups=x.shape[1])


def _fold(p: torch.Tensor, dim: int, pad: int, padding: str) -> torch.Tensor:
    """Adjoint of padding ``dim`` by ``pad`` on both sides: the padded
    tensor's borders added back onto the pixels they were copied from."""
    if pad == 0:
        return p
    n = p.shape[dim] - 2 * pad
    lo, core, hi = p.narrow(dim, 0, pad), p.narrow(dim, pad, n), p.narrow(dim, pad + n, pad)
    out = core.clone()
    if padding == "circular":  # lo holds rows n-pad..n-1, hi rows 0..pad-1
        out.narrow(dim, n - pad, pad).add_(lo)
        out.narrow(dim, 0, pad).add_(hi)
    elif padding == "reflect":  # lo holds rows pad..1, hi rows n-2..n-1-pad
        out.narrow(dim, 1, pad).add_(torch.flip(lo, (dim,)))
        out.narrow(dim, n - 1 - pad, pad).add_(torch.flip(hi, (dim,)))
    else:  # replicate: every border row is a copy of the edge row
        out.narrow(dim, 0, 1).add_(lo.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(hi.sum(dim, keepdim=True))
    return out


def blur_spatial_adjoint(y: torch.Tensor, kernel: torch.Tensor, *,
                         padding: str = "circular") -> torch.Tensor:
    """Exact adjoint of :func:`blur_spatial`: ``<A x, y> = <x, A^T y>``."""
    _check(padding)
    kd = _depthwise(kernel, y)
    p = F.conv_transpose2d(y, kd, groups=y.shape[1])
    if padding == "valid":
        return p
    ph, pw = (kd.shape[-2] - 1) // 2, (kd.shape[-1] - 1) // 2
    return _fold(_fold(p, -1, pw, padding), -2, ph, padding)
