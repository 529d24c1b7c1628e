"""Device selection for the port's entry points.

``resolve_device(None)`` means the GPU.  There is no silent CPU detour: when
CUDA is asked for and absent, the call raises.  The evaluation is full f32
(the JAX reference runs it at HIGHEST precision), so TF32 is switched off for
both cuBLAS matmuls and cuDNN convolutions whenever a CUDA device is chosen.
:func:`require_cuda` is the kernel wrappers' check of what they launch on.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch device to run on; ``None`` -> ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is requested and none is
    available.  Choosing CUDA also pins f32 matmuls and convolutions to full
    f32 (no TF32).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sei_tpu_torch: CUDA device requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"sei_tpu_torch: unsupported device {dev}")
    return dev


DtypeSpec = Union[torch.dtype, Tuple[torch.dtype, ...]]

# the storage types the kernels are instantiated for
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def require_cuda(name: str, **args: Tuple[Optional[torch.Tensor], DtypeSpec]) -> None:
    """Raise unless every given tensor (``arg=(tensor, dtype or dtypes)``;
    ``None`` tensors are skipped) is a CUDA tensor of an allowed dtype, all
    on one device, with a unit-stride last dimension (what the kernels
    index).  A tensor of another dtype raises: the kernels cast nothing."""
    dev = None
    for arg, (t, allowed) in args.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        allowed = allowed if isinstance(allowed, tuple) else (allowed,)
        if t.dtype not in allowed:
            raise ValueError(f"{name}: {arg} must be {' or '.join(map(str, allowed))}, "
                             f"got {t.dtype}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dimension must be unit-stride")
