"""Device selection for the port's entry points.

``resolve_device(None)`` means the GPU.  There is no silent CPU detour: when
CUDA is asked for and absent, the call raises.  The evaluation is full f32
(the JAX reference runs it at HIGHEST precision), so TF32 is switched off for
both cuBLAS matmuls and cuDNN convolutions whenever a CUDA device is chosen.
"""

from __future__ import annotations

from typing import Optional, Union

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


def require_cuda_f32(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor is a float32 CUDA tensor on one device
    whose last dimension is unit-stride (what the kernels index)."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be unit-stride")
