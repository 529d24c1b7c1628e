"""sei_tpu_torch: the PyTorch/CUDA port of sei_tpu for NVIDIA Hopper (H100).

Scale-Equivariant Imaging restoration: SwinIR inference under the reference
evaluation protocol (seeded degradation, reflect-pad to a 64 bucket, 8-bit
quantize and clamp, Y-channel PSNR/SSIM).  The JAX package ``sei_tpu`` stays
beside this one as the reference; this package imports ``torch`` only.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` explicitly to run the plain PyTorch versions of the
kernels (the CPU golden tests do).

    from sei_tpu_torch.models import get_model
    from sei_tpu_torch.physics import get_physics
    from sei_tpu_torch.evaluate import evaluate
"""

from .device import resolve_device

__all__ = ["resolve_device"]
