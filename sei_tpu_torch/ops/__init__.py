"""Operators of the port.

Stock PyTorch (cuFFT, cuDNN) where the JAX package left the work to XLA
(``fft_conv``, ``conv``); hand-written CUDA kernels for Hopper where it wrote
Pallas kernels for the TPU (``attention``, ``swin_trunk``; sources under
``csrc/``, built by ``_build`` at first use).
"""

from .fft_conv import blur_circular, blur_circular_adjoint, inverse_filter, psf_to_otf
from .kernels import get_kernel, kernel_names

__all__ = [
    "blur_circular",
    "blur_circular_adjoint",
    "get_kernel",
    "inverse_filter",
    "kernel_names",
    "psf_to_otf",
]
