"""Analytic blur PSFs: the port's own copy of the PSF table
(``sei_tpu/ops/kernels.py``, itself parity with the reference's
``src/physics/kernels.py``).

Gaussian_R{1,2,3}: size 6*sigma+1, normalized isotropic Gaussian (float64
math).  Box_R{2,3,4}: size 2r+1 mean filter.
"""

from __future__ import annotations

import numpy as np

_TABLE = {
    "Gaussian_R1": ("gaussian", 1),
    "Gaussian_R2": ("gaussian", 2),
    "Gaussian_R3": ("gaussian", 3),
    "Box_R2": ("box", 2),
    "Box_R3": ("box", 3),
    "Box_R4": ("box", 4),
}


def kernel_names() -> list[str]:
    return list(_TABLE)


def get_kernel(name: str, dtype=np.float64) -> np.ndarray:
    if name not in _TABLE:
        raise ValueError(f"Unsupported kernel: {name}")
    blur_type, blur_level = _TABLE[name]
    if blur_type == "gaussian":
        kernel_size = blur_level * 6 + 1
        u = np.arange(kernel_size, dtype=np.float64)
        u = u - (kernel_size - 1) / 2
        U, V = np.meshgrid(u, u, indexing="ij")
        kernel = np.exp(-(U**2 + V**2) / (2 * blur_level**2))
        kernel = kernel / kernel.sum()
    else:
        kernel_size = blur_level * 2 + 1
        kernel = np.ones((kernel_size, kernel_size), dtype=np.float64)
        kernel = kernel / kernel.sum()
    return kernel.astype(dtype)
