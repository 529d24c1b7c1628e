"""Forward operators with Gaussian noise (counterpart of
``sei_tpu/physics/__init__.py``).

Every task is ported: ``deblurring`` with the FFT circular blur
(``physics_v2=True``) or the spatial blur with circular padding
(``physics_v2=False``, :mod:`.conv`; its pseudo-inverse is the spectral
inverse filter in both cases, as in the JAX package); ``sr``, the
antialiased bicubic downsampling by ``1 / rate`` with its true adjoint (the
exact transpose of the resize) or the reference's deprecated one (a plain
bicubic upsample by ``rate``), and a CG pseudo-inverse; and
``invert_a_tomography_like_filter``, the separable ramp filter
(``ops.fft_conv.ct_like_filter``: A and its adjoint the smoothing
direction, A_dagger the sharpening one; no kernel).
Seeded degradation draws its noise from a ``torch.Generator`` seeded per
image on the tensor's device: the draw is deterministic for a seed, but does
not reproduce the JAX package's ``fold_in`` bits (the golden tests hand both
packages the same noise).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import blur_circular, blur_circular_adjoint, get_kernel, inverse_filter
from ..ops.fft_conv import ct_like_filter
from ..ops.resize import resize, resize_transpose
from ..parallel import draw_rows
from .conv import blur_spatial, blur_spatial_adjoint

TASKS = ("deblurring", "sr", "invert_a_tomography_like_filter")
CG_ITERS = 50  # the SR pseudo-inverse's conjugate-gradient steps


@dataclasses.dataclass(frozen=True)
class Physics:
    """A linear forward operator with Gaussian measurement noise.

    kernel: PSF tensor on the device (deblurring), else None; task:
    ``deblurring``, ``sr`` or ``invert_a_tomography_like_filter``; sigma:
    noise std in [0, 1] units (noise_level / 255); rate: the SR
    downsampling rate, else None; v2: deblurring by the FFT circular blur
    (True) or the spatial one (False); true_adjoint: SR's
    exact adjoint instead of the deprecated bicubic upsample; antialias: the
    SR resize's antialiasing; device: where the operator's tensors live.
    """

    kernel: Optional[torch.Tensor] = None
    task: str = "deblurring"
    sigma: float = 5.0 / 255.0
    rate: Optional[int] = None
    v2: bool = True
    true_adjoint: bool = False
    antialias: bool = True
    device: torch.device = torch.device("cpu")

    def A(self, x: torch.Tensor) -> torch.Tensor:
        if self.task == "deblurring":
            if self.v2:
                return blur_circular(x, self.kernel)
            return blur_spatial(x, self.kernel, padding="circular")
        if self.task == "sr":
            return resize(x, scale_factor=1.0 / self.rate, antialias=self.antialias)
        return ct_like_filter(x, inverse=True)

    def A_adjoint(self, y: torch.Tensor) -> torch.Tensor:
        if self.task == "deblurring":
            if self.v2:
                return blur_circular_adjoint(y, self.kernel)
            return blur_spatial_adjoint(y, self.kernel, padding="circular")
        if self.task != "sr":  # the ramp filter is diagonal in Fourier: self-adjoint
            return ct_like_filter(y, inverse=True)
        if self.true_adjoint:
            in_size = (y.shape[-2] * self.rate, y.shape[-1] * self.rate)
            return resize_transpose(y, in_size, scale_factor=1.0 / self.rate,
                                    antialias=self.antialias)
        # the reference's deprecated adjoint: a plain bicubic upsample
        return resize(y, scale_factor=float(self.rate), antialias=False)

    def A_dagger(self, y: torch.Tensor) -> torch.Tensor:
        """Least-squares pseudo-inverse: the inverse filter (deblurring, both
        blurs), the inverse ramp filter (CT-like), or ``A^T z`` with ``A A^T
        z = y`` solved by :data:`CG_ITERS` steps of conjugate gradients over
        the whole batch (SR)."""
        if self.task == "deblurring":
            return inverse_filter(y, self.kernel)
        if self.task != "sr":
            return ct_like_filter(y, inverse=False)
        z = torch.zeros_like(y)
        r = y
        p = r
        rs = torch.sum(r * r)
        for _ in range(CG_ITERS):
            ap = self.A(self.A_adjoint(p))
            alpha = rs / (torch.sum(p * ap) + 1e-12)
            z = z + alpha * p
            r = r - alpha * ap
            rs_new = torch.sum(r * r)
            p = r + (rs_new / (rs + 1e-12)) * p
            rs = rs_new
        return self.A_adjoint(z)

    def add_noise(self, y: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = draw_rows(lambda s: torch.randn(s, generator=generator, device=y.device,
                                                dtype=y.dtype), y.shape)
        return y + self.sigma * noise

    def degrade(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """y = A(x) + sigma * n."""
        return self.add_noise(self.A(x), generator)

    def randomly_degrade(self, x: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        """Seeded degradation: the same seed gives the same measurement on the
        same device; ``None`` draws from the global generator."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(int(seed))
        return self.degrade(x, gen)


def load_kernel_file(path: str) -> np.ndarray:
    """A PSF from a ``.npy`` file or a torch file holding a tensor or array
    (``sei_tpu/physics/__init__.py:177-184``)."""
    if path.endswith(".npy"):
        return np.load(path)
    t = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def get_physics(*, task: str, noise_level: float = 5.0,
                kernel: Union[str, np.ndarray, None] = None,
                sr_factor: Optional[int] = None, physics_v2: bool = True,
                physics_true_adjoint: bool = False, antialias: bool = True,
                device: DeviceLike = None) -> Physics:
    """Factory mirroring ``sei_tpu.physics.get_physics``.  Deblurring:
    ``kernel`` is a PSF name (``ops.kernels``), the path of a ``.npy`` or
    ``.pt`` PSF file, or an array; ``physics_v2`` picks the FFT blur (True)
    or the spatial one.  The CT-like task takes no kernel.  SR: ``sr_factor`` is the rate,
    ``physics_true_adjoint`` picks the exact adjoint, ``antialias`` shapes
    the resize.  Default device the GPU; raises without one unless
    ``device="cpu"``."""
    if task not in TASKS:
        raise ValueError(f"Unknown task: {task}")
    dev = resolve_device(device)
    common = dict(task=task, sigma=float(noise_level) / 255.0, v2=physics_v2, device=dev)
    if task == "invert_a_tomography_like_filter":
        return Physics(**common)
    if task == "sr":
        if sr_factor is None:
            raise ValueError("sr requires sr_factor")
        return Physics(rate=sr_factor, true_adjoint=physics_true_adjoint,
                       antialias=antialias, **common)
    if isinstance(kernel, str):
        k = load_kernel_file(kernel) if os.path.exists(kernel) else get_kernel(kernel)
    elif kernel is not None:
        k = np.asarray(kernel)
    else:
        raise ValueError("deblurring requires a kernel")
    return Physics(kernel=torch.as_tensor(k, dtype=torch.float32, device=dev), **common)
