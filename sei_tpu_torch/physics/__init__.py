"""Forward operators with Gaussian noise (counterpart of
``sei_tpu/physics/__init__.py``).

This slice ports the main path's operator: ``deblurring`` with the FFT
circular blur (``physics_v2=True``).  Seeded degradation draws its noise
from a ``torch.Generator`` seeded per image on the tensor's device: the draw
is deterministic for a seed, but does not reproduce the JAX package's
``fold_in`` bits (the golden tests hand both packages the same noise).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import blur_circular, blur_circular_adjoint, get_kernel, inverse_filter

TASKS = ("deblurring", "sr", "invert_a_tomography_like_filter")


@dataclasses.dataclass(frozen=True)
class Physics:
    """A linear forward operator with Gaussian measurement noise.

    kernel: PSF tensor on the device; sigma: noise std in [0, 1] units
    (noise_level / 255).
    """

    kernel: torch.Tensor
    sigma: float = 5.0 / 255.0
    task = "deblurring"  # the only ported task (not a field)

    def A(self, x: torch.Tensor) -> torch.Tensor:
        return blur_circular(x, self.kernel)

    def A_adjoint(self, y: torch.Tensor) -> torch.Tensor:
        return blur_circular_adjoint(y, self.kernel)

    def A_dagger(self, y: torch.Tensor) -> torch.Tensor:
        return inverse_filter(y, self.kernel)

    def add_noise(self, y: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)
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


def get_physics(*, task: str, noise_level: float = 5.0,
                kernel: Union[str, np.ndarray, None] = None,
                sr_factor: Optional[int] = None, physics_v2: bool = True,
                device: DeviceLike = None) -> Physics:
    """Factory mirroring ``sei_tpu.physics.get_physics`` for deblurring;
    ``kernel`` is a PSF name (``ops.kernels``) or an array.  Default device
    the GPU; raises without one unless ``device="cpu"``."""
    if task not in TASKS:
        raise ValueError(f"Unknown task: {task}")
    if task != "deblurring":
        raise NotImplementedError(
            f"{task}: not ported yet (ROADMAP, Queue 1: SR and the CT-like filter)")
    if not physics_v2:
        raise NotImplementedError(
            "spatial circular blur (physics_v2=False): not ported yet (ROADMAP, Queue 1)")
    dev = resolve_device(device)
    if isinstance(kernel, str):
        k = get_kernel(kernel)
    elif kernel is not None:
        k = np.asarray(kernel)
    else:
        raise ValueError("deblurring requires a kernel")
    return Physics(kernel=torch.as_tensor(k, dtype=torch.float32, device=dev),
                   sigma=float(noise_level) / 255.0)
