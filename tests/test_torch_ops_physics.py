"""Port vs JAX package: PSF table, FFT blur operators and degradation (CPU).

Same numpy inputs through ``sei_tpu`` and ``sei_tpu_torch``.  Tolerances:
rtol 1e-5 with atol 1e-6 on [0, 1]-scale images (both packages run the FFTs
in complex64; the two FFT libraries round differently at f32 resolution);
the inverse filter amplifies roundoff by 1/min|OTF| (~140 for Gaussian_R1
on 20x24), so it is compared relative to its largest value at 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops import fft_conv as jfft
from sei_tpu.ops.kernels import get_kernel as jax_get_kernel, kernel_names
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.ops import fft_conv as tfft
from sei_tpu_torch.ops.kernels import get_kernel
from sei_tpu_torch.physics import get_physics

RTOL, ATOL = 1e-5, 1e-6


def _x(seed=0, shape=(2, 3, 20, 24)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("name", kernel_names())
def test_psf_table_matches(name):
    np.testing.assert_array_equal(get_kernel(name), jax_get_kernel(name))


@pytest.mark.parametrize("op", ["blur_circular", "blur_circular_adjoint"])
@pytest.mark.parametrize("kname", ["Gaussian_R2", "Box_R3"])
def test_blur_operators_match(op, kname):
    x = _x()
    k = get_kernel(kname).astype(np.float32)
    got = getattr(tfft, op)(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    want = np.asarray(getattr(jfft, op)(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_inverse_filter_matches():
    k = get_kernel("Gaussian_R1").astype(np.float32)
    y = np.array(jfft.blur_circular(jnp.asarray(_x(1)), jnp.asarray(k)))
    got = tfft.inverse_filter(torch.from_numpy(y), torch.from_numpy(k)).numpy()
    want = np.asarray(jfft.inverse_filter(jnp.asarray(y), jnp.asarray(k)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, _x(1), atol=1e-3)  # deconvolution recovers x


def test_physics_operators_match():
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    x = _x(2)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for name in ("A", "A_adjoint"):
        np.testing.assert_allclose(getattr(phys, name)(xt).numpy(),
                                   np.asarray(getattr(jphys, name)(xj)),
                                   rtol=RTOL, atol=ATOL)
    assert phys.sigma == jphys.sigma


def test_degrade_with_same_noise_matches():
    """degrade = A(x) + sigma * n: hand the port's noise draw to the JAX side."""
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    jphys = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5)
    x = torch.from_numpy(_x(3))
    y = phys.degrade(x, torch.Generator().manual_seed(7))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    want = np.asarray(jphys.A(jnp.asarray(x.numpy()))) + jphys.sigma * noise.numpy()
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)


def test_randomly_degrade_is_seeded():
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    x = torch.from_numpy(_x(4))
    a, b = phys.randomly_degrade(x, 3), phys.randomly_degrade(x, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, phys.randomly_degrade(x, 4))


def test_unported_tasks_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_physics(task="sr", sr_factor=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_physics(task="invert_a_tomography_like_filter", device="cpu")
