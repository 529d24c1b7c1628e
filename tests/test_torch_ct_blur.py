"""The CT-like filter, the spatial blur and their physics against the JAX
package's (CPU).

* ``ct_like_filter`` in both directions on odd and even sizes, and the
  ``invert_a_tomography_like_filter`` physics' ``A``, ``A_adjoint`` and
  ``A_dagger``: 1e-5 relative to the largest value.
* The spatial blur (``physics/conv.py``) against ``sei_tpu.physics.conv``:
  forward and adjoint in all four paddings, for 1-wide, even and odd
  kernels, to 1e-5; the adjoint identity <A x, y> = <x, A^T y> to 1e-5
  relative; circular padding against the FFT blur ``blur_circular``, 1e-5.
* The ``physics_v2=False`` deblurring physics against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.fft_conv import blur_circular as jax_blur_circular
from sei_tpu.ops.fft_conv import ct_like_filter as jax_ct_like_filter
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu.physics.conv import blur_spatial as jax_blur_spatial
from sei_tpu.physics.conv import blur_spatial_adjoint as jax_blur_spatial_adjoint
from sei_tpu_torch.ops.fft_conv import blur_circular, ct_like_filter
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.physics.conv import PADDINGS, blur_spatial, blur_spatial_adjoint

RTOL = 1e-5
SHAPES = [(2, 3, 16, 16), (1, 3, 15, 21), (2, 1, 17, 12)]
KERNELS = {"odd 5x5": (5, 5), "even 4x6": (4, 6), "1-wide 1x5": (1, 5), "1-wide 7x1": (7, 1),
           "1x1": (1, 1), "odd-even 3x4": (3, 4)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("inverse", [True, False])
def test_ct_like_filter_matches_jax(shape, inverse):
    x = _rand(shape, 0)
    want = jax_ct_like_filter(jnp.asarray(x), inverse=inverse)
    _close(ct_like_filter(torch.from_numpy(x), inverse=inverse).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_ct_physics_matches_jax(shape):
    jp = jax_get_physics(task="invert_a_tomography_like_filter", noise_level=5)
    tp = get_physics(task="invert_a_tomography_like_filter", noise_level=5, device="cpu")
    x = _rand(shape, 1)
    for op in ("A", "A_adjoint", "A_dagger"):
        _close(getattr(tp, op)(torch.from_numpy(x)).numpy(), getattr(jp, op)(jnp.asarray(x)))
    # A_dagger inverts A exactly, up to f32 roundoff of the ramp's dynamic range
    y = tp.A(torch.from_numpy(x))
    _close(tp.A_dagger(y).numpy(), x, rtol=1e-3)
    assert tp.kernel is None and tp.sigma == pytest.approx(5 / 255)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("kname", list(KERNELS))
def test_blur_spatial_matches_jax(padding, kname):
    k = np.abs(_rand(KERNELS[kname], 2))
    k /= k.sum()
    x = _rand((2, 3, 14, 17), 3)
    want = jax_blur_spatial(jnp.asarray(x), jnp.asarray(k), padding=padding)
    got = blur_spatial(torch.from_numpy(x), torch.from_numpy(k), padding=padding)
    _close(got.numpy(), want)
    y = _rand(tuple(got.shape), 4)
    want_t = jax_blur_spatial_adjoint(jnp.asarray(y), jnp.asarray(k), padding=padding)
    got_t = blur_spatial_adjoint(torch.from_numpy(y), torch.from_numpy(k), padding=padding)
    _close(got_t.numpy(), want_t)
    # <A x, y> = <x, A^T y> in f64 sums of the f32 results
    lhs = float((got.double() * torch.from_numpy(y).double()).sum())
    rhs = float((torch.from_numpy(x).double() * got_t.double()).sum())
    assert abs(lhs - rhs) <= RTOL * max(abs(lhs), abs(rhs)), (lhs, rhs)


@pytest.mark.parametrize("kname", ["odd 5x5", "odd-even 3x4"])
def test_circular_spatial_blur_is_the_fft_blur(kname):
    # the extended kernel's centre, index k // 2, is where the FFT blur rolls
    # the PSF's origin to (an even axis gets its zero at the end)
    k = np.abs(_rand(KERNELS[kname], 5))
    k /= k.sum()
    x = _rand((2, 3, 16, 20), 6)
    want = jax_blur_circular(jnp.asarray(x), jnp.asarray(k))
    got = blur_spatial(torch.from_numpy(x), torch.from_numpy(k), padding="circular")
    _close(got.numpy(), want)
    _close(blur_circular(torch.from_numpy(x), torch.from_numpy(k)).numpy(), want)


def test_spatial_blur_physics_matches_jax():
    jp = jax_get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, physics_v2=False)
    tp = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, physics_v2=False,
                     device="cpu")
    fft = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    assert not tp.v2 and fft.v2
    x = _rand((2, 3, 24, 20), 7)
    for op in ("A", "A_adjoint"):
        _close(getattr(tp, op)(torch.from_numpy(x)).numpy(), getattr(jp, op)(jnp.asarray(x)))
    # the same circular operator as the FFT blur, and the same pseudo-inverse
    # (the spectral inverse filter, as in the JAX package)
    _close(tp.A(torch.from_numpy(x)).numpy(), fft.A(torch.from_numpy(x)).numpy())
    _close(tp.A_adjoint(torch.from_numpy(x)).numpy(), fft.A_adjoint(torch.from_numpy(x)).numpy())
    assert torch.equal(tp.A_dagger(torch.from_numpy(x)), fft.A_dagger(torch.from_numpy(x)))


def test_unknown_padding_raises():
    with pytest.raises(ValueError, match="padding"):
        blur_spatial(torch.zeros(1, 1, 4, 4), torch.ones(3, 3), padding="zeros")
