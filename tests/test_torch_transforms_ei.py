"""The EI-shift / EI-rotate transforms and the normal scaling kind against the
JAX package's (CPU).

* ``roll`` (the shift as a gather of device indices) equals the JAX
  package's ``shift`` for the same (sh, sw), exactly.
* ``rotate_image`` at 1, 45, 90, 180 and 359 degrees on odd and even sizes,
  nearest and bilinear: max |diff| 0, except at pixels the test names as
  rounding ties in one package only (a source coordinate within 1e-5 of
  a rounding boundary, where the cosine or sine of the two packages differ
  in their last bit), fewer than 0.1% of the pixels.
* ``normal_scaling_transform`` at 0.75 and 0.5, with and without
  antialiasing: 1e-5.
* The draws stay on the generator's device, and the registry and
  ``Combined`` apply each transform with its own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.scaling import normal_scaling_transform as jax_normal
from sei_tpu.transforms import rotate_image as jax_rotate_image
from sei_tpu.transforms import shift as jax_shift
from sei_tpu_torch.ops.scaling import normal_scaling_transform
from sei_tpu_torch.transforms import (Combined, Rotate, ScalingTransform, Shift,
                                      get_ei_transform, roll, rotate_coords, rotate_image,
                                      sample_rotate_angle, sample_shifts)

ANGLES = (1, 45, 90, 180, 359)
SIZES = ((16, 16), (15, 15), (12, 17))
TIE_EPS = 1e-5
MAX_TIE_SHARE = 1e-3


def _img(h, w, seed=0):
    return np.random.default_rng(seed).random((2, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("h,w", SIZES)
def test_shift_matches_jax(h, w):
    x = _img(h, w)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_shift(key, jnp.asarray(x)))
    kh, kw = jax.random.split(key)
    sh = int(jax.random.randint(kh, (), 0, h))
    sw = int(jax.random.randint(kw, (), 0, w))
    got = roll(torch.from_numpy(x), torch.tensor([sh, sw]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(Shift()(torch.from_numpy(x), shifts=torch.tensor([sh, sw])), got)


def _jax_coords(h, w, angle):
    """The JAX package's source coordinates (``rotate_image``'s sx, sy)."""
    dt = jnp.float32
    px = jnp.arange(w, dtype=dt) - (w * 0.5 - 0.5)
    py = jnp.arange(h, dtype=dt) - (h * 0.5 - 0.5)
    yy, xx = jnp.meshgrid(py, px, indexing="ij")
    rot = -jnp.asarray(angle, dt) * (jnp.pi / 180.0)
    ct, st = jnp.cos(rot), jnp.sin(rot)
    return (np.asarray(ct * xx + st * yy + (w * 0.5 - 0.5)),
            np.asarray(-st * xx + ct * yy + (h * 0.5 - 0.5)))


def _near_boundary(c, mode):
    """Whether coordinate c lies within TIE_EPS of where its rounding flips:
    c + 0.5 near an integer (nearest) or c near one (bilinear's floor)."""
    c = c + 0.5 if mode == "nearest" else c
    return np.abs(c - np.round(c)) <= TIE_EPS


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_image_matches_jax(angle, h, w, mode):
    x = _img(h, w, seed=angle)
    want = np.asarray(jax_rotate_image(jnp.asarray(x), jnp.asarray(float(angle)), mode=mode))
    got = rotate_image(torch.from_numpy(x), torch.tensor(float(angle)), mode=mode).numpy()
    differs = np.any(got != want, axis=(0, 1))
    if differs.any():
        jsx, jsy = _jax_coords(h, w, float(angle))
        tsx, tsy = (c.numpy() for c in rotate_coords(h, w, torch.tensor(float(angle))))
        ties = ((_near_boundary(jsx, mode) | _near_boundary(tsx, mode)) & (jsx != tsx)) | \
               ((_near_boundary(jsy, mode) | _near_boundary(tsy, mode)) & (jsy != tsy))
        named = np.argwhere(differs & ~ties)
        assert named.size == 0, f"pixels that differ off a rounding tie: {named.tolist()}"
        assert differs.mean() < MAX_TIE_SHARE, f"{differs.sum()} tie pixels of {differs.size}"


def test_rotate_draws_stay_on_the_device():
    g = torch.Generator().manual_seed(3)
    angles = [float(sample_rotate_angle(g)) for _ in range(200)]
    assert min(angles) >= 1 and max(angles) <= 359 and all(a == int(a) for a in angles)
    s = sample_shifts(torch.Generator().manual_seed(4), 5, 7)
    assert s.shape == (2,) and 0 <= int(s[0]) < 5 and 0 <= int(s[1]) < 7
    x = torch.from_numpy(_img(12, 12))
    a = Rotate()(x, torch.Generator().manual_seed(1))
    b = Rotate()(x, angle=sample_rotate_angle(torch.Generator().manual_seed(1)))
    assert torch.equal(a, b)


def test_combined_rotates_then_shifts():
    x = torch.from_numpy(_img(12, 14))
    angle, shifts = torch.tensor(30.0), torch.tensor([3, 5])
    t = get_ei_transform("Rotations+Shifts")
    assert isinstance(t, Combined)
    got = t(x, None, angle=angle, shifts=shifts, rates=None)
    assert torch.equal(got, roll(rotate_image(x, angle), shifts))
    assert isinstance(get_ei_transform("Rotations"), Rotate)
    assert isinstance(get_ei_transform("Shifts"), Shift)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert torch.equal(t(x, g1), Shift()(Rotate()(x, g2), g2))


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("rate", [0.75, 0.5])
def test_normal_scaling_matches_jax(rate, antialias):
    x = _img(48, 40, seed=2)
    want = np.asarray(jax_normal(jnp.asarray(x), rate, antialias=antialias))
    got = normal_scaling_transform(torch.from_numpy(x), rate, antialias=antialias).numpy()
    assert got.shape == want.shape == (2, 3, int(48 * rate), int(40 * rate))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    t = ScalingTransform(kind="normal", antialias=antialias)
    assert torch.equal(t.normal_static(rate, torch.from_numpy(x)), torch.from_numpy(got))
    with pytest.raises(ValueError, match="normal_static"):
        t(torch.from_numpy(x), torch.Generator())
    assert torch.equal(get_ei_transform("Scaling_Transforms", kind="normal", antialias=antialias,
                                        normal_rate=rate)(torch.from_numpy(x)),
                       torch.from_numpy(got))
