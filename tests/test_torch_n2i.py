"""Noise2Inverse and the ``--r2r`` eval average against the JAX package's
(CPU).

The same backbone in both packages (a tiny SwinIR, weights carried across
by ``models/torch_io``, padded to the 64 bucket as the eval pads), the same
measurement and the same perturbations:

* ``measurement_slices``: exactly the JAX package's row combs.
* ``noise2inverse_model`` for deblurring (the inverse filter backprojects)
  and the CT-like task (``A_dagger``): 1e-5 of the largest value.  The
  deblurring cases blur with a PSF whose spectrum stays above 0.2: under
  Gaussian_R2's the inverse filter of a comb of noise reaches ~1e6 and
  carries each FFT's f32 rounding with it, differently in each package.
* ``noise2inverse_train_pair`` for each subset: 1e-5; a drawn pick (a
  device tensor) selects the same pair as that index.
* ``--r2r``'s mean of N restorations of y + sigma / 2 * n (``demo/test.py:
  197-205``, its draws from ``PRNGKey(1)`` handed to the port): 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models import get_model as jax_get_model
from sei_tpu.noise2inverse import measurement_slices as jax_slices
from sei_tpu.noise2inverse import noise2inverse_model as jax_n2i_model
from sei_tpu.noise2inverse import noise2inverse_train_pair as jax_n2i_pair
from sei_tpu.physics import get_physics as jax_get_physics
from sei_tpu_torch.evaluate import eval_apply, r2r_average
from sei_tpu_torch.models import get_model
from sei_tpu_torch.noise2inverse import (measurement_slices, noise2inverse_model,
                                         noise2inverse_train_pair)
from sei_tpu_torch.physics import get_physics

OVERRIDES = dict(embed_dim=8, depths=(1,), num_heads=(2,), window_size=4, drop_path_rate=0.0)
TASKS = ("deblurring", "invert_a_tomography_like_filter")
BUCKET = 64


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-12)


# spectrum 0.6 + 0.2 (cos u + cos v), in [0.2, 1]
PSF = np.array([[0.0, 0.1, 0.0], [0.1, 0.6, 0.1], [0.0, 0.1, 0.0]], np.float32)


def _physics(task):
    kw = dict(kernel=PSF) if task == "deblurring" else {}
    return (jax_get_physics(task=task, noise_level=5, **kw),
            get_physics(task=task, noise_level=5, device="cpu", **kw))


@pytest.fixture(scope="module")
def backbones():
    """The tiny SwinIR as each package's eval runs it: reflect-padded to the
    64 bucket, cropped back."""
    jmodel = jax_get_model(kind="Proposed", task="deblurring", swinir_overrides=OVERRIDES)
    rng = np.random.default_rng(0)
    jmodel.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)),
        jmodel.params)
    model = get_model(device="cpu", swinir_overrides=OVERRIDES)
    model.load_weights(jax.tree_util.tree_map(np.asarray, jmodel.params))
    fwd = jax.jit(lambda y: jmodel.apply_fn(jmodel.params, y))

    def jax_apply(y):
        h, w = y.shape[-2:]
        y = jnp.pad(y, ((0, 0), (0, 0), (0, (-h) % BUCKET), (0, (-w) % BUCKET)), mode="reflect")
        return fwd(y)[..., :h, :w]

    return jax_apply, model


def _measurement(jphys, h=40, w=46, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((1, 3, h, w)).astype(np.float32)
    return (np.asarray(jphys.A(jnp.asarray(x)))
            + jphys.sigma * rng.standard_normal(x.shape).astype(np.float32)).astype(np.float32)


def test_measurement_slices_match_jax():
    y = np.random.default_rng(0).random((2, 3, 13, 8)).astype(np.float32)
    for s in (2, 4):
        got, want = measurement_slices(torch.from_numpy(y), s), jax_slices(jnp.asarray(y), s)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("task", TASKS)
def test_noise2inverse_model_matches_jax(backbones, task):
    jax_apply, model = backbones
    jphys, phys = _physics(task)
    y = _measurement(jphys)
    want = jax_n2i_model(jax_apply, task=task, kernel=jphys.kernel,
                         degradation_inverse_fn=jphys.A_dagger)(jnp.asarray(y))
    got = eval_apply(model, phys, pad_bucket=BUCKET, noise2inverse=True)(torch.from_numpy(y))
    _close(got.numpy(), want)
    direct = noise2inverse_model(lambda t: eval_apply(model, pad_bucket=BUCKET)(t), task=task,
                                 kernel=phys.kernel, degradation_inverse_fn=phys.A_dagger)
    assert torch.equal(direct(torch.from_numpy(y)), got)


@pytest.mark.parametrize("task", TASKS)
def test_noise2inverse_train_pair_matches_jax(task):
    jphys, phys = _physics(task)
    y = _measurement(jphys, 24, 20, seed=4)
    for pick in range(4):
        key = next(k for k in (jax.random.PRNGKey(i) for i in range(64))
                   if int(jax.random.randint(k, (), 0, 4)) == pick)
        want = jax_n2i_pair(key, jnp.asarray(y), task=task, kernel=jphys.kernel,
                            degradation_inverse_fn=jphys.A_dagger)
        kw = dict(task=task, kernel=phys.kernel, degradation_inverse_fn=phys.A_dagger)
        got = noise2inverse_train_pair(torch.from_numpy(y), pick=pick, **kw)
        drawn = noise2inverse_train_pair(torch.from_numpy(y), pick=torch.tensor(pick), **kw)
        for g, d, w in zip(got, drawn, want):
            _close(g.numpy(), w)
            assert torch.equal(g, d)
    g = torch.Generator().manual_seed(0)
    picks = {int(torch.randint(0, 4, (), generator=g)) for _ in range(40)}
    assert picks == {0, 1, 2, 3}


@pytest.mark.parametrize("noise2inverse", [False, True])
def test_r2r_average_matches_jax(backbones, noise2inverse):
    jax_apply, model = backbones
    jphys, phys = _physics("deblurring")
    y = _measurement(jphys)
    if noise2inverse:
        jax_apply = jax_n2i_model(jax_apply, task="deblurring", kernel=jphys.kernel,
                                  degradation_inverse_fn=jphys.A_dagger)
    n = 3
    key, acc, normals = jax.random.PRNGKey(1), None, []  # demo/test.py:195-205
    for _ in range(n):
        key, sub = jax.random.split(key)
        normals.append(jax.random.normal(sub, y.shape, jnp.float32))
        out = jax_apply(jnp.asarray(y) + 0.5 * (jphys.sigma * normals[-1]))
        acc = out if acc is None else acc + out
    want = acc / n
    apply = eval_apply(model, phys, pad_bucket=BUCKET, noise2inverse=noise2inverse)
    got = r2r_average(apply, torch.from_numpy(y), sigma=phys.sigma, itercount=n,
                      normals=[torch.from_numpy(np.array(v)) for v in normals])
    _close(got.numpy(), want)
    # drawn from a generator: the mean of restorations around y
    gen = r2r_average(apply, torch.from_numpy(y), sigma=phys.sigma, itercount=n,
                      generator=torch.Generator().manual_seed(1))
    assert gen.shape == got.shape and not torch.equal(gen, got)
