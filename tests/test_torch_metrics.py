"""Port metrics vs ``sei_tpu.metrics`` (CPU).

Tolerances: 1e-5 dB on PSNR and 1e-6 on SSIM (both f32; the JAX SSIM filter
runs at HIGHEST precision, the port's in full f32), exact for the 8-bit
quantize-and-clamp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu import metrics as jm
from sei_tpu_torch import metrics as tm


def _pair(seed, shape=(3, 40, 52), noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    x_hat = np.clip(x + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, x_hat


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_match(seed):
    x, x_hat = _pair(seed)
    t, j = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(float(tm.psnr_y(t(x_hat), t(x))),
                               float(jm.psnr_y(j(x_hat), j(x))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tm.ssim_y(t(x_hat), t(x))),
                               float(jm.ssim_y(j(x_hat), j(x))), rtol=0, atol=1e-6)


def test_rgb_to_y_matches():
    x, _ = _pair(2)
    np.testing.assert_allclose(tm.rgb_to_y(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.rgb_to_y(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_quantize_and_clamp_exact():
    v = np.array([-0.2, 0.0, 0.5 / 255, 1.5 / 255, 0.49999, 0.5, 1.0, 1.3, 2.5 / 255],
                 np.float32)
    x = np.concatenate([v, np.random.default_rng(3).random(200).astype(np.float32) * 1.2 - 0.1])
    np.testing.assert_array_equal(tm.quantize_and_clamp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.quantize_and_clamp(jnp.asarray(x))))


def test_compute_metrics_registers_and_matches():
    """Different sizes are centre-cropped to the common size first."""
    x, _ = _pair(4, shape=(3, 44, 56))
    _, x_hat = _pair(5, shape=(3, 40, 52))
    got = tm.compute_metrics(torch.from_numpy(x), torch.from_numpy(x_hat))
    want = jm.compute_metrics(jnp.asarray(x), jnp.asarray(x_hat))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert np.isnan(got[2]) and np.isnan(want[2])
