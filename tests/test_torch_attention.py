"""Port window attention vs the JAX package (CPU; mirrors test_attention.py).

The port's wrapper takes its plain PyTorch version for CPU tensors; the JAX
side runs the Pallas kernel in interpret mode and its XLA reference.
Tolerance 1e-5 absolute (f32 softmax of O(1) scores; both sides accumulate
in f32 in different orders).  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.attention import window_attention as jax_window_attention
from sei_tpu_torch.ops import attention as at

ATOL = 1e-5


def _inputs(b_=24, nh=6, n=64, hd=30, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b_, nh, n, hd)).astype(np.float32) * 0.18
    k = rng.standard_normal((b_, nh, n, hd)).astype(np.float32)
    v = rng.standard_normal((b_, nh, n, hd)).astype(np.float32)
    bias = rng.standard_normal((nh, n, n)).astype(np.float32) * 0.1
    mask = np.where(rng.random((12, n, n)) > 0.8, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _port(q, k, v, bias, mask):
    t = torch.from_numpy
    return at.window_attention(t(q), t(k), t(v), t(bias), mask).numpy()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_port_matches_jax(masked, use_pallas):
    q, k, v, bias, mask = _inputs()
    m = mask if masked else None
    want = jax_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), m, use_pallas=use_pallas,
                                interpret=use_pallas)
    np.testing.assert_allclose(_port(q, k, v, bias, m), np.asarray(want), atol=ATOL)


def test_port_handles_nondividing_batch():
    q, k, v, bias, _ = _inputs(b_=7)
    want = jax_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), None, use_pallas=True, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, bias, None), np.asarray(want), atol=ATOL)


def test_strided_views_and_out():
    """The trunk's calling convention: q/k/v as strided views of one qkv
    matrix, the output written into a (B_, N, nh, hd) buffer's view."""
    q, k, v, bias, mask = _inputs(b_=12, nh=2, n=16, hd=8, seed=3)
    b_, nh, n, hd = q.shape
    qkv = torch.from_numpy(np.stack([q, k, v], 2).transpose(0, 3, 2, 1, 4).copy())  # (B_, N, 3, nh, hd)
    out = torch.empty((b_, n, nh, hd))
    m = mask[:, :n, :n]
    res = at.window_attn_fwd(qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2),
                             qkv[:, :, 2].transpose(1, 2), torch.from_numpy(bias), m,
                             scale=2.0, out=out.transpose(1, 2))
    assert res.data_ptr() == out.data_ptr()
    want = jax_window_attention(jnp.asarray(q) * 2.0, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias), m, use_pallas=False)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(want), atol=ATOL)


def test_cpu_path_launches_nothing():
    q, k, v, bias, _ = _inputs(b_=2)
    before = at.window_attn_fwd.launches
    _port(q, k, v, bias, None)
    assert at.window_attn_fwd.launches == before

