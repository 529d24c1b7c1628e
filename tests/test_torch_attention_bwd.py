"""Port window-attention gradients vs the JAX package's Pallas backward (CPU).

The same numpy q (pre-scaled), k, v, bias, mask and output cotangent go
through ``jax.grad`` of ``sei_tpu.ops.attention.window_attention`` with
``use_pallas=True, interpret=True`` (``_bwd_kernel``, K2, in interpret mode)
and through the port: the ``torch.autograd.Function`` behind
``window_attention`` (forward ``window_attn_fwd``, backward
``window_attn_bwd``; on CPU tensors both take their plain versions) and the
plain backward ``_torch_attention_bwd`` called directly.  Tolerance 1e-5
(rtol and atol): f32 throughout, sums in different orders, dbias summed
over 8 windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.attention import window_attention as jax_window_attention
from sei_tpu_torch.ops import attention as at

B_, NH, N, HD, NW = 8, 2, 16, 8, 4
TOL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B_, NH, N, HD) * HD ** -0.5, f(B_, NH, N, HD), f(B_, NH, N, HD), f(B_, NH, N, HD)
    bias = 0.1 * f(NH, N, N)
    mask = np.where(rng.random((NW, N, N)) > 0.8, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask, do


@pytest.fixture(scope="module")
def jax_grads(inputs):
    q, k, v, bias, mask, do = inputs
    out = {}
    for masked in (False, True):
        m = mask if masked else None

        def f(q, k, v, b, m=m):
            o = jax_window_attention(q, k, v, b, m, use_pallas=True, interpret=True)
            return jnp.sum(o * do)

        g = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
        out[masked] = [np.asarray(t) for t in g]
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("path", ["autograd_function", "plain_backward"])
def test_grads_match_jax_kernel(inputs, jax_grads, masked, path):
    q, k, v, bias, mask, do = (torch.from_numpy(t) for t in inputs)
    m = mask if masked else None
    if path == "autograd_function":
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        (at.window_attention(*leaves, m) * do).sum().backward()
        got = [t.grad for t in leaves]
    else:
        got = at._torch_attention_bwd(q, k, v, bias, m, do)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, jax_grads[masked]):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=name)


def test_scale_folds_into_the_scores(inputs):
    """window_attention(q, ..., scale=s) == window_attention(s*q, ...), grads too."""
    q, k, v, bias, mask, do = (torch.from_numpy(t) for t in inputs)
    a = q.clone().requires_grad_()
    (at.window_attention(a, k, v, bias, mask, scale=0.5) * do).sum().backward()
    b = q.clone().requires_grad_()
    (at.window_attention(0.5 * b, k, v, bias, mask) * do).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=TOL, atol=TOL)


def test_cpu_backward_launches_nothing(inputs):
    q, k, v, bias, mask, do = (torch.from_numpy(t) for t in inputs)
    before = (at.window_attn_fwd.launches, at.window_attn_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    (at.window_attention(*leaves, mask) * do).sum().backward()
    assert (at.window_attn_fwd.launches, at.window_attn_bwd.launches) == before
    assert all(t.grad is not None for t in leaves)
