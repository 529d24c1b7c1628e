"""Port Swin-trunk gradients vs the JAX package's Pallas trunk (CPU).

``jax.grad`` through ``sei_tpu.ops.swin_trunk.swin_trunk(use_pallas=True,
interpret=True)`` runs the trunk forward in mode ``xs`` (K4) and the
recompute backward ``_bwd_kernel`` (K6) in interpret mode.  The port's
``_TrunkFn`` (through ``swin_trunk`` with tensors that require grad) runs
its forward chain, keeps each block's x and x2, and walks the blocks back
through the same row maps, strided attention views and per-image drop-path
indexing the CUDA kernels use (on CPU every wrapper takes its plain
version); ``trunk_reference`` is differentiated by torch autograd.  dx, the
12 stacked ``PARAM_LEAVES`` grads and drpb are compared.  Sizes are those of
tests/test_swin_trunk.py (D 2, 8x8, C 16, 2 heads, window 4), one image
where two add nothing (interpret mode is slow).  Tolerance rtol 5e-4 /
atol 5e-5, as tests/test_swin_trunk.py's kernel-grad test: f32 sums in
other orders through two blocks forward and back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models.swinir import shift_attn_mask
from sei_tpu.ops.swin_trunk import swin_trunk as jax_swin_trunk
from sei_tpu_torch.ops import swin_trunk as st
from tests.test_torch_swin_trunk import _stacked_params

D, NH, WS = 2, 2, 4
N = WS * WS
RTOL, ATOL = 5e-4, 5e-5

CASES = {
    # name: (images, H, W, dpm (D, 2, images))
    "one_image_shift": (1, 8, 8, np.ones((D, 2, 1), np.float32)),
    "two_images_dpm": (2, 8, 8, np.array([[[1.25, 0.0], [0.8, 1.25]],
                                          [[0.0, 1.25], [1.25, 0.8]]], np.float32)),
    "no_shift_small_image": (1, WS, WS, np.ones((D, 2, 1), np.float32)),
}


def _case(name):
    b, h, w, dpm = CASES[name]
    params, rpb = _stacked_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, h, w, params["ln1_s"].shape[1])).astype(np.float32)
    tgt = rng.standard_normal(x.shape).astype(np.float32)
    mask = shift_attn_mask(h, w, WS, WS // 2) if min(h, w) > WS else None
    return x, tgt, params, rpb, mask, dpm


@pytest.fixture(scope="module")
def jax_grads():
    cache = {}

    def get(name):
        if name not in cache:
            x, tgt, params, rpb, mask, dpm = _case(name)

            def loss(x, params, rpb):
                y = jax_swin_trunk(x, params, rpb, mask, jnp.asarray(dpm), num_heads=NH,
                                   window_size=WS, use_pallas=True, interpret=True)
                return jnp.sum(y * tgt)

            gx, gp, gr = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(rpb))
            cache[name] = (np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()},
                           np.asarray(gr))
        return cache[name]

    return get


def _port_grads(fn, name):
    x, tgt, params, rpb, mask, dpm = _case(name)
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    xt, rt = t(x), t(rpb)
    pt = {k: t(v) for k, v in params.items()}
    y = fn(xt, pt, rt, None if mask is None else torch.from_numpy(mask),
           torch.from_numpy(dpm), num_heads=NH, window_size=WS)
    (y * torch.from_numpy(tgt)).sum().backward()
    return xt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()}, rt.grad.numpy()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", [st.swin_trunk, st.trunk_reference],
                         ids=["trunk_fn_kernel_chain", "trunk_reference_autograd"])
def test_trunk_grads_match_jax_kernel(jax_grads, case, fn):
    gx, gp, gr = _port_grads(fn, case)
    jx, jp, jr = jax_grads(case)
    np.testing.assert_allclose(gx, jx, rtol=RTOL, atol=ATOL, err_msg="dx")
    assert set(gp) == set(st.PARAM_LEAVES)
    for k in st.PARAM_LEAVES:
        np.testing.assert_allclose(gp[k], jp[k], rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(gr, jr, rtol=RTOL, atol=ATOL, err_msg="drpb")


def test_trunk_fn_matches_reference_autograd():
    """The kernel chain's backward and autograd through the plain trunk
    agree far inside the JAX tolerance (same f32 arithmetic, other order)."""
    a = _port_grads(st.swin_trunk, "two_images_dpm")
    b = _port_grads(st.trunk_reference, "two_images_dpm")
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
    for k in st.PARAM_LEAVES:
        np.testing.assert_allclose(a[1][k], b[1][k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-6)


def test_trunk_fn_only_when_a_gradient_is_needed():
    """Under no_grad the trunk runs only the forward chain (no saves, no
    graph); with grad it goes through _TrunkFn."""
    x, _, params, rpb, mask, dpm = _case("one_image_shift")
    args = (torch.from_numpy(x), {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()},
            torch.from_numpy(rpb), torch.from_numpy(mask), torch.from_numpy(dpm))
    with torch.no_grad():
        assert st.swin_trunk(*args, num_heads=NH, window_size=WS).grad_fn is None
    y = st.swin_trunk(*args, num_heads=NH, window_size=WS)
    assert type(y.grad_fn).__name__ == "_TrunkFnBackward"
