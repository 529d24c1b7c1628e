"""Port Swin trunk vs the JAX package's fused trunk (CPU).

Same flax-initialised block weights (stacked in the trunk layout) and the
same numpy input go through ``sei_tpu.ops.swin_trunk.swin_trunk`` (the Pallas
kernel in interpret mode) and through the port's ``swin_trunk`` (its kernel
chain; on CPU every wrapper runs its plain version, so the chain's row maps,
strided attention views and drop-path indexing are what is checked here) and
``trunk_reference``.  Sizes are those of tests/test_swin_trunk.py.
Tolerance 2e-5 (rtol and atol), as the JAX trunk tests use: f32 throughout,
sums in different orders, and the JAX kernel's polynomial erf (|err| <=
1.5e-7) against the port's exact GELU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models.swinir import SwinBlock, relative_position_index, shift_attn_mask
from sei_tpu.ops.swin_trunk import PARAM_LEAVES as JAX_LEAVES
from sei_tpu.ops.swin_trunk import _window_tokens as jax_window_tokens
from sei_tpu.ops.swin_trunk import make_dims
from sei_tpu.ops.swin_trunk import swin_trunk as jax_swin_trunk
from sei_tpu_torch.ops import swin_trunk as st

D, B, H, W, C, NH, WS = 2, 2, 8, 8, 16, 2, 4
N = WS * WS
TOL = 2e-5


def _stacked_params(seed=0):
    """D flax SwinBlocks' params -> stacked trunk layout (numpy) + rpb."""
    key = jax.random.PRNGKey(seed)
    idx = relative_position_index(WS).reshape(-1)
    onehot = np.zeros((N * N, (2 * WS - 1) ** 2), np.float32)
    onehot[np.arange(N * N), idx] = 1.0
    rng = np.random.default_rng(seed)
    out = {k: [] for k in JAX_LEAVES}
    rpb = []
    for d in range(D):
        blk = SwinBlock(dim=C, num_heads=NH, window_size=WS,
                        shift_size=0 if d % 2 == 0 else WS // 2,
                        mlp_ratio=2.0, drop_path=0.0)
        key, k = jax.random.split(key)
        p = blk.init(k, jnp.zeros((B, H, W, C)), True)["params"]
        # perturb: init leaves zero biases / unit norms, too easy a test
        p = jax.tree_util.tree_map(
            lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), p)
        for leaf, path in (("ln1_s", ("norm1", "scale")), ("ln1_b", ("norm1", "bias")),
                           ("qkv_w", ("attn", "qkv", "kernel")), ("qkv_b", ("attn", "qkv", "bias")),
                           ("proj_w", ("attn", "proj", "kernel")), ("proj_b", ("attn", "proj", "bias")),
                           ("ln2_s", ("norm2", "scale")), ("ln2_b", ("norm2", "bias")),
                           ("fc1_w", ("mlp", "fc1", "kernel")), ("fc1_b", ("mlp", "fc1", "bias")),
                           ("fc2_w", ("mlp", "fc2", "kernel")), ("fc2_b", ("mlp", "fc2", "bias"))):
            node = p
            for name in path:
                node = node[name]
            out[leaf].append(np.asarray(node, np.float32))
        table = np.asarray(p["attn"]["relative_position_bias_table"], np.float32)
        rpb.append((onehot @ table).reshape(N, N, NH).transpose(2, 0, 1))
    return {k: np.stack(v) for k, v in out.items()}, np.stack(rpb)


def _run_jax(x, params, rpb, mask, dpm):
    return np.asarray(jax_swin_trunk(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(rpb), mask, jnp.asarray(dpm), num_heads=NH, window_size=WS,
        use_pallas=True, interpret=True))


def _run_port(fn, x, params, rpb, mask, dpm):
    t = torch.from_numpy
    return fn(t(x), {k: t(v) for k, v in params.items()}, t(rpb),
              None if mask is None else t(mask), t(dpm),
              num_heads=NH, window_size=WS).numpy()


@pytest.fixture(scope="module")
def case():
    params, rpb = _stacked_params()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    mask = shift_attn_mask(H, W, WS, WS // 2)
    dpm = np.ones((D, 2, B), np.float32)
    return x, params, rpb, mask, dpm


@pytest.fixture(scope="module")
def jax_out(case):
    return _run_jax(*case)


def test_param_leaves_match():
    assert st.PARAM_LEAVES == JAX_LEAVES


@pytest.mark.parametrize("fn", [st.swin_trunk, st.trunk_reference],
                         ids=["kernel_chain", "trunk_reference"])
def test_port_matches_jax_kernel(case, jax_out, fn):
    np.testing.assert_allclose(_run_port(fn, *case), jax_out, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fn", [st.swin_trunk, st.trunk_reference],
                         ids=["kernel_chain", "trunk_reference"])
def test_no_shift_small_image(case, fn):
    """min(H, W) <= ws: no block shifts, no mask."""
    _, params, rpb, _, dpm = case
    x = np.random.default_rng(3).standard_normal((B, WS, WS, C)).astype(np.float32)
    want = _run_jax(x, params, rpb, None, dpm)
    np.testing.assert_allclose(_run_port(fn, x, params, rpb, None, dpm), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fn", [st.swin_trunk, st.trunk_reference],
                         ids=["kernel_chain", "trunk_reference"])
def test_per_image_drop_path(case, fn):
    """dpm (D, 2, B) scales each image's attention and MLP branch on its own."""
    x, params, rpb, mask, _ = case
    dpm = np.array([[[1.25, 0.0], [0.0, 1.25]], [[1.25, 1.25], [1.25, 0.0]]], np.float32)
    want = _run_jax(x, params, rpb, mask, dpm)
    np.testing.assert_allclose(_run_port(fn, x, params, rpb, mask, dpm), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shift", [0, WS // 2])
def test_window_rows_match_jax_layout(shift):
    """The row map the kernels fold into their loads/stores is exactly the
    JAX package's roll + window partition."""
    hh, ww = 8, 12
    pix = np.arange(B * hh * ww, dtype=np.int32).reshape(B, hh, ww, 1)
    rolled = jnp.roll(jnp.asarray(pix), (-shift, -shift), axis=(1, 2))
    dims = make_dims((B, hh, ww, 1), {"ln1_s": np.zeros((2, 1)), "fc1_w": np.zeros((2, 1, 2))},
                     1, WS)
    want = np.asarray(jax_window_tokens(rolled, dims)).reshape(-1)
    got = st.window_rows(B, st.WindowMap(hh, ww, WS, shift), "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_chain_launches_nothing(case):
    st.reset_launch_counts()
    _run_port(st.swin_trunk, *case)
    assert st.launch_counts() == {"ln_rows": 0, "gemm_bias_epilogue": 0, "window_attn_fwd": 0}

