"""Port SwinIR vs the flax SwinIR with weights carried across (CPU).

A small SwinIR (embed 16, depths (2, 2), heads (2, 2), window 4): flax init
params, perturbed so no leaf is trivially zero or one, go through the port's
``jax_params_to_state_dict`` into ``load_state_dict``; the forward on an
input whose size is not a multiple of the window (reflect pad) must match
flax with the fused trunk on and off.  Tolerance rtol = atol = 1e-4 (f32,
36 matmul/softmax/LN stages summed in different orders by XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models import swinir as jswinir
from sei_tpu.models.torch_io import flax_swinir_to_torch
from sei_tpu_torch.models import get_model, jax_params_to_state_dict, swinir_config
from sei_tpu_torch.models import swinir as tswinir

CFG = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)
TOL = 1e-4


@pytest.fixture(scope="module")
def flax_case():
    module = jswinir.SwinIR(mlp_ratio=2.0, drop_path_rate=0.0, upsampler=None, **CFG)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        params)
    x = np.random.default_rng(1).random((2, 3, 13, 18)).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    return params, x, want


def _port_module(params, fused):
    m = tswinir.SwinIR(fused_trunk=fused, **swinir_config(task="deblurring", overrides=CFG))
    m.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return m.eval()


@pytest.mark.parametrize("fused", [True, False], ids=["fused_trunk", "unfused"])
def test_forward_matches_flax(flax_case, fused):
    params, x, want = flax_case
    with torch.no_grad():
        got = _port_module(params, fused)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_trunk", "unfused"])
def test_plain_path_matches_flax(flax_case, fused):
    params, x, want = flax_case
    with torch.no_grad():
        got = _port_module(params, fused)(torch.from_numpy(x), plain=True).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_reference_state_dict_names_load(flax_case):
    """The JAX package's own flax -> torch converter emits exactly the port's
    state_dict (names and values), which loads strictly."""
    params, _, _ = flax_case
    ref = flax_swinir_to_torch(params)
    ours = jax_params_to_state_dict(params)
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    m = tswinir.SwinIR(**swinir_config(task="deblurring", overrides=CFG))
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()},
                      strict=True)


def test_model_load_weights_forms(flax_case):
    """Model.load_weights takes a JAX tree, a torch state_dict with the
    reference's recomputed buffers, and a full training checkpoint."""
    params, x, want = flax_case
    model = get_model(device="cpu", swinir_overrides=CFG)
    sd = {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}
    sd["layers.0.residual_group.blocks.1.attn_mask"] = np.zeros((4, 16, 16), np.float32)
    for weights in (params, sd, {"params": params, "epoch": 3}):
        model.load_weights(weights)
        np.testing.assert_allclose(model(x).numpy(), want, rtol=TOL, atol=TOL)


def test_layout_constants_match_jax():
    for ws in (4, 8):
        np.testing.assert_array_equal(tswinir.relative_position_index(ws),
                                      jswinir.relative_position_index(ws))
    np.testing.assert_array_equal(tswinir.shift_attn_mask(16, 24, 8, 4),
                                  jswinir.shift_attn_mask(16, 24, 8, 4))
    x = np.random.default_rng(2).standard_normal((2, 8, 12, 5)).astype(np.float32)
    win = tswinir.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jswinir.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tswinir.window_reverse(win, 4, 8, 12).numpy(), x)


@pytest.mark.parametrize("h,w,ph,pw", [(13, 18, 3, 2), (37, 45, 27, 19), (50, 29, 14, 35), (1, 5, 3, 9)])
def test_reflect_pad_matches_numpy(h, w, ph, pw):
    x = np.random.default_rng(3).random((2, 3, h, w)).astype(np.float32)
    got = tswinir.reflect_pad(torch.from_numpy(x), ph, pw).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="reflect"))


def test_seeded_init_is_deterministic_and_matches_jax_scales():
    a = get_model(device="cpu", seed=3, swinir_overrides=CFG).module.state_dict()
    b = get_model(device="cpu", seed=3, swinir_overrides=CFG).module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["layers.0.residual_group.blocks.0.attn.qkv.weight"]
    assert float(w.abs().max()) <= 0.04 + 1e-7  # trunc-normal(0.02) cut at 2 std


def test_sr_head_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(task="sr", sr_factor=2, device="cpu", swinir_overrides=CFG)
