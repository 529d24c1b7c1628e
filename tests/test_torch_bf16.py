"""The port's bf16 training recipe and the trunk's save modes vs the JAX
package (CPU).

* (a) The polynomial GELU pair (``_gelu_fast``, ``_gelu_pair_fast``) against
  the JAX trunk's, on a grid through and past its +-4 saturation, to 1e-6:
  the same f32 Horner chains, with or without fused multiply-adds.
* (b) The algorithm in f32: the port's ``swin_trunk(..., saves=True)`` (the
  save-carrying forward K5 and saved-tensor backward K7, on the CPU through
  the kernels' plain versions) against the JAX ``swin_trunk(use_pallas=True,
  interpret=True)`` with ``SEI_TRUNK_SAVES=1`` (K5/K7 in interpret mode):
  output and the grads of x, the 12 stacked params and rpb, at
  ``test_torch_trunk_grad.py``'s tolerances (rtol 5e-4, atol 5e-5).
* (c) The bf16 trunk (saves on by default) against the JAX bf16 K5/K7 in
  interpret mode.  The two round at the same points, so they agree far
  inside the JAX trunk test's own bounds for its bf16 kernel (outputs 5e-2,
  grads 3e-2 of each tensor's largest entry): outputs to 2e-2 (a few bf16
  ulps, should an f32 sum in another order flip a rounding), grads to 1e-2
  of the max.  Autograd through the port's bf16 ``trunk_reference`` (which
  rounds its forward where the JAX trunk does, its backward where autograd
  casts) against the same grads to 3e-2 of the max, and the no-grad bf16
  forward against the save-carrying forward to 1e-2 (they are equal).
* (d) ``SwinIR(dtype=bfloat16)`` against the flax ``SwinIR(dtype=bfloat16,
  fused_trunk=True)`` under ``SEI_TRUNK_INTERPRET=1``, same weights, on an
  MSE loss: output to 5e-2 (the JAX bf16 bound; bf16 convolutions of XLA
  and of PyTorch sum in other orders, so roundings of conv outputs flip),
  loss to rtol 1e-2, gradients to 3e-2 of each tensor's max; the biases of
  the convolutions to 1e-1: XLA on the CPU sums a bf16 bias's gradient in
  bf16 (2.3% error on a 512-term sum, where PyTorch's f32 sum is exact to
  the final rounding), so there the reference itself is off by a few %.
* (e) A ``Trainer`` takes two steps with a tiny bf16 SwinIR on the CPU: the
  loss is finite, every weight moves, and params and Adam's state stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models import swinir as jswinir
from sei_tpu.models.swinir import shift_attn_mask
from sei_tpu.ops import swin_trunk as jst
from sei_tpu_torch.data import build_device_cache
from sei_tpu_torch.losses import get_loss
from sei_tpu_torch.models import get_model, jax_params_to_state_dict, swinir_config
from sei_tpu_torch.models import swinir as tswinir
from sei_tpu_torch.ops import swin_trunk as st
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer
from tests.test_torch_swin_trunk import _stacked_params

D, NH, WS = 2, 2, 4
BF16 = torch.bfloat16


# -- (a) --------------------------------------------------------------------


def test_gelu_fast_pair_matches_jax():
    x = np.concatenate([np.linspace(-9.0, 9.0, 7201), [-4.0, 4.0, -4.0001, 4.0001, 0.0]])
    x = x.astype(np.float32)
    want_g = np.asarray(jst._gelu_fast(jnp.asarray(x)))
    want_pg, want_pd = (np.asarray(t) for t in jst._gelu_pair_fast(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(st._gelu_fast(xt).numpy(), want_g, rtol=0, atol=1e-6)
    g, d = st._gelu_pair_fast(xt)
    np.testing.assert_allclose(g.numpy(), want_pg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), want_pd, rtol=0, atol=1e-6)
    # the saturated tails are exact: gelu = x (x > 4) or 0 (x < -4), gelu' = 1 or 0
    assert np.array_equal(g.numpy()[x > 4], x[x > 4]) and not g.numpy()[x < -4].any()
    assert np.array_equal(d.numpy()[np.abs(x) > 4], (x[np.abs(x) > 4] > 0).astype(np.float32))


# -- (b), (c): the trunk ----------------------------------------------------

CASES = {
    # name: (images, H, W, dpm (D, 2, images))
    "one_image_shift": (1, 8, 8, np.ones((D, 2, 1), np.float32)),
    "two_images_dpm": (2, 8, 8, np.array([[[1.25, 0.0], [0.8, 1.25]],
                                          [[0.0, 1.25], [1.25, 0.8]]], np.float32)),
}


def _case(name):
    b, h, w, dpm = CASES[name]
    params, rpb = _stacked_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, h, w, params["ln1_s"].shape[1])).astype(np.float32)
    tgt = rng.standard_normal(x.shape).astype(np.float32)
    mask = shift_attn_mask(h, w, WS, WS // 2)
    return x, tgt, params, rpb, mask, dpm


def _jax_trunk(x, params, rpb, mask, dpm, tgt, dtype):
    """JAX K5/K7 in interpret mode: (y, dx, dparams, drpb) as f32 numpy."""

    def loss(x, params, rpb):
        y = jst.swin_trunk(x, params, rpb, mask, jnp.asarray(dpm), num_heads=NH,
                           window_size=WS, use_pallas=True, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * tgt), y

    (_, y), (gx, gp, gr) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x).astype(dtype), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(rpb))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(y), f(gx), {k: f(v) for k, v in gp.items()}, f(gr)


def _port_trunk(fn, x, params, rpb, mask, dpm, tgt, dtype, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    rt = torch.from_numpy(rpb).requires_grad_()
    y = fn(xt, pt, rt, torch.from_numpy(mask), torch.from_numpy(dpm), num_heads=NH,
           window_size=WS, **kw)
    assert y.dtype == dtype
    (y.float() * torch.from_numpy(tgt)).sum().backward()
    assert xt.grad.dtype == dtype and all(v.grad.dtype == torch.float32 for v in pt.values())
    f = lambda a: a.detach().float().numpy()  # noqa: E731
    return f(y), f(xt.grad), {k: f(v.grad) for k, v in pt.items()}, f(rt.grad)


def _count_calls(monkeypatch):
    """Count the trunk's calls of the forward GEMM and attention wrappers
    (CPU tensors launch nothing, so the launch counters stay 0)."""
    calls = {"gemm_bias_epilogue": 0, "window_attn_fwd": 0}
    for name in calls:
        real = getattr(st, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(st, name, spy)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_f32_saves_mode_matches_jax_k5_k7(case, monkeypatch):
    x, tgt, params, rpb, mask, dpm = _case(case)
    monkeypatch.setenv("SEI_TRUNK_SAVES", "1")
    want = _jax_trunk(x, params, rpb, mask, dpm, tgt, jnp.float32)
    calls = _count_calls(monkeypatch)
    got = _port_trunk(st.swin_trunk, x, params, rpb, mask, dpm, tgt, torch.float32, saves=True)
    # mode "full": 4 GEMMs + 1 attention forward per block, then the qkv recompute
    assert calls == {"gemm_bias_epilogue": 5 * D, "window_attn_fwd": D}
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5, err_msg="y")
    np.testing.assert_allclose(got[1], want[1], err_msg="dx", **tol)
    for k in st.PARAM_LEAVES:
        np.testing.assert_allclose(got[2][k], want[2][k], err_msg=k, **tol)
    np.testing.assert_allclose(got[3], want[3], err_msg="drpb", **tol)


@pytest.fixture(scope="module")
def jax_bf16():
    cache = {}

    def get(name):
        if name not in cache:
            x, tgt, params, rpb, mask, dpm = _case(name)
            cache[name] = _jax_trunk(x, params, rpb, mask, dpm, tgt, jnp.bfloat16)
        return cache[name]

    return get


def _assert_grads_close(got, want, frac):
    """Each gradient within ``frac`` of its tensor's largest entry."""
    pairs = [("dx", got[1], want[1]), ("drpb", got[3], want[3])]
    pairs += [(k, got[2][k], want[2][k]) for k in st.PARAM_LEAVES]
    for name, a, b in pairs:
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=frac, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_trunk_matches_jax_k5_k7(case, jax_bf16, monkeypatch):
    x, tgt, params, rpb, mask, dpm = _case(case)
    want = jax_bf16(case)
    calls = _count_calls(monkeypatch)
    got = _port_trunk(st.swin_trunk, x, params, rpb, mask, dpm, tgt, BF16)
    assert calls == {"gemm_bias_epilogue": 5 * D, "window_attn_fwd": D}  # saves on for bf16
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2, err_msg="y")
    _assert_grads_close(got, want, 1e-2)


def test_bf16_trunk_reference_autograd_matches_jax(jax_bf16):
    x, tgt, params, rpb, mask, dpm = _case("two_images_dpm")
    want = jax_bf16("two_images_dpm")
    got = _port_trunk(st.trunk_reference, x, params, rpb, mask, dpm, tgt, BF16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2, err_msg="y")
    _assert_grads_close(got, want, 3e-2)


def test_bf16_no_grad_forward_matches_saves_forward():
    x, _, params, rpb, mask, dpm = _case("two_images_dpm")
    args = (torch.from_numpy(x).to(BF16), {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(rpb), torch.from_numpy(mask), torch.from_numpy(dpm))
    with torch.no_grad():
        y0 = st.swin_trunk(*args, num_heads=NH, window_size=WS)
    leaves = {k: v.clone().requires_grad_() for k, v in args[1].items()}
    y1 = st.swin_trunk(args[0], leaves, *args[2:], num_heads=NH, window_size=WS)
    assert y0.dtype == y1.dtype == BF16 and y0.grad_fn is None and y1.grad_fn is not None
    np.testing.assert_allclose(y0.float().numpy(), y1.detach().float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_bf16_recompute_mode_matches_jax(monkeypatch):
    """``saves=False`` in bf16: the recompute backward (K6 in bf16) against
    the JAX trunk with ``SEI_TRUNK_SAVES=0``, at (c)'s tolerances."""
    x, tgt, params, rpb, mask, dpm = _case("one_image_shift")
    monkeypatch.setenv("SEI_TRUNK_SAVES", "0")
    want = _jax_trunk(x, params, rpb, mask, dpm, tgt, jnp.bfloat16)
    calls = _count_calls(monkeypatch)
    got = _port_trunk(st.swin_trunk, x, params, rpb, mask, dpm, tgt, BF16, saves=False)
    assert calls == {"gemm_bias_epilogue": 6 * D, "window_attn_fwd": 2 * D}
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2, err_msg="y")
    _assert_grads_close(got, want, 1e-2)


# -- (d): SwinIR ------------------------------------------------------------

CFG = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)


def test_bf16_swinir_matches_flax(monkeypatch):
    monkeypatch.setenv("SEI_TRUNK_INTERPRET", "1")
    init = jswinir.SwinIR(mlp_ratio=2.0, drop_path_rate=0.0, upsampler=None, **CFG)
    params = init.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), params)
    x = np.random.default_rng(1).random((2, 3, 16, 16)).astype(np.float32)
    tgt = np.random.default_rng(2).random((2, 3, 16, 16)).astype(np.float32)
    flax16 = jswinir.SwinIR(mlp_ratio=2.0, drop_path_rate=0.0, upsampler=None,
                            fused_trunk=True, dtype=jnp.bfloat16, **CFG)

    def loss(p):
        out = flax16.apply({"params": p}, jnp.asarray(x), True)
        return jnp.mean((out - tgt) ** 2), out

    (want_loss, want_out), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    assert want_out.dtype == jnp.float32
    want_g = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_g))

    m = tswinir.SwinIR(dtype=BF16, **swinir_config(task="deblurring",
                                                     overrides=dict(CFG, drop_path_rate=0.0)))
    m.load_state_dict(jax_params_to_state_dict(params), strict=True)
    m.eval()
    out = m(torch.from_numpy(x))
    assert out.dtype == torch.float32
    got_loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    got_loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=5e-2)
    assert float(got_loss.detach()) == pytest.approx(float(want_loss), rel=1e-2)
    conv_biases = {n for n, mod in m.named_modules() if isinstance(mod, torch.nn.Conv2d)}
    for n, p in m.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        w = want_g[n].numpy()
        scale = max(np.abs(w).max(), 1e-6)
        frac = 1e-1 if n.endswith(".bias") and n[:-5] in conv_biases else 3e-2
        np.testing.assert_allclose(p.grad.numpy() / scale, w / scale, rtol=0, atol=frac,
                                   err_msg=n)


def test_bf16_module_path_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tswinir.SwinIR(dtype=BF16, fused_trunk=False, **swinir_config(task="deblurring",
                                                                        overrides=CFG))


# -- (e): the trainer -------------------------------------------------------


def test_bf16_trainer_two_steps_on_cpu():
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.random((3, 40, 48)).astype(np.float32) for _ in range(4)]
    cache = build_device_cache(images, phys, seed=0)
    model = get_model(device="cpu", swinir_overrides=dict(CFG), dtype=BF16)
    assert model.module.compute_dtype == BF16
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    tr = Trainer(model, get_loss(method="proposed", physics=phys, crop_size=24), phys, cache,
                 batch_size=2, epochs=1, crop_size=32)
    losses = []
    stats = tr.train(on_step=lambda s, loss: losses.append(float(loss)), log_every_epoch=False)
    assert stats["steps"] == 2 and np.all(np.isfinite(losses))
    after = model.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert all(v.dtype == torch.float32 for v in after.values())
    states = list(tr.opt.state.values())
    assert len(states) == len(list(model.module.parameters()))
    for s in states:
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
