"""SwinIR's module path (``fused_trunk=False``) against the flax module path
(CPU), and ``SEI_FUSED_TRUNK``.

* bf16: the port's ``SwinIR(dtype=bfloat16, fused_trunk=False)`` against
  the flax ``SwinIR(dtype=bfloat16, fused_trunk=False)`` (its attention
  ``_xla_attention``, as off a TPU), same weights, on an MSE loss: output
  to 5e-2, loss to rtol 1e-2, gradients to 3e-2 of each tensor's max and
  the convolutions' biases to 1e-1, the bounds of
  ``tests/test_torch_bf16.py``'s fused comparison.  The port rounds a
  Linear's output once (flax rounds the product, then the bias add) and
  its GELU once (flax rounds each of erf's operations); XLA on the CPU may
  keep an f32 value where a bf16 rounding stood (excess precision), and
  sums a bf16 conv bias's gradient in bf16, so bf16 results differ by a
  few ulps that the blocks carry on.
  XLA sums a bf16 Dense bias's gradient in bf16 too (the broadcast's
  transpose, before the cast to f32): on 512 tokens that moves the qkv
  biases' gradients by up to ~11% of their max, where PyTorch's f32 sum is
  exact to its last rounding.  So the reference here is flax's module path
  with each Dense layer's bias add given an f32 sum in its backward
  (``nn.intercept_methods``; its forward is flax's, bit for bit): every
  other gradient equals stock flax's bit for bit, and the Dense biases keep
  the 3e-2 bound against it.
* f32: the same comparison to 1e-4 (output, loss and every gradient, of
  each tensor's max).
* The module path calls ``window_attention`` once per block and never the
  fused trunk; its plain path (``forward(plain=True)``) gives the same
  output, and gradients to 3e-2 of each max in bf16.
* ``SEI_FUSED_TRUNK`` picks the path as the JAX package reads it, through
  ``get_model``, ``cli.train`` (one step at narrow widths) and ``cli.test``.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models import swinir as jswinir
from sei_tpu_torch import config
from sei_tpu_torch.cli import test as cli_test
from sei_tpu_torch.cli import train as cli_train
from sei_tpu_torch.data import write_image
from sei_tpu_torch.models import get_model, jax_params_to_state_dict, swinir_config
from sei_tpu_torch.models import swinir as tswinir

CFG = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 2), window_size=4)
BF16 = torch.bfloat16
BLOCKS = sum(CFG["depths"])


@pytest.fixture(scope="module")
def case():
    init = jswinir.SwinIR(mlp_ratio=2.0, drop_path_rate=0.0, upsampler=None, **CFG)
    params = init.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32), params)
    x = np.random.default_rng(1).random((2, 3, 16, 16)).astype(np.float32)
    tgt = np.random.default_rng(2).random((2, 3, 16, 16)).astype(np.float32)
    return params, x, tgt


@jax.custom_vjp
def _add_bias(y, b):
    return y + b.astype(y.dtype)  # flax's Dense: the bias cast, added in y's dtype


def _add_bias_fwd(y, b):
    return _add_bias(y, b), None


def _add_bias_bwd(_, dy):
    return dy, jnp.sum(dy.astype(jnp.float32), axis=tuple(range(dy.ndim - 1)))


_add_bias.defvjp(_add_bias_fwd, _add_bias_bwd)


def _dense_f32_bias_sum(next_fun, args, kwargs, context):
    """flax ``nn.Dense.__call__`` (no precision, a 1-D bias), with its bias
    gradient summed in f32."""
    m = context.module
    if not isinstance(m, nn.Dense) or context.method_name != "__call__":
        return next_fun(*args, **kwargs)
    (x,) = args
    kernel, bias = m.get_variable("params", "kernel"), m.get_variable("params", "bias")
    y = jax.lax.dot_general(x.astype(m.dtype), kernel.astype(m.dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return _add_bias(y, bias)


def _flax(params, x, tgt, dtype, f32_bias_sums=False):
    module = jswinir.SwinIR(mlp_ratio=2.0, drop_path_rate=0.0, upsampler=None,
                            fused_trunk=False, dtype=dtype, **CFG)

    def loss(p):
        if f32_bias_sums:
            with nn.intercept_methods(_dense_f32_bias_sum):
                out = module.apply({"params": p}, jnp.asarray(x), True)
        else:
            out = module.apply({"params": p}, jnp.asarray(x), True)
        return jnp.mean((out - tgt) ** 2), out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    assert out.dtype == jnp.float32
    grads = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    return float(value), np.asarray(out), {k: v.numpy() for k, v in grads.items()}


def _port(params, x, tgt, dtype, plain=False):
    m = tswinir.SwinIR(dtype=dtype, fused_trunk=False,
                       **swinir_config(task="deblurring", overrides=dict(CFG, drop_path_rate=0.0)))
    m.load_state_dict(jax_params_to_state_dict(params), strict=True)
    m.eval()
    out = m(torch.from_numpy(x), plain=plain)
    assert out.dtype == torch.float32
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m.parameters())
    conv_biases = {n + ".bias" for n, mod in m.named_modules() if isinstance(mod, torch.nn.Conv2d)}
    return float(loss.detach()), out.detach().numpy(), grads, conv_biases


def _assert_grads(got, want, frac, conv_biases=(), conv_bias_frac=None):
    assert set(got) == set(want)
    for n, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        tol = conv_bias_frac if n in conv_biases else frac
        np.testing.assert_allclose(got[n] / scale, w / scale, rtol=0, atol=tol, err_msg=n)


def test_bf16_module_path_matches_flax(case):
    params, x, tgt = case
    want_loss, want_out, want_g = _flax(params, x, tgt, jnp.bfloat16, f32_bias_sums=True)
    stock_loss, stock_out, stock_g = _flax(params, x, tgt, jnp.bfloat16)
    assert want_loss == stock_loss and np.array_equal(want_out, stock_out)
    dense_biases = {n for n in want_g if n.endswith(("qkv.bias", "proj.bias", "fc1.bias",
                                                      "fc2.bias"))}
    assert all(np.array_equal(want_g[n], stock_g[n]) for n in set(want_g) - dense_biases)
    got_loss, got_out, got_g, conv_biases = _port(params, x, tgt, BF16)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=5e-2)
    assert got_loss == pytest.approx(want_loss, rel=1e-2)
    _assert_grads(got_g, want_g, 3e-2, conv_biases, 1e-1)


def test_f32_module_path_matches_flax(case):
    params, x, tgt = case
    want_loss, want_out, want_g = _flax(params, x, tgt, None)
    got_loss, got_out, got_g, _ = _port(params, x, tgt, None)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=1e-4)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    _assert_grads(got_g, want_g, 1e-4)


def test_module_path_calls_the_attention_kernel_per_block(case, monkeypatch):
    """One ``window_attention`` call per block and no trunk call; the plain
    path gives the same output (on the CPU both are the plain attention)
    and, by autograd through the plain attention, the kernels' backward's
    gradients to 3e-2 of each max."""
    params, x, tgt = case
    calls = {"window_attention": 0, "swin_trunk": 0}
    for name in calls:
        real = getattr(tswinir, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tswinir, name, spy)
    _, out_k, g_k, _ = _port(params, x, tgt, BF16)
    assert calls == {"window_attention": BLOCKS, "swin_trunk": 0}
    _, out_p, g_p, _ = _port(params, x, tgt, BF16, plain=True)
    assert calls == {"window_attention": BLOCKS, "swin_trunk": 0}
    np.testing.assert_array_equal(out_k, out_p)
    _assert_grads(g_k, g_p, 3e-2)


@pytest.mark.parametrize("env,fused", [(None, True), ("1", True), ("0", False), ("false", False),
                                       ("", False)])
def test_sei_fused_trunk_picks_the_path_through_get_model(env, fused, monkeypatch):
    if env is None:
        monkeypatch.delenv("SEI_FUSED_TRUNK", raising=False)
    else:
        monkeypatch.setenv("SEI_FUSED_TRUNK", env)
    model = get_model(device="cpu", swinir_overrides=CFG, dtype=BF16)
    assert model.module.fused_trunk is fused
    assert all(layer.fused_trunk is fused for layer in model.module.layers)
    assert get_model(device="cpu", swinir_overrides=CFG, fused_trunk=True).module.fused_trunk


TINY = ["--SwinIR__embed_dim", "12", "--SwinIR__depths", "2", "--SwinIR__num_heads", "2",
        "--SwinIR__window_size", "4"]
TASK = ["--task", "deblurring", "--kernel", "Gaussian_R2"]


def test_command_lines_reach_the_bf16_module_path(tmp_path, monkeypatch):
    """``SEI_FUSED_TRUNK=0 cli.train --bf16``: one step on the module path
    in bf16 (4 PNGs, batch 4), finite loss, every weight moved; ``cli.test``
    builds the module path too."""
    monkeypatch.setenv("SEI_FUSED_TRUNK", "0")
    rng = np.random.default_rng(0)
    for i in range(4):
        write_image(str(tmp_path / "gt" / f"{i}.png"), rng.random((3, 40, 44)))
    data = ["--dataset", f"gt_folder:{tmp_path / 'gt'}", "--GroundTruthDataset__size", "40"]
    result = cli_train.main(["--device", "cpu", *TASK, "--method", "proposed", *data, *TINY,
                             "--bf16", "--epochs", "1", "--batch_size", "4",
                             "--PrepareTrainingPairs__crop_size", "32", "--Loss__crop_size", "24",
                             "--out_dir", str(tmp_path / "run")])
    module = result["trainer"].model.module
    assert not module.fused_trunk and module.compute_dtype == BF16
    assert result["stats"]["steps"] == 1 and np.isfinite(float(result["losses"][0]))
    start = torch.load(tmp_path / "run" / "checkpoints" / "ckp_0.pt", weights_only=False)["params"]
    assert all(not torch.equal(v, start[k]) for k, v in module.state_dict().items())
    parser = config.DefaultArgParser()
    config.add_test_args(parser)
    _, _, model, _ = cli_test.build(parser.parse_args(["--device", "cpu", *TASK, *TINY]))
    assert not model.module.fused_trunk
