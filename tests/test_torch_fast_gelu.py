"""``SEI_FAST_GELU`` in the port against the JAX package (CPU).

The JAX trunk reads ``SEI_FAST_GELU`` at trace time (``_use_fast_gelu``,
``sei_tpu/ops/swin_trunk.py:233-238``): unset, the polynomial GELU in bf16
and the exact one in f32; set, ``"0"``, ``"false"`` and ``""`` the exact
form and anything else the polynomial, in either dtype.  The port's
``use_fast_gelu`` makes the same choice, and the trunk, its plain version,
the GEMM epilogue and SwinIR take it.

* ``use_fast_gelu`` against ``_use_fast_gelu`` over the env values and both
  dtypes; an explicit ``fast_gelu`` wins.
* The plain epilogue (``_torch_gemm_bias_epilogue``, "gelu" and
  "gelu_pair") in both forms and dtypes against ``_gelu_exact`` /
  ``_gelu_grad`` / ``_gelu_fast`` / ``_gelu_pair_fast`` on the same f32
  pre-activation: 1e-6 in f32 for the polynomial (the same Horner chains),
  2e-6 for the exact form (the JAX one's polynomial erf is off by <= 1.5e-7,
  times |x| / 2), one bf16 ulp more in bf16.
* The f32 trunk with ``SEI_FAST_GELU=1`` (the kernel chain and
  ``trunk_reference``) against the JAX ``trunk_reference`` and the JAX
  kernel in interpret mode at 2e-5 (``test_torch_swin_trunk.py``'s
  tolerance), its gradients against ``jax.grad`` of the JAX kernel at rtol
  5e-4 / atol 5e-5 (``test_torch_trunk_grad.py``'s); the exact and the
  polynomial outputs differ by more than 2e-5 in both packages, so the
  comparison fails if either ignores the knob.  Each JAX call runs under
  its own env setting with a fresh function, so no trace of the other
  setting is reused.
* The bf16 trunk with ``SEI_FAST_GELU=0`` against the JAX bf16 kernel in
  interpret mode at ``test_torch_bf16.py``'s gates (y 2e-2, gradients 3e-2
  of each tensor's max); its output is not the default form's.
* The recompute backward takes the form its forward took: the gradients
  are equal, bit for bit, when the env is cleared between the two.
* ``SwinIR`` and ``get_model`` resolve the env at construction; the module
  path (``fused_trunk=False``, exact erf as the JAX module path) is the same
  with the env set or not.

Sizes: 2 blocks, C 16, 2 heads, window 4, one 8x8 image
(``test_torch_swin_trunk._stacked_params``, fc1's weights times 10 and
fc2's times 5, so the MLP's pre-activations reach the range where the two
forms part: at init scale they agree to 3e-7 through both blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.models.swinir import shift_attn_mask
from sei_tpu.ops import swin_trunk as jst
from sei_tpu_torch.models import get_model
from sei_tpu_torch.models import swinir as tswinir
from sei_tpu_torch.ops import swin_trunk as st
from tests.test_torch_bf16 import _assert_grads_close
from tests.test_torch_swin_trunk import _stacked_params

NH, WS = 2, 4
BF16 = torch.bfloat16
TOL = 2e-5
RTOL, ATOL = 5e-4, 5e-5
ENV_VALUES = [None, "0", "false", "", "1", "true"]
CFG = dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=4)


def _set_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SEI_FAST_GELU", raising=False)
    else:
        monkeypatch.setenv("SEI_FAST_GELU", value)


@pytest.mark.parametrize("env", ENV_VALUES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_use_fast_gelu_matches_jax(env, dtype, monkeypatch):
    _set_env(monkeypatch, env)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, BF16)}[dtype]
    want = jst._use_fast_gelu(jdt)
    assert st.use_fast_gelu(tdt) is want
    # an explicit form wins over the env and the dtype
    assert st.use_fast_gelu(tdt, True) is True and st.use_fast_gelu(tdt, False) is False


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("epilogue", ["gelu", "gelu_pair"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_plain_epilogue_forms_match_jax(fast, epilogue, dtype):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((24, 36)) * 0.6).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.standard_normal(36) * 0.3).astype(np.float32))
    gp = torch.empty(40, 36) if epilogue == "gelu_pair" else None
    got = st._torch_gemm_bias_epilogue(a, w, b, epilogue, gp=gp, fast_gelu=fast)
    h = jnp.asarray(torch.addmm(b, a.float(), w.float()).numpy())
    assert float(jnp.abs(h).max()) > 4.0  # past the polynomial's saturation
    if fast:
        want_g, want_d = jst._gelu_pair_fast(h)
    else:
        want_g, want_d = jst._gelu_exact(h), jst._gelu_grad(h)
    # the same Horner chains (fast); the JAX exact form's polynomial erf
    # (|err| <= 1.5e-7) times |x| / 2 at |x| up to ~8 against torch.erf
    atol = 1e-6 if fast else 2e-6
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=0, atol=atol)
    else:  # one rounding of values that agree to atol: at most one bf16 ulp (2^-7) apart
        want = np.asarray(jnp.asarray(want_g).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=atol)
    if gp is not None:
        np.testing.assert_allclose(gp.numpy(), np.asarray(want_d), rtol=0, atol=atol)


# -- the trunk -------------------------------------------------------------------


def _case():
    params, rpb = _stacked_params()
    params["fc1_w"] = params["fc1_w"] * 10.0
    params["fc2_w"] = params["fc2_w"] * 5.0
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, params["ln1_s"].shape[1])).astype(np.float32)
    tgt = rng.standard_normal(x.shape).astype(np.float32)
    dpm = np.array([[[1.25], [0.8]], [[0.8], [1.25]]], np.float32)
    return x, tgt, params, rpb, shift_attn_mask(8, 8, WS, WS // 2), dpm


def _jax_kernel(dtype, x, tgt, params, rpb, mask, dpm):
    """The JAX kernel in interpret mode: (y, dx, {leaf: grad}, drpb), f32
    numpy; a fresh function per call, traced under the env as it is now."""

    def loss(x, params, rpb):
        y = jst.swin_trunk(x, params, rpb, mask, jnp.asarray(dpm), num_heads=NH,
                           window_size=WS, use_pallas=True, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * tgt), y

    (_, y), (gx, gp, gr) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x).astype(dtype), {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(rpb))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(y), f(gx), {k: f(v) for k, v in gp.items()}, f(gr)


def _jax_reference(x, params, rpb, mask, dpm):
    return np.asarray(jst.trunk_reference(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(rpb),
        mask, jnp.asarray(dpm), num_heads=NH, window_size=WS))


def _port(fn, dtype, x, tgt, params, rpb, mask, dpm, grads=True, **kw):
    """(y, dx, {leaf: grad}, drpb) as f32 numpy; y alone without ``grads``."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(grads)
    pt = {k: torch.from_numpy(v).requires_grad_(grads) for k, v in params.items()}
    rt = torch.from_numpy(rpb).requires_grad_(grads)
    y = fn(xt, pt, rt, torch.from_numpy(mask), torch.from_numpy(dpm), num_heads=NH,
           window_size=WS, **kw)
    f = lambda a: a.detach().float().numpy()  # noqa: E731
    if not grads:
        return f(y)
    (y.float() * torch.from_numpy(tgt)).sum().backward()
    return f(y), f(xt.grad), {k: f(v.grad) for k, v in pt.items()}, f(rt.grad)


def test_f32_trunk_with_fast_gelu_matches_jax(monkeypatch):
    case = _case()
    x, tgt, params, rpb, mask, dpm = case
    monkeypatch.delenv("SEI_FAST_GELU", raising=False)
    jax_exact = _jax_reference(x, params, rpb, mask, dpm)
    port_exact = _port(st.swin_trunk, torch.float32, *case, grads=False)
    monkeypatch.setenv("SEI_FAST_GELU", "1")
    want = _jax_kernel(jnp.float32, *case)
    jax_fast = _jax_reference(x, params, rpb, mask, dpm)
    got = _port(st.swin_trunk, torch.float32, *case)
    got_ref = _port(st.trunk_reference, torch.float32, *case, grads=False)
    # the knob moves both packages' outputs by more than the tolerance: the
    # exact form fails the comparison the polynomial passes
    for exact in (jax_exact, port_exact):
        assert np.abs(exact - want[0]).max() > TOL
        assert not np.allclose(exact, want[0], rtol=TOL, atol=TOL)
    for y in (got[0], got_ref):
        np.testing.assert_allclose(y, want[0], rtol=TOL, atol=TOL, err_msg="y vs JAX kernel")
        np.testing.assert_allclose(y, jax_fast, rtol=TOL, atol=TOL, err_msg="y vs JAX reference")
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL, err_msg="dx")
    for k in st.PARAM_LEAVES:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=ATOL, err_msg="drpb")


def test_bf16_trunk_with_exact_gelu_matches_jax(monkeypatch):
    case = _case()
    monkeypatch.delenv("SEI_FAST_GELU", raising=False)
    default = _port(st.swin_trunk, BF16, *case, grads=False)
    monkeypatch.setenv("SEI_FAST_GELU", "0")
    want = _jax_kernel(jnp.bfloat16, *case)
    got = _port(st.swin_trunk, BF16, *case)
    assert not np.array_equal(got[0], default)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2, err_msg="y")
    _assert_grads_close(got, want, 3e-2)


@pytest.mark.parametrize("dtype,env", [(torch.float32, "1"), (BF16, "0")], ids=["f32", "bf16"])
def test_backward_keeps_the_forwards_form(dtype, env, monkeypatch):
    """The recompute backward (mode xs) takes the form on the autograd
    context, never the env at backward time."""
    x, tgt, params, rpb, mask, dpm = _case()

    def grads(clear):
        monkeypatch.setenv("SEI_FAST_GELU", env)
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        y = st.swin_trunk(xt, pt, torch.from_numpy(rpb), torch.from_numpy(mask),
                          torch.from_numpy(dpm), num_heads=NH, window_size=WS, saves=False)
        if clear:
            monkeypatch.delenv("SEI_FAST_GELU")
        (y.float() * torch.from_numpy(tgt)).sum().backward()
        return [xt.grad] + [pt[k].grad for k in st.PARAM_LEAVES]

    kept, cleared = grads(False), grads(True)
    assert all(torch.equal(a, b) for a, b in zip(kept, cleared))


# -- SwinIR ----------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("dtype", [None, BF16], ids=["f32", "bf16"])
def test_swinir_and_get_model_resolve_the_env(env, dtype, monkeypatch):
    _set_env(monkeypatch, env)
    want = (dtype == BF16) if env is None else env == "1"
    for module in (tswinir.SwinIR(dtype=dtype, **CFG),
                   get_model(device="cpu", swinir_overrides=CFG, dtype=dtype).module):
        assert module.fast_gelu is want
        assert all(layer.fast_gelu is want for layer in module.layers)
    # an explicit form wins
    assert get_model(device="cpu", swinir_overrides=CFG, fast_gelu=not want).module.fast_gelu \
        is (not want)


def _forward(monkeypatch, env, **kw):
    _set_env(monkeypatch, env)
    model = get_model(device="cpu", swinir_overrides=CFG, **kw)
    y = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model(y)


def test_swinir_forward_takes_the_env_form(monkeypatch):
    fast = _forward(monkeypatch, "1")
    assert torch.equal(fast, _forward(monkeypatch, None, fast_gelu=True))
    assert not torch.equal(fast, _forward(monkeypatch, None))


@pytest.mark.parametrize("dtype,env", [(None, "1"), (BF16, "0")], ids=["f32", "bf16"])
def test_module_path_ignores_the_env(dtype, env, monkeypatch):
    kw = dict(dtype=dtype, fused_trunk=False)
    assert torch.equal(_forward(monkeypatch, env, **kw), _forward(monkeypatch, None, **kw))
