"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU: it is marked ``gpu`` and skips without
one (the CPU has no kernel to run: the wrappers take the plain versions
there, which the JAX golden tests cover).  This file imports only torch and
the port, so it runs on the GPU machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Small and ragged shapes (M, K, N not multiples of the tiles; C = 16 and 256;
windows of 16 tokens, hd 8; window counts that are not multiples of the
partial count) that the flagship checks in ``chip_smoke.py`` do not reach.
Tolerances as in chip_smoke: 1e-5 (LN forward), 1e-4 (GEMMs and LN
backward: sums of up to a few thousand products in another order),
2e-5 (attention forward), 1e-4 (attention backward: dbias sums over all
windows), 2e-5 on a two-block trunk forward and 1e-4 on its gradients.
"""

import numpy as np
import pytest
import torch

from sei_tpu_torch.models.swinir import shift_attn_mask
from sei_tpu_torch.ops import attention as at
from sei_tpu_torch.ops import swin_trunk as st


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, s=1.0):
    return torch.randn(shape, generator=g, device="cuda") * s


def _close(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("c", [16, 180, 256])
@pytest.mark.parametrize("shift", [None, 0, 2])
def test_ln_rows(gpu, c, shift):
    x = _rnd(gpu, 2, 8, 12, c)
    g, b = 1 + _rnd(gpu, c, s=0.1), _rnd(gpu, c, s=0.1)
    wm = None if shift is None else st.WindowMap(8, 12, 4, shift)
    inp = x if wm else x.view(-1, c)
    before = st.ln_rows.launches
    _close(st.ln_rows(inp, g, b, window=wm), st._torch_ln_rows(inp, g, b, wm), 1e-5)
    assert st.ln_rows.launches == before + 1


@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (130, 360, 180)])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual"])
def test_gemm_bias_epilogue(gpu, m, k, n, epilogue):
    a, w, b = _rnd(gpu, m, k), _rnd(gpu, k, n, s=0.1), _rnd(gpu, n, s=0.1)
    res = _rnd(gpu, m, n) if epilogue == "residual" else None
    dpm = torch.tensor([0.5, 1.25], device="cuda")[: 2 if m % 2 == 0 else 1] if res is not None else None
    got = st.gemm_bias_epilogue(a, w, b, epilogue, res=res, dpm=dpm)
    _close(got, st._torch_gemm_bias_epilogue(a, w, b, epilogue, res, dpm), 1e-4)


@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_residual_window_store(gpu, shift):
    wm = st.WindowMap(8, 12, 4, shift)
    a, w, b = _rnd(gpu, 2 * 96, 24), _rnd(gpu, 24, 16, s=0.1), _rnd(gpu, 16, s=0.1)
    res = _rnd(gpu, 2, 8, 12, 16)
    dpm = torch.tensor([0.0, 1.25], device="cuda")
    got = st.gemm_bias_epilogue(a, w, b, "residual", res=res, dpm=dpm, window=wm)
    _close(got, st._torch_gemm_bias_epilogue(a, w, b, "residual", res, dpm, wm), 1e-4)


@pytest.mark.parametrize("n,hd", [(16, 8), (64, 30), (49, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd(gpu, n, hd, masked):
    b_, nh, nw = 12, 3, 6
    q, k, v = (_rnd(gpu, b_, nh, n, hd, s=hd ** -0.5), _rnd(gpu, b_, nh, n, hd),
               _rnd(gpu, b_, nh, n, hd))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((nw, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    m = mask if masked else None
    _close(at.window_attn_fwd(q, k, v, bias, m, scale=1.5),
           at._torch_attention(q, k, v, bias, m, 1.5), 2e-5)


def test_wrappers_raise_on_unsupported_shapes(gpu):
    with pytest.raises(ValueError, match="C <= 256"):
        st.ln_rows(_rnd(gpu, 4, 300), torch.ones(300, device="cuda"),
                   torch.zeros(300, device="cuda"))
    q = _rnd(gpu, 2, 1, 81, 8)
    with pytest.raises(ValueError, match="N <= 64"):
        at.window_attn_fwd(q, q, q, _rnd(gpu, 1, 81, 81))


def test_trunk_chain_matches_reference(gpu):
    d, b, h, w, c, nh, ws = 2, 2, 8, 12, 24, 3, 4
    n = ws * ws
    s = 0.1
    params = {
        "ln1_s": 1 + _rnd(gpu, d, c, s=s), "ln1_b": _rnd(gpu, d, c, s=s),
        "qkv_w": _rnd(gpu, d, c, 3 * c, s=s), "qkv_b": _rnd(gpu, d, 3 * c, s=s),
        "proj_w": _rnd(gpu, d, c, c, s=s), "proj_b": _rnd(gpu, d, c, s=s),
        "ln2_s": 1 + _rnd(gpu, d, c, s=s), "ln2_b": _rnd(gpu, d, c, s=s),
        "fc1_w": _rnd(gpu, d, c, 2 * c, s=s), "fc1_b": _rnd(gpu, d, 2 * c, s=s),
        "fc2_w": _rnd(gpu, d, 2 * c, c, s=s), "fc2_b": _rnd(gpu, d, c, s=s),
    }
    rpb = _rnd(gpu, d, nh, n, n, s=s)
    mask = torch.from_numpy(shift_attn_mask(h, w, ws, ws // 2)).cuda()
    dpm = torch.tensor([[[1.0, 0.5], [0.0, 1.25]], [[1.25, 1.0], [1.0, 0.0]]], device="cuda")
    x = _rnd(gpu, b, h, w, c)
    st.reset_launch_counts()
    got = st.swin_trunk(x, params, rpb, mask, dpm, num_heads=nh, window_size=ws)
    assert st.launch_counts() == {"ln_rows": 2 * d, "gemm_bias_epilogue": 4 * d,
                                  "window_attn_fwd": d, "gemm_dgrad": 0, "gemm_wgrad": 0,
                                  "window_attn_bwd": 0, "ln_rows_bwd": 0}
    want = st.trunk_reference(x, params, rpb, mask, dpm, num_heads=nh, window_size=ws)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("c,shift", [(16, None), (180, 0), (180, 2), (256, None)])
@pytest.mark.parametrize("with_res", [False, True])
def test_ln_rows_bwd(gpu, c, shift, with_res):
    x = _rnd(gpu, 3, 8, 12, c)  # 288 rows: not a multiple of the partial count
    g = 1 + _rnd(gpu, c, s=0.1)
    wm = None if shift is None else st.WindowMap(8, 12, 4, shift)
    inp = x if wm else x.view(-1, c)
    dz = _rnd(gpu, 288, c)
    dres = _rnd(gpu, *inp.shape) if with_res else None
    before = st.ln_rows_bwd.launches
    got = st.ln_rows_bwd(inp, g, dz, window=wm, dres=dres)
    want = st._torch_ln_rows_bwd(inp, g, dz, wm, dres)
    assert st.ln_rows_bwd.launches == before + 1
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (130, 360, 180)])
@pytest.mark.parametrize("variant", ["plain", "scale", "gelu"])
def test_gemm_dgrad(gpu, m, k, n, variant):
    dy, w = _rnd(gpu, m, n), _rnd(gpu, k, n, s=0.1)
    scale = torch.tensor([0.0, 1.25], device="cuda")[: 2 if m % 2 == 0 else 1]
    scale = scale if variant != "plain" else None
    pre = _rnd(gpu, m, k) if variant == "gelu" else None
    got = st.gemm_dgrad(dy, w, scale=scale, pre=pre)
    _close(got, st._torch_gemm_dgrad(dy, w, scale, None, pre), 1e-4)


@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (4000, 360, 180)])
@pytest.mark.parametrize("scaled", [False, True])
def test_gemm_wgrad(gpu, m, k, n, scaled):
    a, dy = _rnd(gpu, m, k), _rnd(gpu, m, n)
    scale = torch.tensor([0.5, 1.25], device="cuda") if scaled else None
    got = st.gemm_wgrad(a, dy, scale=scale)
    want = st._torch_gemm_wgrad(a, dy, scale)
    for x, y in zip(got, want):
        _close(x, y, 1e-4 * max(1.0, m / 1000))


@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_bwd_window_gather(gpu, shift):
    wm = st.WindowMap(8, 12, 4, shift)
    dy = _rnd(gpu, 2, 8, 12, 16)
    a, w = _rnd(gpu, 192, 24), _rnd(gpu, 24, 16, s=0.1)
    scale = torch.tensor([0.0, 1.25], device="cuda")
    _close(st.gemm_dgrad(dy, w, scale=scale, window=wm),
           st._torch_gemm_dgrad(dy, w, scale, wm), 1e-4)
    for x, y in zip(st.gemm_wgrad(a, dy, scale=scale, window=wm),
                    st._torch_gemm_wgrad(a, dy, scale, wm)):
        _close(x, y, 1e-4)


def test_gemm_gelu_pre_epilogue(gpu):
    a, w, b = _rnd(gpu, 130, 20), _rnd(gpu, 20, 33, s=0.3), _rnd(gpu, 33, s=0.1)
    pre = torch.empty(130, 33, device="cuda")
    got = st.gemm_bias_epilogue(a, w, b, "gelu", pre=pre)
    pre_p = torch.empty_like(pre)
    want = st._torch_gemm_bias_epilogue(a, w, b, "gelu", pre=pre_p)
    _close(got, want, 1e-4)
    _close(pre, pre_p, 1e-4)


@pytest.mark.parametrize("n,hd,b_", [(16, 8, 12), (64, 30, 996), (49, 32, 30)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_bwd(gpu, n, hd, b_, masked):
    nh, nw = 3, 6
    q, k, v, do = (_rnd(gpu, b_, nh, n, hd, s=hd ** -0.5), _rnd(gpu, b_, nh, n, hd),
                   _rnd(gpu, b_, nh, n, hd), _rnd(gpu, b_, nh, n, hd))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((nw, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    m = mask if masked else None
    before = at.window_attn_bwd.launches
    got = at.window_attn_bwd(q, k, v, bias, m, do, scale=1.5)
    assert at.window_attn_bwd.launches == before + 1
    for x, y in zip(got, at._torch_attention_bwd(q, k, v, bias, m, do, 1.5)):
        _close(x, y, 1e-4)


def test_window_attention_grad_uses_kernels(gpu):
    q, k, v = (_rnd(gpu, 12, 2, 16, 8).requires_grad_() for _ in range(3))
    bias = _rnd(gpu, 2, 16, 16, s=0.1).requires_grad_()
    before = (at.window_attn_fwd.launches, at.window_attn_bwd.launches)
    at.window_attention(q, k, v, bias, None, scale=0.5).square().sum().backward()
    assert (at.window_attn_fwd.launches, at.window_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(
        at._torch_attention(q, k, v, bias, None, 0.5).square().sum(), (q, k, v, bias))
    for t, g in zip((q, k, v, bias), want):
        _close(t.grad, g, 1e-4)


def test_trunk_grads_match_reference(gpu):
    d, b, h, w, c, nh, ws = 2, 2, 8, 12, 24, 3, 4
    n = ws * ws
    s = 0.1
    shapes = {"ln1_s": (c,), "ln1_b": (c,), "qkv_w": (c, 3 * c), "qkv_b": (3 * c,),
              "proj_w": (c, c), "proj_b": (c,), "ln2_s": (c,), "ln2_b": (c,),
              "fc1_w": (c, 2 * c), "fc1_b": (2 * c,), "fc2_w": (2 * c, c), "fc2_b": (c,)}
    params = {k: (1.0 if k.startswith("ln") and k.endswith("_s") else 0.0)
              + _rnd(gpu, d, *shp, s=s) for k, shp in shapes.items()}
    rpb = _rnd(gpu, d, nh, n, n, s=s)
    mask = torch.from_numpy(shift_attn_mask(h, w, ws, ws // 2)).cuda()
    dpm = torch.tensor([[[1.0, 0.5], [0.0, 1.25]], [[1.25, 1.0], [1.0, 0.0]]], device="cuda")
    x, tgt = _rnd(gpu, b, h, w, c), _rnd(gpu, b, h, w, c)

    def grads(fn):
        leaves = [x, rpb, *params.values()]
        leaves = [t.clone().requires_grad_() for t in leaves]
        p = dict(zip(params, leaves[2:]))
        y = fn(leaves[0], p, leaves[1], mask, dpm, num_heads=nh, window_size=ws)
        return torch.autograd.grad(((y - tgt) ** 2).mean(), leaves)

    st.reset_launch_counts()
    got = grads(st.swin_trunk)
    assert st.launch_counts() == {"ln_rows": 4 * d, "gemm_bias_epilogue": 6 * d,
                                  "window_attn_fwd": 2 * d, "gemm_dgrad": 4 * d,
                                  "gemm_wgrad": 4 * d, "window_attn_bwd": d,
                                  "ln_rows_bwd": 2 * d}
    for a, b_ in zip(got, grads(st.trunk_reference)):
        _close(a, b_, 1e-4)
