"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU: it is marked ``gpu`` and skips without
one (the CPU has no kernel to run: the wrappers take the plain versions
there, which the JAX golden tests cover).  This file imports only torch and
the port, so it runs on the GPU machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Small and ragged shapes (M, K, N not multiples of the tiles; C = 16 and 256;
windows of 16 tokens, hd 8) that the flagship checks in ``chip_smoke.py``
do not reach.  Tolerances as in chip_smoke: 1e-5 (LN), 1e-4 (GEMM, K <= 360),
2e-5 (attention), 2e-5 on a two-block trunk.
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
                                  "window_attn_fwd": d}
    want = st.trunk_reference(x, params, rpb, mask, dpm, num_heads=nh, window_size=ws)
    _close(got, want, 2e-5)
