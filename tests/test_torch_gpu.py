"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA GPU: it is marked ``gpu`` and skips without
one (the CPU has no kernel to run: the wrappers take the plain versions
there, which the JAX golden tests cover).  This file imports only torch and
the port, so it runs on the GPU machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The f32 forward GEMM (CUDA cores, 128x96 tiles) is held at the step's and
the eval's widths, on ragged shapes, odd widths and unaligned views, with
and without the window store, and repeats bit for bit; the f32 data grad
(96x96 tiles) at the f32 step's four calls on both graphs (one launch
each), on ragged, odd and unaligned operands, and repeats bit for bit; the
f32 weight grad (96x96 tiles) likewise, and with a split that has no rows;
the
f32 attention backward (register tiles) at the trunk's calls on both graphs,
strided as the trunk lays out q, k, v, do and dq, dk, dv, with and without
the att store (att also equal to the forward kernel's within 2e-5), on odd
head dims and offsets, and repeats bit for bit; the f32 attention forward
(the backward's register tiles) at the trunk's calls on both graphs, equal
to the backward's att bit for bit, with its f32 probability save, on odd
head dims and offsets, at window counts below and not divided by its
groups, and repeats bit for bit; the bf16 attention backward (tensor
cores) in both forms at N 16, 49, 64, hd 8, 17, 30, 32, both masks, odd
strides, the bf16 trunk's views at both graphs, and repeats bit for bit;
the bf16 attention forward (tensor cores) on the bf16 trunk's views at both
graphs with its p store (one launch), at N 16, 36, 49, 64, hd 8, 17, 30,
32 with p_out by each of its store routes, odd strides, window counts its
groups do not divide, its p equal to the backward's recompute (dv bit for
bit), and repeats bit for bit.
Small and ragged shapes (M, K, N not multiples of the tiles; C = 16 and 256;
windows of 16 tokens, hd 8; window counts that are not multiples of the
partial count) that the flagship checks in ``chip_smoke.py`` do not reach.
Tolerances as in chip_smoke: 1e-5 (LN forward), 1e-4 (GEMMs and LN
backward: sums of up to a few thousand products in another order),
2e-5 (attention forward), 1e-4 (attention backward: dbias sums over all
windows), 2e-5 on a two-block trunk forward and 1e-4 on its gradients.
The bf16 instantiations (and the save behaviours of the bf16 training
forward and backward) are held against the same plain versions, which
round where the kernels round: on bf16 outputs rtol 1e-2 (about 2 bf16
ulps) plus an atol of 1e-2 of the tensor's largest entry, since an f32 sum
taken in another order can flip a rounding of the output or of an
intermediate that is rounded before a further product (ds before dq and
dk: one flip moves dq by an ulp of the largest ds); 1e-4 on their f32
outputs (1e-3 + 1e-4 x |plain| on the tensor-core weight grad, whose sums
over up to 4608 tokens run in the mma's order; the tensor-core forward and
data-grad GEMMs are held at the same bf16 gates, at the step's widths, on
ragged and unaligned operands, and repeat bit for bit); on a two-block bf16 trunk the
gradients within 3e-2 of each tensor's largest entry (the JAX trunk test's
bound for its bf16 kernel against autograd of its reference).

The GELU epilogues in the form that is not their dtype's default
(``SEI_FAST_GELU``: f32 with the polynomial, bf16 with the exact erf, gp
in bf16 or f32) are held at the same gates, on ragged, odd and unaligned
operands, differ from the default form and repeat bit for bit; without
the env ``fast_gelu=None`` is the dtype's form bit for bit.
The launch-overhead probes (K8 ``copy_probe`` at every block count, and
in 16-byte accesses at each element offset, ragged counts and 1 or 132
blocks; K9 ``trunk_skeleton`` in each variant) equal their plain versions
exactly (an f32 add and one rounding).  A tiny SwinIR ``Trainer`` captured as a CUDA
graph (``scan_steps`` 1 and 2, f32 and bf16; the bf16 module path; the
global-norm clip) equals the eager trainer bit for bit over two steps
(losses, parameters, Adam state): the same kernels run in the same order on
the same draws; two inner steps of one replay draw
different SURE probes; a step with a host sync makes the capture raise.
"""

import numpy as np
import pytest
import torch

from sei_tpu_torch.data import build_device_cache
from sei_tpu_torch.losses import LossDraws, get_loss, sample_probe
from sei_tpu_torch.models import get_model
from sei_tpu_torch.models.swinir import shift_attn_mask
from sei_tpu_torch.ops import attention as at
from sei_tpu_torch.ops import launch_probe as lp
from sei_tpu_torch.ops import swin_trunk as st
from sei_tpu_torch.physics import get_physics
from sei_tpu_torch.train import Trainer


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: run `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, s=1.0):
    return torch.randn(shape, generator=g, device="cuda") * s


def _close(got, want, tol, atol=None):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol if atol is None else atol)


BF16 = torch.bfloat16
BF16_RTOL = 1e-2  # and an atol of BF16_RTOL x max |want|


def _close_bf16(got, want):
    """bf16 outputs to BF16_RTOL (relative, and of the largest entry), f32
    outputs (grads, partial sums) to 1e-4."""
    if want.dtype == BF16:
        _close(got, want, BF16_RTOL, BF16_RTOL * float(want.float().abs().max()))
    else:
        _close(got, want, 1e-4)


pytestmark = pytest.mark.gpu
F32 = torch.float32


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


def _gemm_case(g, m, k, n, epilogue, offset=0, dtype=F32):
    """Inputs of one gemm_bias_epilogue call in ``dtype`` (``offset``: a, w,
    res and gp start that many elements into a larger buffer), its kwargs,
    and the plain version's gp buffer; gp is f32 in f32, and in bf16 for
    "gelu_pair" or f32 for "gelu_pair_f32" (the recompute's)."""

    def buf(*shape, dtype=dtype, s=1.0):
        numel = int(np.prod(shape))
        return _rnd(g, numel + offset, s=s).to(dtype)[offset:].view(*shape)

    a, w, b = buf(m, k), buf(k, n, s=0.1), _rnd(g, n, s=0.1)
    res = buf(m, n) if epilogue == "residual" else None
    dpm = torch.tensor([0.5, 1.25], device="cuda")[: 2 if m % 2 == 0 else 1] if res is not None else None
    gp = gp_p = None
    if epilogue.startswith("gelu_pair"):
        gp = buf(m, n, dtype=F32 if dtype == F32 or epilogue.endswith("f32") else BF16)
        gp_p, epilogue = torch.empty_like(gp), "gelu_pair"
    return (a, w, b, epilogue), dict(res=res, dpm=dpm, gp=gp), gp_p


# f32 runs on the CUDA cores in 128x96 tiles, 20-deep slices: the step's and
# the eval's widths (K 180 / 360, N 180 / 360 / 540), M off the tile, K off
# the slice (44), odd K or N (one element per access)
@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (130, 360, 180),
                                   (300, 180, 180), (1037, 180, 360), (4608, 180, 540),
                                   (4608, 360, 180), (200, 44, 64), (65, 17, 36), (77, 36, 17)])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual", "gelu_pair"])
def test_gemm_bias_epilogue(gpu, m, k, n, epilogue):
    args, kw, gp_p = _gemm_case(gpu, m, k, n, epilogue)
    before = st.gemm_bias_epilogue.launches
    got = st.gemm_bias_epilogue(*args, **kw)
    assert st.gemm_bias_epilogue.launches == before + 1
    _close(got, st._torch_gemm_bias_epilogue(*args, kw["res"], kw["dpm"], None, gp_p), 1e-4)
    if gp_p is not None:
        _close(kw["gp"], gp_p, 1e-4)


@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual", "gelu_pair"])
def test_gemm_bias_epilogue_unaligned_pointers(gpu, epilogue):
    """a, w, res and gp at odd element offsets (views into larger buffers)
    cannot take float4 accesses: the f32 kernel goes element by element."""
    args, kw, gp_p = _gemm_case(gpu, 300, 180, 180, epilogue, offset=1)
    assert args[0].data_ptr() % 16 != 0
    got = st.gemm_bias_epilogue(*args, **kw)
    _close(got, st._torch_gemm_bias_epilogue(*args, kw["res"], kw["dpm"], None, gp_p), 1e-4)
    if gp_p is not None:
        _close(kw["gp"], gp_p, 1e-4)


@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual", "gelu_pair"])
def test_gemm_bias_epilogue_repeats_bit_for_bit(gpu, epilogue):
    """One FMA chain per output in a fixed order (no split-K, no atomics):
    two calls on the same inputs agree exactly, gp included."""
    args, kw, _ = _gemm_case(gpu, 4608, 180, 360, epilogue)
    first = st.gemm_bias_epilogue(*args, **kw)
    gp_first = None if kw["gp"] is None else kw["gp"].clone()
    second = st.gemm_bias_epilogue(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    if gp_first is not None:
        assert torch.equal(gp_first, kw["gp"])


# the window store (window reverse + roll folded into the residual's store):
# a small map, the flagship 48x48 crop with window 8, odd widths
@pytest.mark.parametrize("h,w,ws,k,n", [(8, 12, 4, 24, 16), (48, 48, 8, 180, 180),
                                        (16, 24, 8, 13, 17)])
@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_residual_window_store(gpu, shift, h, w, ws, k, n):
    wm = st.WindowMap(h, w, ws, shift)
    a, wt, b = _rnd(gpu, 2 * h * w, k), _rnd(gpu, k, n, s=0.1), _rnd(gpu, n, s=0.1)
    res = _rnd(gpu, 2, h, w, n)
    dpm = torch.tensor([0.0, 1.25], device="cuda")
    got = st.gemm_bias_epilogue(a, wt, b, "residual", res=res, dpm=dpm, window=wm)
    _close(got, st._torch_gemm_bias_epilogue(a, wt, b, "residual", res, dpm, wm), 1e-4)


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
    gp = _rnd(gpu, m, k) if variant == "gelu" else None  # gelu'(h) of the fc1 pre-activation
    got = st.gemm_dgrad(dy, w, scale=scale, gp=gp)
    _close(got, st._torch_gemm_dgrad(dy, w, scale, None, gp), 1e-4)


# f32 gemm_dgrad on the CUDA cores (96x96 tiles, 20-deep slices): the f32
# step's four calls at the flagship widths on both graphs (T = 16 or 8
# images of 48x48): (K, N, drop-path scale, gelu', window map)
_DGRAD_F32_VARIANTS = {"fc2": (360, 180, True, True, False),
                       "fc1": (180, 360, False, False, False),
                       "proj": (180, 180, True, False, True),
                       "qkv": (180, 540, False, False, False)}


def _dgrad_f32_case(g, variant, images):
    k, n, scaled, gelu, windowed = _DGRAD_F32_VARIANTS[variant]
    t = images * 48 * 48
    wm = st.WindowMap(48, 48, 8, 4) if windowed else None
    dy = _rnd(g, images, 48, 48, n) if windowed else _rnd(g, t, n)
    scale = ((torch.rand(images, generator=g, device="cuda") < 0.9).float() / 0.9
             if scaled else None)
    gp = _rnd(g, t, k) if gelu else None
    return (dy, _rnd(g, k, n, s=0.05)), dict(scale=scale, window=wm, gp=gp)


@pytest.mark.parametrize("variant", list(_DGRAD_F32_VARIANTS))
@pytest.mark.parametrize("images", [16, 8])
def test_gemm_dgrad_f32_step_widths(gpu, variant, images):
    (dy, w), kw = _dgrad_f32_case(gpu, variant, images)
    before = st.gemm_dgrad.launches
    got = st.gemm_dgrad(dy, w, **kw)
    assert st.gemm_dgrad.launches == before + 1
    _close(got, st._torch_gemm_dgrad(dy, w, kw["scale"], kw["window"], kw["gp"]), 1e-4)


@pytest.mark.parametrize("m,k,n", [(300, 180, 180), (129, 44, 36), (65, 17, 33)])
@pytest.mark.parametrize("gelu", [False, True])
def test_gemm_dgrad_f32_unaligned_pointers(gpu, m, k, n, gelu):
    """dy, w and gp at odd element offsets (views into larger buffers), or
    odd widths, cannot take float4 accesses: the f32 kernel goes element by
    element."""
    dy = _rnd(gpu, m * n + 1)[1:].view(m, n)
    w = _rnd(gpu, k * n + 1, s=0.1)[1:].view(k, n)
    gp = _rnd(gpu, m * k + 1)[1:].view(m, k) if gelu else None
    assert dy.data_ptr() % 16 != 0
    got = st.gemm_dgrad(dy, w, gp=gp)
    _close(got, st._torch_gemm_dgrad(dy, w, None, None, gp), 1e-4)


@pytest.mark.parametrize("variant", ["fc2", "proj"])
def test_gemm_dgrad_f32_repeats_bit_for_bit(gpu, variant):
    """One FMA chain per output in a fixed order (no split over N, no
    atomics): two calls on the same inputs agree exactly."""
    (dy, w), kw = _dgrad_f32_case(gpu, variant, 2)
    first = st.gemm_dgrad(dy, w, **kw)
    second = st.gemm_dgrad(dy, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# f32 gemm_wgrad on the CUDA cores (96x96 tiles of 8x6, 28-row slices, the
# split count from the kernel's occupancy): the f32 step's four calls at the
# flagship widths on both graphs (T = 16 or 8 images of 48x48), (K, N,
# drop-path scale, window map); dW and db to chip_smoke's 1e-3 + 1e-4 x
# |plain| (sums over up to 36864 tokens in another order)
_WGRAD_F32_VARIANTS = {"fc2": (360, 180, True, False), "fc1": (180, 360, False, False),
                       "proj": (180, 180, True, True), "qkv": (180, 540, False, False)}


def _wgrad_f32_case(g, variant, images):
    k, n, scaled, windowed = _WGRAD_F32_VARIANTS[variant]
    t = images * 48 * 48
    wm = st.WindowMap(48, 48, 8, 4) if windowed else None
    dy = _rnd(g, images, 48, 48, n) if windowed else _rnd(g, t, n)
    scale = ((torch.rand(images, generator=g, device="cuda") < 0.9).float() / 0.9
             if scaled else None)
    return _rnd(g, t, k), dy, scale, wm


@pytest.mark.parametrize("variant", list(_WGRAD_F32_VARIANTS))
@pytest.mark.parametrize("images", [16, 8])
def test_gemm_wgrad_f32_step_widths(gpu, variant, images):
    a, dy, scale, wm = _wgrad_f32_case(gpu, variant, images)
    before = st.gemm_wgrad.launches
    got = st.gemm_wgrad(a, dy, scale=scale, window=wm)
    assert st.gemm_wgrad.launches == before + 1
    for x, y in zip(got, st._torch_gemm_wgrad(a, dy, scale, wm)):
        _close(x, y, 1e-4, 1e-3)


@pytest.mark.parametrize("m,k,n", [(300, 180, 180), (129, 44, 36), (65, 17, 33)])
def test_gemm_wgrad_f32_unaligned_pointers(gpu, m, k, n):
    """a and dy at odd element offsets (views into larger buffers), or odd
    widths, cannot take float4 accesses: the f32 kernel goes element by
    element."""
    a = _rnd(gpu, m * k + 1)[1:].view(m, k)
    dy = _rnd(gpu, m * n + 1)[1:].view(m, n)
    scale = torch.tensor([0.5, 1.25, 1 / 0.9], device="cuda")[: 3 if m % 3 == 0 else 1]
    assert a.data_ptr() % 16 != 0
    for x, y in zip(st.gemm_wgrad(a, dy, scale=scale), st._torch_gemm_wgrad(a, dy, scale)):
        _close(x, y, 1e-4, 1e-3)


def test_gemm_wgrad_f32_empty_split(gpu):
    """Three splits of 32 rows in 28-row slices: the third has no rows and
    writes zeros; the partials sum to the plain version."""
    from sei_tpu_torch.ops import _build

    m, k, n, splits = 32, 24, 20, 3
    a, dy = _rnd(gpu, m, k), _rnd(gpu, m, n)
    dw = torch.full((splits, k, n), float("nan"), device="cuda")
    db = torch.full((splits, n), float("nan"), device="cuda")
    code = _build.library().lib.sei_gemm_wgrad(
        a.device.index, 0, a.data_ptr(), dy.data_ptr(), 0, None, dw.data_ptr(), db.data_ptr(),
        m, k, n, splits, 0, 0, 0, 0, 0, 0, 0, _build.stream_of(a))
    _build.check(code, "gemm_wgrad")
    torch.cuda.synchronize()
    assert not dw[-1].any() and not db[-1].any()
    for x, y in zip((dw.sum(0), db.sum(0)), st._torch_gemm_wgrad(a, dy)):
        _close(x, y, 1e-4, 1e-3)


@pytest.mark.parametrize("variant", ["fc2", "proj"])
def test_gemm_wgrad_f32_repeats_bit_for_bit(gpu, variant):
    """One FMA chain per output over each split's rows, the splits summed
    in a fixed order (no atomics): two calls on the same inputs agree
    exactly."""
    a, dy, scale, wm = _wgrad_f32_case(gpu, variant, 16)
    first = st.gemm_wgrad(a, dy, scale=scale, window=wm)
    second = st.gemm_wgrad(a, dy, scale=scale, window=wm)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_gemm_gelu_pre_epilogue(gpu):
    """The fc1 recompute's epilogue: gelu(h) and, beside it, gelu'(h) of the
    pre-activation h (the "gelu_pair" epilogue with an f32 gp buffer)."""
    a, w, b = _rnd(gpu, 130, 20), _rnd(gpu, 20, 33, s=0.3), _rnd(gpu, 33, s=0.1)
    gp = torch.empty(130, 33, device="cuda")
    got = st.gemm_bias_epilogue(a, w, b, "gelu_pair", gp=gp)
    gp_p = torch.empty_like(gp)
    want = st._torch_gemm_bias_epilogue(a, w, b, "gelu_pair", gp=gp_p)
    _close(got, want, 1e-4)
    _close(gp, gp_p, 1e-4)


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


# f32 window_attn_bwd on the CUDA cores (4x4 register tiles, cp.async
# stages): the trunk's calls at both graphs of the f32 step (2B = 16 and B =
# 8 images of 48x48: 576 and 288 windows, 6 heads, hd 30), q, k, v strided
# from the (B_, N, 3, nh, hd) qkv buffer, do from the (B_, N, nh, hd) proj
# buffer, dq, dk, dv into one qkv-shaped buffer, att beside them
def _attn_trunk_case(g, b_, n=64, hd=30, nh=6):
    qkv = _rnd(g, b_, n, 3, nh, hd)
    do = _rnd(g, b_, n, nh, hd, s=0.1).transpose(1, 2)
    bias = _rnd(g, nh, n, n, s=0.1)
    mask = torch.from_numpy(shift_attn_mask(48, 48, 8, 4)).cuda() if n == 64 else None
    return qkv, do, bias, mask


def _views(buf):
    return tuple(buf[:, :, i].transpose(1, 2) for i in range(3))


@pytest.mark.parametrize("b_", [576, 288])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_att", [False, True])
def test_window_attn_bwd_f32_trunk_shapes(gpu, b_, masked, with_att):
    qkv, do, bias, mask = _attn_trunk_case(gpu, b_)
    m = mask if masked else None
    dqkv = torch.full_like(qkv, float("nan"))
    att = torch.full((b_, 64, 6, 30), float("nan"), device="cuda")
    before = at.window_attn_bwd.launches
    got = at.window_attn_bwd(*_views(qkv), bias, m, do, scale=30 ** -0.5, out=_views(dqkv),
                             att_out=att.transpose(1, 2) if with_att else None)
    assert at.window_attn_bwd.launches == before + 1
    want = at._torch_attention_bwd(*_views(qkv), bias, m, do, 30 ** -0.5, with_att=True)
    for i, (x, y) in enumerate(zip(got, want[:4])):
        _close(x, y, 1e-4, 2e-5 if i < 3 else 1e-4)
    if with_att:
        _close(att.transpose(1, 2), want[4], 1e-5, 2e-5)
        _close(att.transpose(1, 2), at.window_attn_fwd(*_views(qkv), bias, m, scale=30 ** -0.5),
               1e-5, 2e-5)
    else:
        assert torch.isnan(att).all()


@pytest.mark.parametrize("n,hd,offset", [(64, 15, 0), (49, 30, 1), (16, 7, 1)])
@pytest.mark.parametrize("with_att", [False, True])
def test_window_attn_bwd_f32_odd_strides(gpu, n, hd, offset, with_att):
    """An odd head dim or views at an odd element offset cannot take 8-byte
    copies: the kernel goes element by element."""
    b_, nh = 30, 3
    size = b_ * nh * n * hd

    def view(s=1.0):
        return (_rnd(gpu, size + offset, s=s)[offset:]).view(b_, nh, n, hd)

    q, k, v, do = view(hd ** -0.5), view(), view(), view()
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    att = view() if with_att else None
    got = at.window_attn_bwd(q, k, v, bias, mask, do, scale=1.5, att_out=att)
    want = at._torch_attention_bwd(q, k, v, bias, mask, do, 1.5, with_att=True)
    for i, (x, y) in enumerate(zip(got, want[:4])):
        _close(x, y, 1e-4, 2e-5 if i < 3 else 1e-4)
    if with_att:
        _close(att, want[4], 1e-5, 2e-5)


@pytest.mark.parametrize("with_att", [False, True])
def test_window_attn_bwd_f32_repeats_bit_for_bit(gpu, with_att):
    """One FMA chain per output and dbias partials in a fixed order: two
    calls on the same inputs agree exactly."""
    qkv, do, bias, mask = _attn_trunk_case(gpu, 144)
    runs = []
    for _ in range(2):
        att = torch.empty(144, 64, 6, 30, device="cuda")
        res = at.window_attn_bwd(*_views(qkv), bias, mask, do, scale=30 ** -0.5,
                                 att_out=att.transpose(1, 2) if with_att else None)
        runs.append((*res, att) if with_att else res)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# f32 window_attn_fwd on the CUDA cores (the backward's register tiles, one
# head per block walking a group of windows, two cp.async stages)
@pytest.mark.parametrize("b_", [576, 288])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_f32_trunk_views(gpu, b_, masked):
    """The trunk's call at both graphs of the f32 step: q, k, v strided from
    the qkv buffer, the output into the (B_, N, nh, hd) buffer; it equals
    the f32 backward's att_out bit for bit (the same scores, softmax and
    P.V code)."""
    qkv, do, bias, mask = _attn_trunk_case(gpu, b_)
    m = mask if masked else None
    out = torch.full((b_, 64, 6, 30), float("nan"), device="cuda")
    before = at.window_attn_fwd.launches
    got = at.window_attn_fwd(*_views(qkv), bias, m, scale=30 ** -0.5, out=out.transpose(1, 2))
    assert at.window_attn_fwd.launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    _close(out.transpose(1, 2), at._torch_attention(*_views(qkv), bias, m, 30 ** -0.5), 1e-5,
           2e-5)
    att = torch.empty_like(out)
    at.window_attn_bwd(*_views(qkv), bias, m, do, scale=30 ** -0.5, att_out=att.transpose(1, 2))
    torch.cuda.synchronize()
    assert torch.equal(att, out)


@pytest.mark.parametrize("n,hd", [(64, 30), (49, 32), (16, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_f32_p_out(gpu, n, hd, masked):
    """p_out in f32 (the trunk's mode ``full`` in f32) beside the output."""
    b_, nh = 30, 3
    q, k, v = (_rnd(gpu, b_, nh, n, hd, s=hd ** -0.5), _rnd(gpu, b_, nh, n, hd),
               _rnd(gpu, b_, nh, n, hd))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    m = mask if masked else None
    p, p_want = (torch.full((b_, nh, n, n), float("nan"), device="cuda") for _ in range(2))
    got = at.window_attn_fwd(q, k, v, bias, m, scale=1.5, p_out=p)
    _close(got, at._torch_attention(q, k, v, bias, m, 1.5, p_want), 1e-5, 2e-5)
    _close(p, p_want, 1e-5, 2e-5)


@pytest.mark.parametrize("n,hd,offset", [(64, 15, 0), (49, 30, 1), (16, 7, 1)])
def test_window_attn_fwd_f32_odd_strides(gpu, n, hd, offset):
    """An odd head dim or views at an odd element offset cannot take 8-byte
    copies: the kernel goes element by element."""
    b_, nh = 30, 3
    size = b_ * nh * n * hd

    def view(s=1.0):
        return (_rnd(gpu, size + offset, s=s)[offset:]).view(b_, nh, n, hd)

    q, k, v, out = view(hd ** -0.5), view(), view(), view()
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    at.window_attn_fwd(q, k, v, bias, mask, scale=1.5, out=out)
    _close(out, at._torch_attention(q, k, v, bias, mask, 1.5), 1e-5, 2e-5)


@pytest.mark.parametrize("b_", [5, 995])
def test_window_attn_fwd_f32_window_counts(gpu, b_):
    """Fewer windows than groups, and a count the groups do not divide."""
    nh, n, hd = 3, 64, 30
    q, k, v = (_rnd(gpu, b_, nh, n, hd, s=hd ** -0.5), _rnd(gpu, b_, nh, n, hd),
               _rnd(gpu, b_, nh, n, hd))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = torch.from_numpy(shift_attn_mask(40, 8, 8, 4)).cuda()  # 5 windows
    _close(at.window_attn_fwd(q, k, v, bias, mask, scale=1.5),
           at._torch_attention(q, k, v, bias, mask, 1.5), 1e-5, 2e-5)


def test_window_attn_fwd_f32_repeats_bit_for_bit(gpu):
    qkv, _, bias, mask = _attn_trunk_case(gpu, 144)
    p = [torch.empty(144, 6, 64, 64, device="cuda") for _ in range(2)]
    runs = [at.window_attn_fwd(*_views(qkv), bias, mask, scale=30 ** -0.5, p_out=p[i])
            for i in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(p[0], p[1])


def test_window_attn_bwd_att_out_is_f32_only(gpu):
    q = _rnd(gpu, 4, 2, 16, 8).to(BF16)
    bias = _rnd(gpu, 2, 16, 16, s=0.1)
    with pytest.raises(ValueError, match="att_out"):
        at.window_attn_bwd(q, q, q, bias, None, q, att_out=torch.empty_like(q))


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
                                  "window_attn_fwd": d, "gemm_dgrad": 4 * d,
                                  "gemm_wgrad": 4 * d, "window_attn_bwd": d,
                                  "ln_rows_bwd": 2 * d}
    for a, b_ in zip(got, grads(st.trunk_reference)):
        _close(a, b_, 1e-4)


# -- bf16 instantiations and the save behaviours (the bf16 training recipe) ----


def _bf(g, *shape, s=1.0):
    return _rnd(g, *shape, s=s).to(BF16)


@pytest.mark.parametrize("c", [16, 180])
@pytest.mark.parametrize("shift", [None, 2])
def test_ln_rows_bf16(gpu, c, shift):
    x = _bf(gpu, 2, 8, 12, c)
    g, b = 1 + _rnd(gpu, c, s=0.1), _rnd(gpu, c, s=0.1)
    wm = None if shift is None else st.WindowMap(8, 12, 4, shift)
    inp = x if wm else x.view(-1, c)
    _close_bf16(st.ln_rows(inp, g, b, window=wm), st._torch_ln_rows(inp, g, b, wm))


_BF16_EPILOGUES = ["none", "gelu", "residual", "gelu_pair", "gelu_pair_f32"]


# bf16 runs on the tensor cores (mma.sync, cp.async): besides the step's
# widths, the kernel's edges: K or N of 17 or 33 (1-element copies), 8 and
# 64 (16-byte copies), M not a multiple of the 64-row tile, one valid 16x8
# mma tile, K of one 32-deep slice and of a partial one
@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (130, 360, 180),
                                   (20, 8, 8), (100, 17, 8), (1007, 8, 17), (333, 17, 17),
                                   (130, 33, 64), (65, 32, 64), (37, 180, 180), (1037, 360, 540)])
@pytest.mark.parametrize("epilogue", _BF16_EPILOGUES)
def test_gemm_bias_epilogue_bf16(gpu, m, k, n, epilogue):
    args, kw, gp_p = _gemm_case(gpu, m, k, n, epilogue, dtype=BF16)
    got = st.gemm_bias_epilogue(*args, **kw)
    _close_bf16(got, st._torch_gemm_bias_epilogue(*args, kw["res"], kw["dpm"], None, gp_p))
    if gp_p is not None:
        _close_bf16(kw["gp"], gp_p)


# the bf16 step's calls at the flagship widths, on both graphs (T = 16 or 8
# images of 48x48): (K, N, epilogue, window map); fc1 with the saved bf16
# gelu' (K5), the recompute's f32 gelu', and plain gelu (the no-grad forward)
_FWD_VARIANTS = {"qkv": (180, 540, "none", False), "proj": (180, 180, "residual", True),
                 "fc1_gelu": (180, 360, "gelu", False),
                 "fc1_gelu_pair": (180, 360, "gelu_pair", False),
                 "fc1_gelu_pair_f32": (180, 360, "gelu_pair_f32", False),
                 "fc2": (360, 180, "residual", False)}


@pytest.mark.parametrize("variant", list(_FWD_VARIANTS))
@pytest.mark.parametrize("images", [16, 8])
def test_gemm_bias_epilogue_mma_step_widths(gpu, variant, images):
    k, n, epilogue, windowed = _FWD_VARIANTS[variant]
    t = images * 48 * 48
    (a, w, b, epi), kw, gp_p = _gemm_case(gpu, t, k, n, epilogue, dtype=BF16)
    wm = st.WindowMap(48, 48, 8, 4) if windowed else None
    if epi == "residual":
        kw["res"] = _bf(gpu, images, 48, 48, n) if windowed else _bf(gpu, t, n)
        kw["dpm"] = (torch.rand(images, generator=gpu, device="cuda") < 0.9).float() / 0.9
    before = st.gemm_bias_epilogue.launches
    got = st.gemm_bias_epilogue(a, w, b, epi, window=wm, **kw)
    assert st.gemm_bias_epilogue.launches == before + 1
    _close_bf16(got, st._torch_gemm_bias_epilogue(a, w, b, epi, kw["res"], kw["dpm"], wm, gp_p))
    if gp_p is not None:
        _close_bf16(kw["gp"], gp_p)


@pytest.mark.parametrize("epilogue", _BF16_EPILOGUES)
def test_gemm_bias_epilogue_mma_unaligned_pointers(gpu, epilogue):
    """a, w, res and gp at odd element offsets (views into larger buffers)
    cannot take 8- or 16-byte copies: the kernel copies element by element."""
    args, kw, gp_p = _gemm_case(gpu, 300, 180, 180, epilogue, offset=1, dtype=BF16)
    assert args[0].data_ptr() % 4 != 0
    got = st.gemm_bias_epilogue(*args, **kw)
    _close_bf16(got, st._torch_gemm_bias_epilogue(*args, kw["res"], kw["dpm"], None, gp_p))
    if gp_p is not None:
        _close_bf16(kw["gp"], gp_p)


@pytest.mark.parametrize("epilogue", _BF16_EPILOGUES)
def test_gemm_bias_epilogue_mma_repeats_bit_for_bit(gpu, epilogue):
    """The mma order is fixed (no split-K, no atomics): two calls on the same
    inputs agree exactly, gp included."""
    args, kw, _ = _gemm_case(gpu, 4608, 180, 360, epilogue, dtype=BF16)
    first = st.gemm_bias_epilogue(*args, **kw)
    gp_first = None if kw["gp"] is None else kw["gp"].clone()
    second = st.gemm_bias_epilogue(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    if gp_first is not None:
        assert torch.equal(gp_first, kw["gp"])


@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_residual_window_store_bf16(gpu, shift):
    """proj's double rounding: round(a.w + b), then res + dpm * that in f32,
    rounded again, on the pixel the window map names."""
    wm = st.WindowMap(8, 12, 4, shift)
    a, w, b = _bf(gpu, 2 * 96, 24), _bf(gpu, 24, 16, s=0.1), _rnd(gpu, 16, s=0.1)
    res = _bf(gpu, 2, 8, 12, 16)
    dpm = torch.tensor([0.0, 1.25], device="cuda")
    got = st.gemm_bias_epilogue(a, w, b, "residual", res=res, dpm=dpm, window=wm)
    _close_bf16(got, st._torch_gemm_bias_epilogue(a, w, b, "residual", res, dpm, wm))


# the GELU epilogues in the form that is not their dtype's default
# (SEI_FAST_GELU): f32 with the polynomial, bf16 with the exact erf; the
# step's and the eval's widths, ragged and odd shapes, unaligned views
_OTHER_FORM_SHAPES = [(100, 20, 33), (4608, 180, 360), (1037, 360, 180), (65, 17, 36),
                      (300, 180, 180, 1)]


@pytest.mark.parametrize("shape", _OTHER_FORM_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype,epilogue", [
    (F32, "gelu"), (F32, "gelu_pair"), (BF16, "gelu"), (BF16, "gelu_pair"),
    (BF16, "gelu_pair_f32")])
def test_gemm_bias_epilogue_other_gelu_form(gpu, shape, dtype, epilogue):
    m, k, n, offset = (*shape, 0)[:4]
    fast = dtype == F32
    args, kw, gp_p = _gemm_case(gpu, m, k, n, epilogue, offset=offset, dtype=dtype)
    before = dict(st.gemm_bias_epilogue.gelu_launches)
    got = st.gemm_bias_epilogue(*args, **kw, fast_gelu=fast)
    form = "fast" if fast else "exact"
    assert st.gemm_bias_epilogue.gelu_launches[form] == before[form] + 1
    want = st._torch_gemm_bias_epilogue(*args, kw["res"], kw["dpm"], None, gp_p, fast)
    check = (lambda g, w_: _close(g, w_, 1e-4)) if dtype == F32 else _close_bf16
    check(got, want)
    gp = kw["gp"]
    gp_got = None if gp is None else gp.clone()
    if gp is not None:
        check(gp_got, gp_p)
    # the form reached the kernel: f32 values move (a bf16 output only where
    # a rounding flips, so at the large shape), and the repeat is bit for bit
    default = st.gemm_bias_epilogue(*args, **kw)
    torch.cuda.synchronize()
    if dtype == F32 or m * n > 10 ** 6:
        assert not torch.equal(got, default)
    if gp is not None and gp.dtype == F32:
        assert not torch.equal(gp_got, gp)
    again = st.gemm_bias_epilogue(*args, **kw, fast_gelu=fast)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and (gp is None or torch.equal(gp, gp_got))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("epilogue", ["gelu", "gelu_pair"])
def test_gemm_bias_epilogue_default_form_is_the_dtypes(gpu, dtype, epilogue, monkeypatch):
    """Without SEI_FAST_GELU, fast_gelu=None is the dtype's form (exact in
    f32, the polynomial in bf16), bit for bit; the env switches it."""
    monkeypatch.delenv("SEI_FAST_GELU", raising=False)
    args, kw, _ = _gemm_case(gpu, 4608, 180, 360, epilogue, dtype=dtype)
    default = st.gemm_bias_epilogue(*args, **kw).clone()
    assert torch.equal(default, st.gemm_bias_epilogue(*args, **kw, fast_gelu=dtype == BF16))
    monkeypatch.setenv("SEI_FAST_GELU", "0" if dtype == BF16 else "1")
    assert torch.equal(st.gemm_bias_epilogue(*args, **kw),
                       st.gemm_bias_epilogue(*args, **kw, fast_gelu=dtype != BF16))


@pytest.mark.parametrize("n,hd", [(16, 8), (64, 30)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_bf16_p_store(gpu, n, hd, masked):
    b_, nh, nw = 12, 3, 6
    q, k, v = (_bf(gpu, b_, nh, n, hd, s=hd ** -0.5), _bf(gpu, b_, nh, n, hd),
               _bf(gpu, b_, nh, n, hd))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((nw, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    m = mask if masked else None
    p, p_p = (torch.empty(b_, nh, n, n, device="cuda", dtype=BF16) for _ in range(2))
    before = at.window_attn_fwd.launches
    got = at.window_attn_fwd(q, k, v, bias, m, scale=1.5, p_out=p)
    assert at.window_attn_fwd.launches == before + 1
    _close_bf16(got, at._torch_attention(q, k, v, bias, m, 1.5, p_p))
    _close_bf16(p, p_p)


# bf16 window_attn_fwd on the tensor cores (mma.sync, 4 warps of 16 rows,
# p through a shared tile): the bf16 trunk's views at both graphs with the
# p store, p_out by each of its routes (16-byte rows, pairs, elements) at
# the kernel's edges, odd strides, window counts that its groups do not
# divide, its p against the backward's recompute (dv bit for bit), and two
# launches bit for bit
@pytest.mark.parametrize("b_", [576, 288])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_bf16_trunk_views(gpu, b_, masked):
    """The bf16 trunk's call: q, k, v strided from its (B_, N, 3, nh, hd)
    qkv buffer, the output into the (B_, N, nh, hd) att buffer, which keeps
    its NaN fill nowhere, and p saved; one launch."""
    qkv, _, bias, mask = _attn_trunk_case(gpu, b_)
    qkv = qkv.to(BF16)
    m = mask if masked else None
    att = torch.full((b_, 64, 6, 30), float("nan"), device="cuda", dtype=BF16)
    p, p_p = (torch.full((b_, 6, 64, 64), float("nan"), device="cuda", dtype=BF16)
              for _ in range(2))
    before = at.window_attn_fwd.launches
    at.window_attn_fwd(*_views(qkv), bias, m, scale=30 ** -0.5, out=att.transpose(1, 2), p_out=p)
    assert at.window_attn_fwd.launches == before + 1
    _close_bf16(att.transpose(1, 2), at._torch_attention(*_views(qkv), bias, m, 30 ** -0.5, p_p))
    _close_bf16(p, p_p)
    assert not torch.isnan(att).any()


@pytest.mark.parametrize("n,hd", [(64, 30), (64, 32), (64, 8), (49, 30), (49, 17), (36, 30),
                                  (16, 8)])
@pytest.mark.parametrize("p_offset", [0, 2, 1, None])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_bf16_edges(gpu, n, hd, p_offset, masked):
    """N < 64, narrow and odd head dims, and p_out at element offset 0
    (16-byte rows where N % 8 == 0), 2 (bf16 pairs where N is even), 1 (one
    element) or absent; nothing written around p_out."""
    b_, nh = 30, 3
    q, k, v = (_bf(gpu, b_, nh, n, hd, s=s) for s in (hd ** -0.5, 1, 1))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    m = mask if masked else None
    size = b_ * nh * n * n
    buf = torch.full((size + 16,), float("nan"), device="cuda", dtype=BF16)
    p = None if p_offset is None else buf[p_offset:p_offset + size].view(b_, nh, n, n)
    p_p = torch.empty(b_, nh, n, n, device="cuda", dtype=BF16)
    got = at.window_attn_fwd(q, k, v, bias, m, scale=1.5, p_out=p)
    _close_bf16(got, at._torch_attention(q, k, v, bias, m, 1.5, p_p))
    if p is not None:
        _close_bf16(p, p_p)
        assert torch.isnan(buf[:p_offset]).all() and torch.isnan(buf[p_offset + size:]).all()


@pytest.mark.parametrize("n,hd,offset", [(64, 30, 1), (64, 15, 0), (49, 17, 1), (16, 7, 1)])
def test_window_attn_fwd_bf16_odd_strides(gpu, n, hd, offset):
    """An odd head dim or views at an odd element offset cannot take bf16
    pairs: the kernel copies and stores element by element."""
    b_, nh = 30, 3
    size = b_ * nh * n * hd

    def view(s=1.0):
        return (_bf(gpu, size + offset, s=s)[offset:]).view(b_, nh, n, hd)

    q, k, v, out = view(hd ** -0.5), view(), view(), view()
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    p, p_p = (torch.empty(b_, nh, n, n, device="cuda", dtype=BF16) for _ in range(2))
    got = at.window_attn_fwd(q, k, v, bias, mask, scale=1.5, out=out, p_out=p)
    _close_bf16(got, at._torch_attention(q, k, v, bias, mask, 1.5, p_p))
    _close_bf16(p, p_p)


@pytest.mark.parametrize("b_", [1, 7, 600])
def test_window_attn_fwd_bf16_window_counts(gpu, b_):
    """Fewer windows than groups, and counts the groups do not divide."""
    q, k, v = (_bf(gpu, b_, 6, 64, 30, s=s) for s in (30 ** -0.5, 1, 1))
    bias = _rnd(gpu, 6, 64, 64, s=0.1)
    p, p_p = (torch.empty(b_, 6, 64, 64, device="cuda", dtype=BF16) for _ in range(2))
    got = at.window_attn_fwd(q, k, v, bias, None, p_out=p)
    _close_bf16(got, at._torch_attention(q, k, v, bias, None, 1.0, p_p))
    _close_bf16(p, p_p)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attn_fwd_bf16_p_is_the_bwd_recompute(gpu, masked):
    """The forward's p and the backward's recompute of it come from the same
    scores and softmax (window_attn_bf16.cuh): dv from the recompute form
    equals dv from the saved-p form fed the forward's p_out, bit for bit."""
    qkv, do, bias, mask = _attn_trunk_case(gpu, 288)
    qkv, do = qkv.to(BF16), do.to(BF16)
    m = mask if masked else None
    p = torch.empty(288, 6, 64, 64, device="cuda", dtype=BF16)
    at.window_attn_fwd(*_views(qkv), bias, m, scale=30 ** -0.5, p_out=p)
    dv_saved = at.window_attn_bwd(*_views(qkv), bias, m, do, scale=30 ** -0.5, p=p)[2]
    dv_recompute = at.window_attn_bwd(*_views(qkv), bias, m, do, scale=30 ** -0.5)[2]
    torch.cuda.synchronize()
    assert torch.equal(dv_saved, dv_recompute)


def test_window_attn_fwd_bf16_repeats_bit_for_bit(gpu):
    qkv, _, bias, mask = _attn_trunk_case(gpu, 144)
    qkv = qkv.to(BF16)
    ps = [torch.empty(144, 6, 64, 64, device="cuda", dtype=BF16) for _ in range(2)]
    outs = [at.window_attn_fwd(*_views(qkv), bias, mask, scale=30 ** -0.5, p_out=p) for p in ps]
    torch.cuda.synchronize()
    assert torch.equal(*outs) and torch.equal(*ps)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("saved", [False, True])
def test_window_attn_bwd_saved_p(gpu, dtype, saved):
    """The backward reading the forward's saved p (K7) and, in bf16, the
    recompute form (p rounded for dv, f32 for ds)."""
    n, hd, b_, nh, nw = 64, 30, 60, 3, 6
    q, k, v, do = (_rnd(gpu, b_, nh, n, hd, s=s).to(dtype) for s in (hd ** -0.5, 1, 1, 1))
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((nw, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    p = None
    if saved:
        p = torch.empty(b_, nh, n, n, device="cuda", dtype=dtype)
        at.window_attn_fwd(q, k, v, bias, mask, scale=1.5, p_out=p)
    got = at.window_attn_bwd(q, k, v, bias, mask, do, scale=1.5, p=p)
    want = at._torch_attention_bwd(q, k, v, bias, mask, do, 1.5, p)
    for x, y in zip(got, want):
        (_close_bf16 if dtype == BF16 else lambda a, b_: _close(a, b_, 1e-4))(x, y)


# bf16 window_attn_bwd on the tensor cores (mma.sync, 4 warps of 16 rows,
# two cp.async stages): both forms at the kernel's edges (N < 64: p's rows
# not 16-byte pieces at N = 49; hd 8, 17, 30, 32; both masks), odd strides
# (the one-element path), the bf16 trunk's views at both graphs, and two
# launches bit for bit
def _bf16_attn_case(g, b_, n, hd, nh=3, nw=6):
    q, k, v, do = (_bf(g, b_, nh, n, hd, s=s) for s in (hd ** -0.5, 1, 1, 1))
    bias = _rnd(g, nh, n, n, s=0.1)
    mask = (torch.rand((nw, n, n), generator=g, device="cuda") > 0.8).float() * -100.0
    return q, k, v, do, bias, mask


def _saved_p(q, k, v, bias, mask, scale):
    p = torch.empty(*q.shape[:3], q.shape[2], device="cuda", dtype=BF16)
    at.window_attn_fwd(q, k, v, bias, mask, scale=scale, p_out=p)
    return p


@pytest.mark.parametrize("n,hd", [(64, 30), (64, 32), (64, 8), (49, 30), (49, 17), (16, 8)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("saved", [False, True])
def test_window_attn_bwd_bf16_edges(gpu, n, hd, masked, saved):
    q, k, v, do, bias, mask = _bf16_attn_case(gpu, 30, n, hd)
    m = mask if masked else None
    p = _saved_p(q, k, v, bias, m, 1.5) if saved else None
    before = at.window_attn_bwd.launches
    got = at.window_attn_bwd(q, k, v, bias, m, do, scale=1.5, p=p)
    assert at.window_attn_bwd.launches == before + 1
    for x, y in zip(got, at._torch_attention_bwd(q, k, v, bias, m, do, 1.5, p)):
        _close_bf16(x, y)


@pytest.mark.parametrize("n,hd,offset", [(64, 30, 1), (64, 15, 0), (49, 17, 1), (16, 7, 1)])
@pytest.mark.parametrize("saved", [False, True])
def test_window_attn_bwd_bf16_odd_strides(gpu, n, hd, offset, saved):
    """An odd head dim or views at an odd element offset cannot take bf16
    pairs: the kernel loads and stores element by element."""
    b_, nh = 30, 3
    size = b_ * nh * n * hd

    def view(s=1.0):
        return (_bf(gpu, size + offset, s=s)[offset:]).view(b_, nh, n, hd)

    q, k, v, do = view(hd ** -0.5), view(), view(), view()
    bias = _rnd(gpu, nh, n, n, s=0.1)
    mask = (torch.rand((6, n, n), generator=gpu, device="cuda") > 0.8).float() * -100.0
    p = _saved_p(q, k, v, bias, mask, 1.5) if saved else None
    dq, dk, dv = view(), view(), view()
    got = at.window_attn_bwd(q, k, v, bias, mask, do, scale=1.5, p=p, out=(dq, dk, dv))
    for x, y in zip(got, at._torch_attention_bwd(q, k, v, bias, mask, do, 1.5, p)):
        _close_bf16(x, y)


@pytest.mark.parametrize("b_", [576, 288])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("saved", [False, True])
def test_window_attn_bwd_bf16_trunk_views(gpu, b_, masked, saved):
    """The bf16 trunk's call at both graphs of the step: q, k, v strided
    from the (B_, N, 3, nh, hd) qkv buffer, do from the (B_, N, nh, hd)
    datt buffer, dq, dk, dv into a second qkv-shaped buffer, which keeps
    its NaN fill nowhere."""
    qkv, do, bias, mask = _attn_trunk_case(gpu, b_)
    qkv, do = qkv.to(BF16), do.to(BF16)
    m = mask if masked else None
    p = _saved_p(*_views(qkv), bias, m, 30 ** -0.5) if saved else None
    dqkv = torch.full_like(qkv, float("nan"))
    got = at.window_attn_bwd(*_views(qkv), bias, m, do, scale=30 ** -0.5, out=_views(dqkv), p=p)
    for x, y in zip(got, at._torch_attention_bwd(*_views(qkv), bias, m, do, 30 ** -0.5, p)):
        _close_bf16(x, y)
    assert not torch.isnan(dqkv).any()


@pytest.mark.parametrize("saved", [False, True])
def test_window_attn_bwd_bf16_repeats_bit_for_bit(gpu, saved):
    """Sums in a fixed order and dbias partials without atomics: two calls
    on the same inputs agree exactly."""
    qkv, do, bias, mask = _attn_trunk_case(gpu, 144)
    qkv, do = qkv.to(BF16), do.to(BF16)
    p = _saved_p(*_views(qkv), bias, mask, 30 ** -0.5) if saved else None
    runs = [at.window_attn_bwd(*_views(qkv), bias, mask, do, scale=30 ** -0.5, p=p)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# bf16 runs on the tensor cores (mma.sync; dy staged through registers, w
# copied by cp.async): besides the step's widths, the kernel's edges: K or N
# of 17 or 33 (1-element loads), 8 (one n8 tile), M not a multiple of the
# 64-row tile, N of one 32-deep slice and of a partial one
@pytest.mark.parametrize("m,k,n", [(100, 20, 33), (192, 180, 540), (130, 360, 180),
                                   (20, 8, 8), (100, 17, 8), (1007, 8, 17), (333, 17, 17),
                                   (65, 64, 32), (37, 180, 180), (1037, 360, 540)])
@pytest.mark.parametrize("dy_dtype,out_dtype,gp_dtype", [
    (BF16, F32, BF16),   # fc2: bf16 block gradient, saved bf16 gelu' -> f32 dh
    (BF16, F32, F32),    # fc2 in the bf16 recompute: f32 gelu'
    (F32, F32, None),    # fc1: f32 dh -> f32 dz
    (F32, BF16, None),   # proj: f32 residual gradient -> bf16 d(att)
    (BF16, BF16, None),  # qkv: bf16 dqkv -> bf16 da
])
def test_gemm_dgrad_bf16(gpu, m, k, n, dy_dtype, out_dtype, gp_dtype):
    dy, w = _rnd(gpu, m, n).to(dy_dtype), _bf(gpu, k, n, s=0.1)
    scale = torch.tensor([0.0, 1.25], device="cuda")[: 2 if m % 2 == 0 else 1]
    gp = None if gp_dtype is None else _rnd(gpu, m, k).to(gp_dtype)
    got = st.gemm_dgrad(dy, w, scale=scale, gp=gp, out_dtype=out_dtype)
    _close_bf16(got, st._torch_gemm_dgrad(dy, w, scale, None, gp, out_dtype))


@pytest.mark.parametrize("m,k,n", [
    (100, 20, 33), (4000, 360, 180),
    # the tensor-core kernel's edges: M below one 32-row slice with one valid
    # 16x8 mma tile; K or N of 17 (1-element loads); M not a multiple of the
    # slice; 4-element packs with M below two slices
    (20, 8, 8), (100, 17, 8), (1007, 8, 17), (333, 17, 17), (37, 180, 180), (1037, 360, 540),
])
@pytest.mark.parametrize("dy_dtype", [F32, BF16])
@pytest.mark.parametrize("db_rounded", [False, True])
def test_gemm_wgrad_bf16(gpu, m, k, n, dy_dtype, db_rounded):
    a, dy = _bf(gpu, m, k), _rnd(gpu, m, n).to(dy_dtype)
    scale = torch.tensor([0.5, 1.3], device="cuda")[: 2 if m % 2 == 0 else 1]
    got = st.gemm_wgrad(a, dy, scale=scale, db_rounded=db_rounded)
    want = st._torch_gemm_wgrad(a, dy, scale, None, db_rounded)
    for x, y in zip(got, want):
        _close(x, y, 1e-4 * max(1.0, m / 1000))


@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_bwd_window_gather_bf16(gpu, shift):
    wm = st.WindowMap(8, 12, 4, shift)
    dy = _rnd(gpu, 2, 8, 12, 16)  # the f32 residual gradient dx2
    a, w = _bf(gpu, 192, 24), _bf(gpu, 24, 16, s=0.1)
    scale = torch.tensor([0.0, 1.25], device="cuda")
    _close_bf16(st.gemm_dgrad(dy, w, scale=scale, window=wm),
                st._torch_gemm_dgrad(dy, w, scale, wm))
    for x, y in zip(st.gemm_wgrad(a, dy, scale=scale, window=wm, db_rounded=True),
                    st._torch_gemm_wgrad(a, dy, scale, wm, True)):
        _close(x, y, 1e-4)


# bf16 gemm_wgrad runs on the tensor cores (mma.sync, f32 accumulators): the
# bf16 step's four calls at the flagship widths on 2 images of 48x48 (T =
# 4608), (K, N, window map, drop-path scale); f32 outputs to 1e-3 + 1e-4 x
# |plain|, chip_smoke's gate (products of bf16 values are exact in f32; the
# sums run in another order)
_WGRAD_VARIANTS = {"fc2": (360, 180, False, True), "fc1": (180, 360, False, False),
                   "proj": (180, 180, True, True), "qkv": (180, 540, False, False)}


def _wgrad_case(g, variant, dy_dtype):
    k, n, windowed, scaled = _WGRAD_VARIANTS[variant]
    a = _bf(g, 2 * 48 * 48, k)
    wm = st.WindowMap(48, 48, 8, 4) if windowed else None
    dy = (_rnd(g, 2, 48, 48, n) if windowed else _rnd(g, 2 * 48 * 48, n)).to(dy_dtype)
    scale = torch.tensor([0.0, 1 / 0.9], device="cuda") if scaled else None
    return a, dy, scale, wm


@pytest.mark.parametrize("variant", list(_WGRAD_VARIANTS))
@pytest.mark.parametrize("dy_dtype", [F32, BF16])
@pytest.mark.parametrize("db_rounded", [False, True])
def test_gemm_wgrad_mma_step_widths(gpu, variant, dy_dtype, db_rounded):
    a, dy, scale, wm = _wgrad_case(gpu, variant, dy_dtype)
    before = st.gemm_wgrad.launches
    got = st.gemm_wgrad(a, dy, scale=scale, window=wm, db_rounded=db_rounded)
    assert st.gemm_wgrad.launches == before + 1
    for x, y in zip(got, st._torch_gemm_wgrad(a, dy, scale, wm, db_rounded)):
        _close(x, y, 1e-4, 1e-3)


def test_gemm_wgrad_mma_unaligned_pointers(gpu):
    """Operands at odd element offsets (views into a larger buffer) cannot
    take 8- or 16-byte packs: the kernel loads them element by element."""
    m, k, n = 300, 180, 180
    a = _bf(gpu, m * k + 1)[1:].view(m, k)
    dy = _rnd(gpu, m * n + 1)[1:].view(m, n)
    for x, y in zip(st.gemm_wgrad(a, dy), st._torch_gemm_wgrad(a, dy)):
        _close(x, y, 1e-4, 1e-3)


@pytest.mark.parametrize("db_rounded", [False, True])
def test_gemm_wgrad_mma_repeats_bit_for_bit(gpu, db_rounded):
    """The mma order and the bias sums' order are fixed: two calls on the
    same inputs agree exactly (what the captured step's bit-for-bit match
    with the eager step rests on)."""
    a, dy, scale, wm = _wgrad_case(gpu, "proj", F32)
    first = st.gemm_wgrad(a, dy, scale=scale, window=wm, db_rounded=db_rounded)
    second = st.gemm_wgrad(a, dy, scale=scale, window=wm, db_rounded=db_rounded)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# bf16 gemm_dgrad on the tensor cores: the bf16 step's four calls at the
# flagship widths on both graphs (T = 16 or 8 images of 48x48), (K, N, dy,
# out, gp, window map and drop-path scale); fc2 with the saved bf16 gelu'
# (K7) and with the recompute's f32 gelu'
_DGRAD_VARIANTS = {"fc2": (360, 180, BF16, F32, BF16, False),
                   "fc2_gp_f32": (360, 180, BF16, F32, F32, False),
                   "fc1": (180, 360, F32, F32, None, False),
                   "proj": (180, 180, F32, BF16, None, True),
                   "qkv": (180, 540, BF16, BF16, None, False)}


def _dgrad_case(g, variant, images):
    k, n, dy_dtype, out_dtype, gp_dtype, windowed = _DGRAD_VARIANTS[variant]
    t = images * 48 * 48
    wm = st.WindowMap(48, 48, 8, 4) if windowed else None
    dy = (_rnd(g, images, 48, 48, n) if windowed else _rnd(g, t, n)).to(dy_dtype)
    scale = ((torch.rand(images, generator=g, device="cuda") < 0.9).float() / 0.9
             if variant.startswith("fc2") or windowed else None)
    gp = None if gp_dtype is None else _rnd(g, t, k).to(gp_dtype)
    return (dy, _bf(g, k, n, s=0.05)), dict(scale=scale, window=wm, gp=gp, out_dtype=out_dtype)


@pytest.mark.parametrize("variant", list(_DGRAD_VARIANTS))
@pytest.mark.parametrize("images", [16, 8])
def test_gemm_dgrad_mma_step_widths(gpu, variant, images):
    (dy, w), kw = _dgrad_case(gpu, variant, images)
    before = st.gemm_dgrad.launches
    got = st.gemm_dgrad(dy, w, **kw)
    assert st.gemm_dgrad.launches == before + 1
    _close_bf16(got, st._torch_gemm_dgrad(dy, w, kw["scale"], kw["window"], kw["gp"],
                                          kw["out_dtype"]))


@pytest.mark.parametrize("gp_dtype", [None, BF16, F32])
@pytest.mark.parametrize("out_dtype", [F32, BF16])
def test_gemm_dgrad_mma_unaligned_pointers(gpu, gp_dtype, out_dtype):
    """dy, w and gp at odd element offsets (views into larger buffers) cannot
    take 4-element packs or 8-byte copies: the kernel loads them element by
    element."""
    m, k, n = 300, 180, 180
    dy = _rnd(gpu, m * n + 1).to(BF16)[1:].view(m, n)
    w = _bf(gpu, k * n + 1, s=0.1)[1:].view(k, n)
    gp = None if gp_dtype is None else _rnd(gpu, m * k + 1).to(gp_dtype)[1:].view(m, k)
    assert dy.data_ptr() % 4 != 0
    got = st.gemm_dgrad(dy, w, gp=gp, out_dtype=out_dtype)
    _close_bf16(got, st._torch_gemm_dgrad(dy, w, None, None, gp, out_dtype))


@pytest.mark.parametrize("variant", ["fc2", "fc2_gp_f32", "proj"])
def test_gemm_dgrad_mma_repeats_bit_for_bit(gpu, variant):
    """The mma order is fixed (no split-K, no atomics): two calls on the same
    inputs agree exactly (what the captured step's bit-for-bit match with the
    eager step rests on)."""
    (dy, w), kw = _dgrad_case(gpu, variant, 2)
    first = st.gemm_dgrad(dy, w, **kw)
    second = st.gemm_dgrad(dy, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("c,shift", [(16, None), (180, 2)])
@pytest.mark.parametrize("form", ["ln2", "ln1"])
def test_ln_rows_bwd_bf16(gpu, c, shift, form):
    """LN2: f32 dz, bf16 residual gradient -> f32 dx2; LN1: bf16 da, f32
    residual gradient -> bf16 dx."""
    x = _bf(gpu, 3, 8, 12, c)
    g = 1 + _rnd(gpu, c, s=0.1)
    wm = None if shift is None else st.WindowMap(8, 12, 4, shift)
    inp = x if wm else x.view(-1, c)
    dz_dtype, res_dtype, out_dtype = (F32, BF16, F32) if form == "ln2" else (BF16, F32, BF16)
    dz, dres = _rnd(gpu, 288, c).to(dz_dtype), _rnd(gpu, *inp.shape).to(res_dtype)
    got = st.ln_rows_bwd(inp, g, dz, window=wm, dres=dres, out_dtype=out_dtype)
    want = st._torch_ln_rows_bwd(inp, g, dz, wm, dres, out_dtype)
    for a, b in zip(got, want):
        _close_bf16(a, b)


def _ln_bwd_bf16_case(g, b, h, w, c, shift, form, with_res=True):
    x = _bf(g, b, h, w, c)
    wm = None if shift is None else st.WindowMap(h, w, 4, shift)
    inp = x if wm else x.view(-1, c)
    dz_dtype, res_dtype, out_dtype = (F32, BF16, F32) if form == "ln2" else (BF16, F32, BF16)
    dz = _rnd(g, b * h * w, c).to(dz_dtype)
    dres = _rnd(g, *inp.shape).to(res_dtype) if with_res else None
    return (inp, 1 + _rnd(g, c, s=0.1), dz), dict(window=wm, dres=dres, out_dtype=out_dtype)


def _ln_bwd_ticket():
    import ctypes

    from sei_tpu_torch.ops import _build

    value = ctypes.c_uint(1)
    assert _build.library().lib.sei_ln_rows_bwd_bf16_ticket(
        torch.cuda.current_device(), ctypes.addressof(value)) == 0
    return value.value


@pytest.mark.parametrize("b,h,w,c,shift", [(1, 1, 3, 180, None), (1, 4, 4, 4, 0),
                                           (1, 4, 8, 12, 2), (2, 8, 12, 256, 2),
                                           (3, 16, 16, 180, None), (8, 48, 48, 180, 2)])
@pytest.mark.parametrize("form", ["ln2", "ln1"])
@pytest.mark.parametrize("with_res", [False, True])
def test_ln_rows_bwd_bf16_edges(gpu, b, h, w, c, shift, form, with_res):
    """The bf16 kernel at fewer rows than a warp holds, C = 4, 12, 180 and
    256, the window map at shift 0 and > 0, with and without the residual
    gradient, and the flagship 2B graph; one launch each, and the completion
    ticket back at 0 after it."""
    args, kw = _ln_bwd_bf16_case(gpu, b, h, w, c, shift, form, with_res)
    before = st.ln_rows_bwd.launches
    got = st.ln_rows_bwd(*args, **kw)
    assert st.ln_rows_bwd.launches == before + 1
    want = st._torch_ln_rows_bwd(*args, kw["window"], kw["dres"], kw["out_dtype"])
    for a, b_ in zip(got, want):
        if b_.dtype == F32 and a.numel() == c:  # dgamma, dbeta: sums over up to 18432 rows
            _close(a, b_, 1e-4, 1e-3)
        else:
            _close_bf16(a, b_)
    assert _ln_bwd_ticket() == 0


@pytest.mark.parametrize("form", ["ln2", "ln1"])
def test_ln_rows_bwd_bf16_repeats_bit_for_bit(gpu, form):
    """dgamma and dbeta are summed in a fixed order (no atomics): two calls
    on the flagship 2B graph's inputs give the same bits."""
    args, kw = _ln_bwd_bf16_case(gpu, 16, 48, 48, 180, 2 if form == "ln1" else None, form)
    first = st.ln_rows_bwd(*args, **kw)
    second = st.ln_rows_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ln_rows_bwd_bf16_refuses_odd_widths_and_unaligned_views(gpu):
    args, kw = _ln_bwd_bf16_case(gpu, 1, 4, 4, 18, None, "ln2")
    with pytest.raises(ValueError, match="C % 4 == 0"):
        st.ln_rows_bwd(*args, **kw)
    x, gamma, dz = _ln_bwd_bf16_case(gpu, 1, 4, 4, 16, None, "ln2")[0]
    shifted = torch.empty(x.numel() + 1, device="cuda", dtype=BF16)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        st.ln_rows_bwd(shifted, gamma, dz, out_dtype=F32)


def test_kernels_refuse_other_dtypes(gpu):
    x = _rnd(gpu, 4, 16).half()
    with pytest.raises(ValueError, match="x must be"):
        st.ln_rows(x, torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"))
    a, w = _bf(gpu, 8, 16), _rnd(gpu, 16, 8)
    with pytest.raises(ValueError, match="a must be"):
        st.gemm_bias_epilogue(a, w, torch.zeros(8, device="cuda"))


def _trunk_case(g, dtype):
    d, b, h, w, c, nh, ws = 2, 2, 8, 12, 24, 3, 4
    n = ws * ws
    s = 0.1
    shapes = {"ln1_s": (c,), "ln1_b": (c,), "qkv_w": (c, 3 * c), "qkv_b": (3 * c,),
              "proj_w": (c, c), "proj_b": (c,), "ln2_s": (c,), "ln2_b": (c,),
              "fc1_w": (c, 2 * c), "fc1_b": (2 * c,), "fc2_w": (2 * c, c), "fc2_b": (c,)}
    params = {k: (1.0 if k.startswith("ln") and k.endswith("_s") else 0.0)
              + _rnd(g, d, *shp, s=s) for k, shp in shapes.items()}
    rpb = _rnd(g, d, nh, n, n, s=s)
    mask = torch.from_numpy(shift_attn_mask(h, w, ws, ws // 2)).cuda()
    dpm = torch.tensor([[[1.0, 0.5], [0.0, 1.25]], [[1.25, 1.0], [1.0, 0.0]]], device="cuda")
    x, tgt = _rnd(g, b, h, w, c).to(dtype), _rnd(g, b, h, w, c)
    return dict(params=params, rpb=rpb, mask=mask, dpm=dpm, x=x, tgt=tgt, nh=nh, ws=ws, d=d)


def test_trunk_chain_bf16_matches_reference(gpu):
    k = _trunk_case(gpu, BF16)
    args = (k["x"], k["params"], k["rpb"], k["mask"], k["dpm"])
    got = st.swin_trunk(*args, num_heads=k["nh"], window_size=k["ws"])
    want = st.trunk_reference(*args, num_heads=k["nh"], window_size=k["ws"])
    assert got.dtype == BF16
    _close_bf16(got, want)


@pytest.mark.parametrize("dtype,saves", [(BF16, None), (BF16, False), (F32, True)])
def test_trunk_grads_saves_match_reference(gpu, dtype, saves):
    """The saved-tensor backward (K5/K7: bf16 by default, f32 when asked)
    and the bf16 recompute backward against autograd through the plain
    trunk, with the launch counts of each mode."""
    k = _trunk_case(gpu, dtype)
    d = k["d"]

    def grads(fn, **kw):
        leaves = [k["x"], k["rpb"], *k["params"].values()]
        leaves = [t.clone().requires_grad_() for t in leaves]
        p = dict(zip(k["params"], leaves[2:]))
        y = fn(leaves[0], p, leaves[1], k["mask"], k["dpm"], num_heads=k["nh"],
               window_size=k["ws"], **kw)
        return torch.autograd.grad(((y.float() - k["tgt"]) ** 2).mean(), leaves)

    st.reset_launch_counts()
    got = grads(st.swin_trunk, saves=saves)
    full = saves if saves is not None else dtype == BF16
    # the f32 recompute backward gets att from the attention backward
    assert st.launch_counts() == {"ln_rows": 4 * d, "gemm_bias_epilogue": (5 if full else 6) * d,
                                  "window_attn_fwd": (1 if full or dtype == F32 else 2) * d,
                                  "gemm_dgrad": 4 * d, "gemm_wgrad": 4 * d,
                                  "window_attn_bwd": d, "ln_rows_bwd": 2 * d}
    for a, b_ in zip(got, grads(st.trunk_reference)):
        assert a.dtype == b_.dtype
        a, b_ = a.float(), b_.float()
        if dtype == F32:
            _close(a, b_, 1e-4)
        else:
            scale = float(b_.abs().max().clamp_min(1e-6))
            _close(a / scale, b_ / scale, 0.0, 3e-2)


# -- launch-overhead probes (K8, K9) -------------------------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("blocks", [1, 4, 8, 24, 132, 1056])
@pytest.mark.parametrize("shape", [(8, 48, 48, 180), (3, 5, 7, 11)])
def test_copy_probe(gpu, dtype, blocks, shape):
    x = (_rnd(gpu, *shape) * 8).to(dtype)
    for add in (True, False):
        got = lp.copy_probe(x, blocks=blocks, add=add)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, lp._torch_copy_probe(x, add))


# 16-byte accesses: x at each element offset from a 16-byte boundary (the
# scalar head), counts that leave a tail, fewer elements than one pack
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("blocks", [1, 132])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("n", [1, 6, 9, 1001, 40963])
def test_copy_probe_offsets_and_ragged_counts(gpu, dtype, blocks, offset, n):
    buf = (_rnd(gpu, n + 16) * 8).to(dtype)
    x = buf[offset:offset + n]
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    for add in (True, False):
        got = lp.copy_probe(x, blocks=blocks, add=add)
        torch.cuda.synchronize()
        assert got.data_ptr() % 16 == x.data_ptr() % 16
        assert got.dtype == dtype and torch.equal(got, lp._torch_copy_probe(x, add))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("variant,flags", [
    ("v_e", None), ("v_a", dict()), ("v_b", dict(outputs=True)),
    ("v_d", dict(outputs=True, body=True)), ("v_g", dict(outputs=True, body=True, dpm_reads=True)),
    ("v_d_no_outputs", dict(body=True))])
def test_trunk_skeleton(gpu, dtype, variant, flags):
    d, b, h, w, c = 4, 3, 16, 8, 24
    x = (_rnd(gpu, b, h, w, c) * 8).to(dtype)
    params = {k: _rnd(gpu, d, c) for k in st.PARAM_LEAVES}
    rpb, mask = _rnd(gpu, d, 2, 16, 16), _rnd(gpu, 8, 16, 16)
    dpm = (torch.rand((d, 2, b), generator=gpu, device="cuda") < 0.7).float() / 0.7
    lp.reset_launch_counts()
    if flags is None:
        got, want = (lp.trunk_skeleton(x),), (lp._torch_trunk_skeleton(x, None, 0, False, False,
                                                                        False)[0],)
    else:
        got = lp.trunk_skeleton(x, params, rpb, mask, dpm, **flags)
        got = got if flags.get("outputs") else (got,)
        want = lp._torch_trunk_skeleton(x, dpm, d, flags.get("outputs", False),
                                        flags.get("body", False), flags.get("dpm_reads", False))
    torch.cuda.synchronize()
    assert lp.launch_counts()["trunk_skeleton"] == 1
    for g, w_ in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w_)


# -- the training step as one CUDA graph ---------------------------------------

TINY = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=4)
TINY_BLOCKS, TINY_CROP = 4, 16
PER_BLOCK_STEP = {F32: {"ln_rows": 4, "gemm_bias_epilogue": 6, "window_attn_fwd": 1,
                        "gemm_dgrad": 4, "gemm_wgrad": 4, "window_attn_bwd": 1, "ln_rows_bwd": 2},
                  BF16: {"ln_rows": 4, "gemm_bias_epilogue": 5, "window_attn_fwd": 1,
                         "gemm_dgrad": 4, "gemm_wgrad": 4, "window_attn_bwd": 1, "ln_rows_bwd": 2}}


def _tiny_trainer(dtype, *, scan_steps=1, capture=True, loss_fn=None, **kw):
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cuda")
    rng = np.random.default_rng(1)
    cache = build_device_cache([rng.random((3, 40, 44)).astype(np.float32) for _ in range(4)],
                               phys, seed=0)
    model = get_model(device="cuda", swinir_overrides=TINY,
                      dtype=None if dtype == F32 else dtype,
                      fused_trunk=kw.pop("fused_trunk", None))
    loss_fn = loss_fn or get_loss(method="proposed", physics=phys, crop_size=TINY_CROP)
    return Trainer(model, loss_fn, phys, cache, batch_size=2, epochs=1, crop_size=24,
                   scan_steps=scan_steps, capture=capture, **kw)


def _trained(tr):
    losses = []
    tr.train(log_every_epoch=False, on_step=lambda s, loss: losses.append(loss.item()))
    opt = [v for s in tr.opt.state.values() for v in s.values()]
    return losses, [*tr.model.module.parameters(), *opt, tr.step_t]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("scan_steps", [1, 2])
def test_captured_trainer_equals_eager(gpu, dtype, scan_steps):
    want_losses, want = _trained(_tiny_trainer(dtype, capture=False))
    tr = _tiny_trainer(dtype, scan_steps=scan_steps)
    losses, got = _trained(tr)
    assert tr.graphed and tr.scan_steps == scan_steps and tr.replays == 2 // scan_steps
    assert tr.capture_launches == {k: v * TINY_BLOCKS * 2 * scan_steps
                                   for k, v in PER_BLOCK_STEP[dtype].items()}
    assert losses == want_losses
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


MODULE_PATH_STEP = {k: 0 for k in PER_BLOCK_STEP[F32]} | {"window_attn_fwd": 1,
                                                            "window_attn_bwd": 1}


@pytest.mark.parametrize("dtype,kw,per_block", [
    (BF16, {"fused_trunk": False}, MODULE_PATH_STEP),
    (F32, {"clip_norm": 1e-3}, PER_BLOCK_STEP[F32]),
    (BF16, {"clip_norm": 1e-3}, PER_BLOCK_STEP[BF16])], ids=["bf16_module_path", "f32_clip",
                                                             "bf16_clip"])
def test_captured_variants_equal_eager(gpu, dtype, kw, per_block):
    """The module path (the attention kernels only) and the global-norm clip
    inside the captured step: equal to the eager trainer bit for bit."""
    want_losses, want = _trained(_tiny_trainer(dtype, capture=False, **kw))
    tr = _tiny_trainer(dtype, scan_steps=2, **kw)
    losses, got = _trained(tr)
    assert tr.graphed and tr.replays == 1
    assert tr.capture_launches == {k: v * TINY_BLOCKS * 2 * 2 for k, v in per_block.items()}
    assert losses == want_losses
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    if "clip_norm" in kw:
        assert float(tr.grad_norm) > kw["clip_norm"]


def test_replays_draw_new_probes(gpu):
    probes = []
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cuda")
    base = get_loss(method="proposed", physics=phys, crop_size=TINY_CROP)

    def loss_fn(x, y, model, rng):
        b = sample_probe(rng.probe, torch.empty((2, 3, TINY_CROP, TINY_CROP), device="cuda"), 6)
        probes.append(b)
        return base(x, y, model, rng, LossDraws(probe=b))

    tr = _tiny_trainer(F32, scan_steps=2, loss_fn=loss_fn)
    tr.step()
    first = [p.clone() for p in probes[-2:]]  # the two captured inner steps
    tr.step()
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(probes[-2], first[0]) and not torch.equal(probes[-1], first[1])


def test_capture_raises_on_a_host_sync(gpu):
    phys = get_physics(task="deblurring", kernel="Gaussian_R2", noise_level=5, device="cuda")
    base = get_loss(method="proposed", physics=phys, crop_size=TINY_CROP)

    def syncing_loss(x, y, model, rng):
        loss = base(x, y, model, rng)
        return loss * 1.0 if float(loss) > -1e30 else loss  # reads the loss on the host

    tr = _tiny_trainer(F32, loss_fn=syncing_loss)
    with pytest.raises(RuntimeError):
        tr.step()
    assert tr.graphs == {} and tr.replays == 0
