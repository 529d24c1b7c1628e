"""The bf16 attention forward kernel's logic, tensor cores included, run on the CPU.

``sei_tpu_torch/ops/csrc/window_attn_fwd.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync``,
``__syncwarp``, ``ldmatrix_x4``, ``ldmatrix_x4_trans`` and
``mma_bf16_16816`` exchanges between the 32 threads of a warp by the PTX
fragment layouts, ``cp.async`` a synchronous copy, dynamic shared memory
filled with a word that is NaN as f32 and as bf16).  The shared library is
loaded with ``ctypes`` in a subprocess and called through its C entry point
``sei_window_attn_fwd`` with ``is_bf16 = 1`` on seeded bf16 inputs; the
output and the saved probabilities ``p_out`` are held against the plain
version ``_torch_attention``.

Tolerances: the emulated mma sums exact bf16 products in f32, as the plain
version's f32 products do, so the two differ only in the order of f32 sums
(and in ``expf`` against torch's exp), which moves a bf16 value by one
rounding now and then.  Each output is held to ``chip_smoke.py``'s gate
(|d| <= 1e-2 x (|plain| + max |plain|)), and at least 99% of its elements
must equal the plain version's bits: a missed rounding (p unrounded before
P.V) moves far more of them.

Every tensor lies in a buffer of its own filled with NaN (bf16 for q, k, v,
the output and p_out; f32 for bias and mask), so a read of an element the
kernel should not read, or a write outside the output's view or p_out,
shows.  The cases cover no mask and a mask, p_out on and off by each of its
routes (16-byte rows through the shared p tile: N a multiple of 8 and p_out
16-byte aligned; bf16 pairs: N even, p_out 4-byte aligned; one element: N
odd or p_out at an odd element), N = 64, 49 (window 7), 36 and 16, hd = 30,
32, 8 and an odd 15 (the one-element copies), contiguous tensors, the
trunk's strided views of its (B_, N, 3, nh, hd) qkv buffer and (B_, N, nh,
hd) output (with and without padding between heads), views at an odd
element offset, and window counts that ``groups`` does not divide (one
group walking every window, more groups than windows).  The library is
built as shipped (two stages, p through the shared tile, the mask loaded
after the scores) and with the sweep's other kernels
(``-DSEI_ATTN_FWD_BF16_STAGES``, ``_PTILE``, ``_MASK_EARLY``; the blocks
per SM a build is compiled for change no logic).

Last, the forward's p against the bf16 backward's (``window_attn_bwd.cu``,
emulated the same way): dv from the backward's recompute form (p = None)
must equal, bit for bit, dv from its saved-p form fed the forward's
``p_out``, since both kernels take p from ``window_attn_bf16.cuh``.
"""

import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import attention as at

from . import cuda_emulation as emu

BF16_RTOL = 1e-2  # chip_smoke.py's gate on bf16 outputs
EXACT_SHARE = 0.99  # of each bf16 output's elements equal to the plain version's bits
NH = 2
PAD = 16  # NaN elements before and after bias, mask and p_out
# p_out's byte address mod 16 for each route it can take
P_ALIGN = {"tile": 0, "pairs": 4, "one": 2}

# loads the library, builds each case's strided views in NaN buffers (bf16
# as uint16 bits), calls the entry point, and saves the outputs and how many
# elements outside the output's view and p_out were written
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np
    from numpy.lib.stride_tricks import as_strided

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_window_attn_fwd
    fn.argtypes = [I, I, *[P] * 7, L, *[I] * 5, *[L] * 12, F, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    pad = int(inp["pad"])
    outs = {}

    def view(buf, lay, shape):  # lay = (offset, sw, sh, sn, size) in elements
        off, sw, sh, sn, _ = (int(x) for x in lay)
        return as_strided(buf[off:], shape=shape, strides=(sw * 2, sh * 2, sn * 2, 2))

    def padded(a):  # a copy of a (f32) in the middle of a NaN buffer
        buf = np.full(a.size + 2 * pad, np.nan, np.float32)
        buf[pad:pad + a.size] = a.ravel()
        return buf

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        b_, nh, n, hd, groups, p_mod = (int(x) for x in g("meta"))
        shape = (b_, nh, n, hd)
        bufs, views = {}, {}
        for t in ("q", "k", "v", "out"):
            lay = g(f"lay_{t}")
            bufs[t] = np.full(int(lay[4]), 0x7FC0, np.uint16)
            views[t] = view(bufs[t], lay, shape)
            if t != "out":
                views[t][...] = g(t)
        bias = padded(g("bias"))
        mask = None if g("mask") is None else padded(g("mask"))
        p_buf, p_at = None, None
        if p_mod >= 0:  # p_out at the first element past pad whose address is p_mod mod 16
            size = b_ * nh * n * n
            p_buf = np.full(size + 3 * pad, 0x7FC0, np.uint16)
            p_at = next(i for i in range(pad, 2 * pad) if (p_buf.ctypes.data + 2 * i) % 16 == p_mod)
        at_pad = lambda b: None if b is None else b[pad:].ctypes.data
        vptr = lambda t: views[t].__array_interface__["data"][0]
        strides = [int(x) for t in ("q", "k", "v", "out") for x in g(f"lay_{t}")[1:4]]
        code = fn(0, 1, vptr("q"), vptr("k"), vptr("v"), at_pad(bias), at_pad(mask),
                  vptr("out"), None if p_buf is None else p_buf[p_at:].ctypes.data, b_, nh, n,
                  hd, 0 if mask is None else g("mask").shape[0], groups, *strides,
                  float(g("scale")), None)
        if code:
            sys.exit(f"{name}: sei_window_attn_fwd returned {code}")
        outs[f"{name}/out"] = np.array(views["out"])
        stray = bufs["out"].copy()
        view(stray, g("lay_out"), shape)[...] = 0x7FC0
        outs[f"{name}/out_stray"] = np.array(np.count_nonzero(stray != 0x7FC0))
        if p_buf is not None:
            size = b_ * nh * n * n
            outs[f"{name}/p"] = p_buf[p_at:p_at + size].reshape(b_, nh, n, n).copy()
            edges = np.concatenate([p_buf[:p_at], p_buf[p_at + size:]])
            outs[f"{name}/p_stray"] = np.array(np.count_nonzero(edges != 0x7FC0))
    np.savez(sys.argv[3], **outs)
""")

# name: (windows B_, N, hd, mask windows nW (0: none), groups, layout, p_out route or None)
CASES = {
    "flagship_mask_trunk_ptile": (6, 64, 30, 3, 4, "trunk", "tile"),
    "flagship_nomask_trunk_ptile": (5, 64, 30, 0, 2, "trunk", "tile"),
    "flagship_mask_contig_ppairs": (4, 64, 30, 2, 3, "contig", "pairs"),
    "flagship_nomask_contig": (4, 64, 30, 0, 3, "contig", None),
    "flagship_mask_trunk": (6, 64, 30, 3, 4, "trunk", None),
    "hd32_padded_ptile": (3, 64, 32, 0, 2, "padded", "tile"),
    "hd8_mask_trunk_ptile": (4, 64, 8, 2, 3, "trunk", "tile"),
    "ws7_mask_padded_pone": (6, 49, 30, 3, 4, "padded", "one"),
    "ws7_nomask_contig": (3, 49, 30, 0, 2, "contig", None),
    "ws6_mask_contig_ppairs": (4, 36, 30, 2, 3, "contig", "tile"),  # N % 8 != 0: pairs
    "odd_hd15_mask_trunk_ptile": (4, 64, 15, 2, 3, "trunk", "tile"),
    "odd_hd15_ws7_pone": (4, 49, 15, 2, 3, "trunk", "one"),
    "odd_offset_ppairs": (3, 64, 30, 0, 2, "offset", "pairs"),
    "odd_offset_mask_pone": (3, 64, 30, 3, 2, "offset", "one"),
    "one_group_mask_ptile": (3, 64, 30, 3, 1, "trunk", "tile"),
    "groups_over_windows_ptile": (2, 64, 30, 2, 3, "trunk", "tile"),
    "tiny_n16_mask_ptile": (5, 16, 8, 5, 5, "contig", "tile"),
    "tiny_n16_ppairs": (5, 16, 8, 0, 3, "trunk", "pairs"),
}
# stages, p route and mask load of the build: the shipped kernel (two
# stages, p through the shared tile, the mask loaded after the scores) gets
# every case; the sweep's others a flagship with and without p, a window-7,
# an odd, a walk and the tiny case each
SHIPPED = "s2_tile"
BUILDS = {"s2_tile": [],
          "s3_tile_early": ["SEI_ATTN_FWD_BF16_STAGES=3", "SEI_ATTN_FWD_BF16_MASK_EARLY=1"],
          "s1_tile": ["SEI_ATTN_FWD_BF16_STAGES=1"],
          "s3_pairs": ["SEI_ATTN_FWD_BF16_STAGES=3", "SEI_ATTN_FWD_BF16_PTILE=0"],
          "s2_pairs_early": ["SEI_ATTN_FWD_BF16_PTILE=0", "SEI_ATTN_FWD_BF16_MASK_EARLY=1"]}
BLOCKS = {"s2_tile": list(CASES),
          "s3_tile_early": ["flagship_mask_trunk_ptile", "flagship_nomask_contig",
                            "ws7_mask_padded_pone", "odd_hd15_mask_trunk_ptile",
                            "one_group_mask_ptile", "tiny_n16_mask_ptile"],
          "s1_tile": ["flagship_nomask_trunk_ptile", "flagship_mask_trunk", "ws7_nomask_contig",
                      "odd_offset_mask_pone", "groups_over_windows_ptile", "tiny_n16_ppairs"],
          "s3_pairs": ["flagship_mask_trunk_ptile", "hd32_padded_ptile", "ws6_mask_contig_ppairs",
                       "odd_offset_ppairs", "one_group_mask_ptile", "tiny_n16_mask_ptile"],
          "s2_pairs_early": ["flagship_nomask_trunk_ptile", "hd8_mask_trunk_ptile",
                             "ws7_mask_padded_pone", "odd_hd15_ws7_pone", "one_group_mask_ptile",
                             "tiny_n16_mask_ptile"]}


def _layouts(b_, n, hd, layout):
    """Each tensor's (offset, window, head, token strides, buffer size) in
    elements: the trunk's qkv buffer (B_, N, 3, nh, hd) for q, k, v, its
    (B_, N, nh, hd) buffer for out; ``padded`` puts 2 unused elements after
    each head; ``offset`` starts contiguous tensors one element into their
    buffers."""
    lays = {}
    for t in ("q", "k", "v", "out"):
        if layout in ("contig", "offset"):
            off = int(layout == "offset")
            lays[t] = (off, NH * n * hd, n * hd, hd, off + b_ * NH * n * hd + 8)
        else:
            hs = hd + 2 * (layout == "padded")
            slots = 1 if t == "out" else 3
            slot = 0 if slots == 1 else "qkv".index(t)
            lays[t] = (slot * NH * hs, n * slots * NH * hs, hs, slots * NH * hs,
                       b_ * n * slots * NH * hs)
    return {f"lay_{t}": np.array(v, np.int64) for t, v in lays.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _inputs(name):
    """The case's bf16 q, k, v (as bits; q pre-scaled as the trunk's is
    not: scale multiplies the scores), f32 bias and mask."""
    b_, n, hd, nw, groups, layout, route = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    arrs = {t: _bits(torch.from_numpy(rng.standard_normal((b_, NH, n, hd)).astype(f)))
            for t in ("q", "k", "v")}
    arrs["bias"] = (0.1 * rng.standard_normal((NH, n, n))).astype(f)
    if nw:
        arrs["mask"] = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(f)
    arrs["scale"] = np.array(hd ** -0.5, f)
    p_mod = -1 if route is None else P_ALIGN[route]
    arrs["meta"] = np.array([b_, NH, n, hd, groups, p_mod], np.int64)
    arrs.update(_layouts(b_, n, hd, layout))
    return arrs


def _plain(arrs):
    t = {k: _bf16(arrs[k]) for k in ("q", "k", "v")}
    mask = torch.from_numpy(arrs["mask"]) if "mask" in arrs else None
    p = torch.empty(t["q"].shape[:3] + (t["q"].shape[2],), dtype=torch.bfloat16)
    out = at._torch_attention(t["q"], t["k"], t["v"], torch.from_numpy(arrs["bias"]), mask,
                              float(arrs["scale"]), p)
    return {"out": out, "p": p}


def _emulate(root, build, names):
    return emu.run(root, RUNNER, build, {
        **{f"{name}/{key}": v for name in names for key, v in _inputs(name).items()},
        "pad": np.array(PAD)})


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    root = tmp_path_factory.mktemp("attn_fwd_bf16_emu")
    return root, emu.build(root, "window_attn_fwd.cu", BUILDS)


@pytest.fixture(scope="module")
def emulated(libs):
    """build -> the emulated kernel's outputs for that build's cases."""
    root, built = libs
    with ThreadPoolExecutor(len(built)) as pool:  # one subprocess per build, side by side
        return dict(zip(built, pool.map(lambda b: _emulate(root, built[b], BLOCKS[b]), built)))


def _hold(got, want, what):
    g, w = _bf16(got).float(), want.float()
    assert torch.isfinite(g).all(), f"{what}: non-finite output"
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(w.abs().max()), err_msg=what)
    exact = float((g == w).float().mean())
    assert exact >= EXACT_SHARE, f"{what}: only {exact:.4f} of the elements equal the plain bits"


@pytest.mark.parametrize("build,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_bf16_attn_fwd_matches_plain(emulated, build, name):
    got = emulated[build]
    want = _plain(_inputs(name))
    assert int(got[f"{name}/out_stray"]) == 0, "out: written outside its view"
    _hold(got[f"{name}/out"], want["out"], "out")
    if CASES[name][6] is None:
        assert f"{name}/p" not in got
        return
    assert int(got[f"{name}/p_stray"]) == 0, "p_out: written outside it"
    _hold(got[f"{name}/p"], want["p"], "p_out")


# the bf16 backward on the forward's p: dq, dk, dv (recompute form and
# saved-p form) into contiguous bf16 buffers, dbias partials discarded
BWD_RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_window_attn_bwd
    fn.argtypes = [I, I, *[P] * 12, L, *[I] * 5, *[L] * 24, F, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    outs = {}
    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        q, k, v, do = (np.ascontiguousarray(g(t)) for t in ("q", "k", "v", "do"))
        b_, nh, n, hd = q.shape
        bias = np.ascontiguousarray(g("bias"))
        mask = None if g("mask") is None else np.ascontiguousarray(g("mask"))
        ptr = lambda t: None if t is None else t.ctypes.data
        st = [nh * n * hd, n * hd, hd]
        for form, p in (("recompute", None), ("saved", np.ascontiguousarray(g("p")))):
            grads = [np.zeros_like(q) for _ in range(3)]
            part = np.zeros((2, nh, n, n), np.float32)
            code = fn(0, 1, ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(p), ptr(do),
                      *(ptr(t) for t in grads), None, ptr(part), b_, nh, n, hd,
                      0 if mask is None else mask.shape[0], 2, *(st * 8), float(g("scale")),
                      None)
            if code:
                sys.exit(f"{name}: sei_window_attn_bwd returned {code}")
            for t, x in zip(("dq", "dk", "dv"), grads):
                outs[f"{name}/{form}_{t}"] = x
    np.savez(sys.argv[3], **outs)
""")
# the forward's cases whose p_out goes to the backward (contiguous views)
P_CASES = ("flagship_mask_contig_ppairs", "ws6_mask_contig_ppairs", "tiny_n16_mask_ptile")


def test_emulated_bf16_fwd_p_is_the_bwd_recompute(libs, emulated):
    """dv = P^T dO with P the backward's recompute equals dv with P the
    forward's p_out, bit for bit (p from the same scores and softmax);
    dq and dk differ, since the recompute form takes dS from the unrounded p."""
    root, _ = libs
    bwd = emu.build(root, "window_attn_bwd.cu", {"bwd": []})["bwd"]
    rng = np.random.default_rng(15)
    inputs = {}
    for name in P_CASES:
        b_, n, hd = CASES[name][:3]
        arrs = _inputs(name)
        inputs.update({f"{name}/{k}": v for k, v in arrs.items()
                       if k in ("q", "k", "v", "bias", "mask", "scale")})
        inputs[f"{name}/do"] = _bits(torch.from_numpy(
            (0.5 * rng.standard_normal((b_, NH, n, hd))).astype(np.float32)))
        inputs[f"{name}/p"] = emulated[SHIPPED][f"{name}/p"]
    got = emu.run(root, BWD_RUNNER, bwd, inputs)
    for name in P_CASES:
        assert np.array_equal(got[f"{name}/recompute_dv"], got[f"{name}/saved_dv"]), name
