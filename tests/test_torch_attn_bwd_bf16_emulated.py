"""The bf16 attention backward kernel's logic, tensor cores included, run on the CPU.

``sei_tpu_torch/ops/csrc/window_attn_bwd.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync``,
``ldmatrix_x4``, ``ldmatrix_x4_trans`` and ``mma_bf16_16816`` exchanges
between the 32 threads of a warp by the PTX fragment layouts, ``cp.async`` a
synchronous copy, dynamic shared memory filled with a word that is NaN as
f32 and as bf16).  The shared library is loaded with ``ctypes`` in a
subprocess and called through its C entry point ``sei_window_attn_bwd``
with ``is_bf16 = 1`` on seeded bf16 inputs; dq, dk, dv and every dbias
partial are held against the plain version ``_torch_attention_bwd``.

Tolerances: the emulated mma sums exact bf16 products in f32, as the plain
version's f32 products do, so the two differ only in the order of f32
sums, which moves a bf16 output by one rounding at most now and then.
Each bf16 output is held to ``chip_smoke.py``'s gate (|d| <= 1e-2 x (|plain|
+ max |plain|)), and at least 99% of its elements must equal the plain
version's bit for bit: a missed rounding (dS unrounded before dQ, p
unrounded before dV) moves far more of them.  Each dbias partial (one per
group, the sum over the group's windows g, g + groups, ...) to 1e-4.

Every tensor lies in a buffer of its own filled with a bf16 NaN, so a read
of an element the kernel should not read, or a write outside an output's
view, shows.  The cases cover both forms (p saved by the forward, p
recomputed from q, k, bias and mask), with and without a mask, N = 64, 49
(window 7: p's rows are not 16-byte pieces) and 16, hd = 30, 32, 8 and an
odd 15 (the one-element path), contiguous tensors, the trunk's strided
views of its (B_, N, 3, nh, hd) qkv buffer and (B_, N, nh, hd) proj buffer
(with and without padding between heads), views at an odd element offset
(the one-element path again), and window counts that ``groups`` does not
divide.  The library is built with the shipped block (4 warps, three
stages) and with the sweep's others (``-DSEI_ATTN_BWD_BF16_WARPS``,
``_STAGES``: one and two stages; 8 warps as two teams of 4, each on its
own window).
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
DBIAS_TOL = 1e-4
NH = 2
OUTS = ("dq", "dk", "dv")

# loads the library, builds each case's strided views in NaN buffers (bf16
# as uint16 bits), calls the entry point, and saves the outputs and how many
# elements outside the output views were written
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np
    from numpy.lib.stride_tricks import as_strided

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_window_attn_bwd
    fn.argtypes = [I, I, *[P] * 12, L, *[I] * 5, *[L] * 24, F, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    outs = {}

    def view(buf, lay, shape):  # lay = (offset, sw, sh, sn, size) in elements
        off, sw, sh, sn, _ = (int(x) for x in lay)
        return as_strided(buf[off:], shape=shape, strides=(sw * 2, sh * 2, sn * 2, 2))

    for name in sorted({k.split("/")[0] for k in inp.files}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        b_, nh, n, hd, groups = (int(x) for x in g("meta")[:5])
        scale = float(g("scale"))
        shape = (b_, nh, n, hd)
        bufs, views = {}, {}
        for t in ("q", "k", "v", "do", "dq", "dk", "dv"):
            lay = g(f"lay_{t}")
            bufs[t] = np.full(int(lay[4]), 0x7FC0, np.uint16)
            views[t] = view(bufs[t], lay, shape)
            if t in ("q", "k", "v", "do"):
                views[t][...] = g(t)
        bias = np.ascontiguousarray(g("bias"))
        mask = None if g("mask") is None else np.ascontiguousarray(g("mask"))
        p = None if g("p") is None else np.ascontiguousarray(g("p"))
        part = np.full((groups, nh, n, n), np.nan, np.float32)
        ptr = lambda t: None if t is None else t.ctypes.data
        vptr = lambda t: views[t].__array_interface__["data"][0]
        strides = []
        for t in ("q", "k", "v", "do", "dq", "dk", "dv", "q"):
            strides += [int(x) for x in g(f"lay_{t}")[1:4]]
        code = fn(0, 1, vptr("q"), vptr("k"), vptr("v"), ptr(bias), ptr(mask), ptr(p),
                  vptr("do"), vptr("dq"), vptr("dk"), vptr("dv"), None, ptr(part), b_, nh, n,
                  hd, 0 if mask is None else mask.shape[0], groups, *strides, scale, None)
        if code:
            sys.exit(f"{name}: sei_window_attn_bwd returned {code}")
        outs[f"{name}/dbias_part"] = part
        for t in ("dq", "dk", "dv"):
            outs[f"{name}/{t}"] = np.array(views[t])
            stray = bufs[t].copy()
            view(stray, g(f"lay_{t}"), shape)[...] = 0x7FC0
            outs[f"{name}/{t}_stray"] = np.array(np.count_nonzero(stray != 0x7FC0))
    np.savez(sys.argv[3], **outs)
""")

# name: (windows B_, N, hd, mask windows nW (0: none), groups, layout, saved p)
CASES = {
    "flagship_saved_mask_trunk": (6, 64, 30, 3, 4, "trunk", True),
    "flagship_saved_nomask_trunk": (5, 64, 30, 0, 2, "trunk", True),
    "flagship_saved_mask_contig": (4, 64, 30, 2, 3, "contig", True),
    "flagship_recompute_mask_trunk": (6, 64, 30, 2, 4, "trunk", False),
    "flagship_recompute_nomask_contig": (4, 64, 30, 0, 3, "contig", False),
    "hd32_saved_padded": (3, 64, 32, 0, 2, "padded", True),
    "ws7_saved_mask_padded": (6, 49, 30, 3, 4, "padded", True),
    "ws7_recompute_nomask": (3, 49, 30, 0, 2, "contig", False),
    "odd_hd15_saved_mask": (4, 49, 15, 2, 3, "trunk", True),
    "odd_hd15_recompute_mask": (3, 64, 15, 3, 2, "trunk", False),
    "odd_offset_saved": (3, 64, 30, 0, 2, "offset", True),
    "odd_offset_recompute_mask": (3, 64, 30, 3, 2, "offset", False),
    "tiny_n16_saved_mask": (5, 16, 8, 5, 5, "contig", True),
    "tiny_n16_recompute": (5, 16, 8, 0, 3, "trunk", False),
}
# warps x stages: the shipped build (three stages) gets every case; the
# sweep's others (one and two stages; two teams of four warps) a flagship
# of each form, a window-7, an odd and the tiny case each
BLOCKS = {"4x3": list(CASES),
          "4x1": ["flagship_saved_mask_trunk", "flagship_recompute_nomask_contig",
                  "ws7_saved_mask_padded", "odd_hd15_saved_mask", "tiny_n16_recompute"],
          "8x2": ["flagship_saved_nomask_trunk", "flagship_recompute_mask_trunk",
                  "ws7_recompute_nomask", "odd_offset_saved", "tiny_n16_saved_mask"],
          "8x1": ["flagship_saved_mask_contig", "odd_offset_recompute_mask",
                  "ws7_saved_mask_padded", "tiny_n16_saved_mask"],
          "4x2": ["flagship_saved_mask_trunk", "flagship_recompute_mask_trunk",
                  "ws7_saved_mask_padded", "odd_offset_saved", "tiny_n16_saved_mask"]}


def _layouts(b_, n, hd, layout):
    """Each tensor's (offset, window, head, token strides, buffer size) in
    elements: the trunk's qkv buffer (B_, N, 3, nh, hd) for q, k, v and dq,
    dk, dv, its proj buffer (B_, N, nh, hd) for do; ``padded`` puts 2 unused
    elements after each head; ``offset`` starts contiguous tensors one
    element into their buffers."""
    lays = {}
    for t in ("q", "k", "v", "do", "dq", "dk", "dv"):
        if layout in ("contig", "offset"):
            off = int(layout == "offset")
            lays[t] = (off, NH * n * hd, n * hd, hd, off + b_ * NH * n * hd + 8)
        else:
            hs = hd + 2 * (layout == "padded")
            slots = 1 if t == "do" else 3
            slot = 0 if slots == 1 else "qkv".index(t[-1])
            lays[t] = (slot * NH * hs, n * slots * NH * hs, hs, slots * NH * hs,
                       b_ * n * slots * NH * hs)
    return {f"lay_{t}": np.array(v, np.int64) for t, v in lays.items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _inputs(name):
    """The case's bf16 tensors (as bits), f32 bias and mask, and its saved p
    (the forward's softmax rounded to bf16)."""
    b_, n, hd, nw, groups, layout, saved = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    t = {k: torch.from_numpy(rng.standard_normal((b_, NH, n, hd)).astype(f))
         for k in ("q", "k", "v")}
    t["do"] = torch.from_numpy((0.5 * rng.standard_normal((b_, NH, n, hd))).astype(f))
    arrs = {k: _bits(v) for k, v in t.items()}
    arrs["bias"] = (0.1 * rng.standard_normal((NH, n, n))).astype(f)
    if nw:
        arrs["mask"] = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(f)
    arrs["scale"] = np.array(hd ** -0.5, f)
    if saved:
        m = torch.from_numpy(arrs["mask"]) if nw else None
        p = at._probs(_bf16(arrs["q"]), _bf16(arrs["k"]), torch.from_numpy(arrs["bias"]), m,
                      float(arrs["scale"]))
        arrs["p"] = _bits(p)
    arrs["meta"] = np.array([b_, NH, n, hd, groups], np.int64)
    arrs.update(_layouts(b_, n, hd, layout))
    return arrs


def _plain(name, arrs):
    """dq, dk, dv of the plain version, and its dbias summed over each
    group's windows (the partial the kernel's blocks of that group write)."""
    b_, _, _, nw, groups, _, _ = CASES[name]
    t = {k: _bf16(arrs[k]) for k in ("q", "k", "v", "do", "p") if k in arrs}
    bias = torch.from_numpy(arrs["bias"])
    mask = torch.from_numpy(arrs["mask"]) if nw else None
    scale = float(arrs["scale"])
    dq, dk, dv, _ = at._torch_attention_bwd(t["q"], t["k"], t["v"], bias, mask, t["do"], scale,
                                            t.get("p"))
    parts = []
    for grp in range(groups):
        idx = torch.arange(grp, b_, groups)
        sub = {k: v[idx] for k, v in t.items()}
        m = None if mask is None else mask[idx % nw]
        parts.append(at._torch_attention_bwd(sub["q"], sub["k"], sub["v"], bias, m, sub["do"],
                                             scale, sub.get("p"))[3])
    return {"dq": dq, "dk": dk, "dv": dv, "dbias_part": torch.stack(parts).numpy()}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """block -> the emulated kernel's outputs for that block's cases."""
    root = tmp_path_factory.mktemp("attn_bwd_bf16_emu")
    libs = emu.build(root, "window_attn_bwd.cu", {
        blk: [f"SEI_ATTN_BWD_BF16_{k}={v}" for k, v in zip(("WARPS", "STAGES"), blk.split("x"))]
        for blk in BLOCKS})

    def run(blk):
        return emu.run(root, RUNNER, libs[blk], {f"{name}/{key}": v for name in BLOCKS[blk]
                                                 for key, v in _inputs(name).items()})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per block, side by side
        return dict(zip(libs, pool.map(run, libs)))


@pytest.mark.parametrize("block,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_bf16_attn_bwd_matches_plain(emulated, block, name):
    got = emulated[block]
    want = _plain(name, _inputs(name))
    for t in OUTS:
        assert int(got[f"{name}/{t}_stray"]) == 0, f"{t}: written outside its view"
        g, w = _bf16(got[f"{name}/{t}"]).float(), want[t].float()
        assert torch.isfinite(g).all(), f"{t}: non-finite output"
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * float(w.abs().max()), err_msg=t)
        exact = float((g == w).float().mean())
        assert exact >= EXACT_SHARE, f"{t}: only {exact:.4f} of the elements equal the plain bits"
    np.testing.assert_allclose(got[f"{name}/dbias_part"], want["dbias_part"], rtol=DBIAS_TOL,
                               atol=DBIAS_TOL, err_msg="dbias partials")
