"""The f32 attention forward kernel's logic, run on the CPU.

``sei_tpu_torch/ops/csrc/window_attn_fwd.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp, ``cp.async`` a synchronous copy,
dynamic shared memory NaN-filled at launch).  The shared library is loaded
with ``ctypes`` in a subprocess and called through its C entry point
``sei_window_attn_fwd`` on seeded inputs; the output and the saved
probabilities are held against the plain version ``_torch_attention`` at
``chip_smoke.py``'s tolerance, 2e-5 abs / 1e-5 rel.

Every tensor lies in a NaN-filled buffer of its own (bias and mask too), so
a read of an element the kernel should not read, or a write outside the
output's view or ``p_out``, shows.  The cases cover N = 64, 49 (window 7)
and 16, hd = 30, narrower and an odd 15, no mask and a shift-like mask,
contiguous tensors, the trunk's strided views of its (B_, N, 3, nh, hd) qkv
buffer and the (B_, N, nh, hd) output (with and without padding between
heads, and an odd hd whose strides are even), views at an odd element
offset (the one-element path), window counts that ``groups`` does not
divide (one group walking every window, and more groups than windows), and
``p_out`` on and off.  The library is built
with the shipped block (256 threads, 2 blocks per SM, 2 stages, P.V on
half the threads) and with each of the tile sweep's others
(``-DSEI_ATTN_FWD_F32_THREADS``, ``_MINB``, ``_STAGES``, ``_PV``).
"""

import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import attention as at

from . import cuda_emulation as emu

ATOL, RTOL = 2e-5, 1e-5
NH = 2
PAD = 5  # NaN elements before and after bias, mask and p_out

# loads the library, builds each case's strided views in NaN buffers, calls
# the entry point, and saves the outputs and whether anything outside the
# output views was written
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
        return as_strided(buf[off:], shape=shape, strides=(sw * 4, sh * 4, sn * 4, 4))

    def padded(a):  # a copy of a in the middle of a NaN buffer
        buf = np.full(a.size + 2 * pad, np.nan, np.float32)
        buf[pad:pad + a.size] = a.ravel()
        return buf

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        b_, nh, n, hd, groups, with_p = (int(x) for x in g("meta"))
        shape = (b_, nh, n, hd)
        bufs, views = {}, {}
        for t in ("q", "k", "v", "out"):
            lay = g(f"lay_{t}")
            bufs[t] = np.full(int(lay[4]), np.nan, np.float32)
            views[t] = view(bufs[t], lay, shape)
            if t != "out":
                views[t][...] = g(t)
        bias = padded(g("bias"))
        mask = None if g("mask") is None else padded(g("mask"))
        p_buf = np.full(b_ * nh * n * n + 2 * pad, np.nan, np.float32) if with_p else None
        at_pad = lambda b: None if b is None else b[pad:].ctypes.data
        vptr = lambda t: views[t].__array_interface__["data"][0]
        strides = [int(x) for t in ("q", "k", "v", "out") for x in g(f"lay_{t}")[1:4]]
        code = fn(0, 0, vptr("q"), vptr("k"), vptr("v"), at_pad(bias), at_pad(mask),
                  vptr("out"), at_pad(p_buf), b_, nh, n, hd,
                  0 if mask is None else g("mask").shape[0], groups, *strides,
                  float(g("scale")), None)
        if code:
            sys.exit(f"{name}: sei_window_attn_fwd returned {code}")
        outs[f"{name}/out"] = np.array(views["out"])
        stray = bufs["out"].copy()
        view(stray, g("lay_out"), shape)[...] = np.nan
        outs[f"{name}/out_stray"] = np.array(np.count_nonzero(~np.isnan(stray)))
        if with_p:
            outs[f"{name}/p"] = p_buf[pad:-pad].reshape(b_, nh, n, n).copy()
            edges = np.concatenate([p_buf[:pad], p_buf[-pad:]])
            outs[f"{name}/p_stray"] = np.array(np.count_nonzero(~np.isnan(edges)))
    np.savez(sys.argv[3], **outs)
""")

# name: (windows B_, N, hd, mask windows nW (0: none), groups, p_out, layout)
CASES = {
    "flagship_mask_trunk_p": (6, 64, 30, 3, 4, True, "trunk"),
    "flagship_nomask_trunk": (5, 64, 30, 0, 2, False, "trunk"),
    "flagship_nomask_contig_p": (4, 64, 30, 0, 3, True, "contig"),
    "flagship_mask_padded": (6, 64, 30, 2, 4, False, "padded"),
    "ws7_mask_p": (6, 49, 30, 3, 4, True, "padded"),
    "ws7_nomask": (3, 49, 30, 0, 2, False, "contig"),
    "narrow_hd8_mask": (4, 64, 8, 2, 3, False, "trunk"),
    "odd_hd15_mask_p": (4, 49, 15, 2, 3, True, "trunk"),
    "odd_hd15_even_strides_p": (4, 64, 15, 2, 3, True, "padded1"),
    "odd_offset_p": (3, 64, 30, 0, 2, True, "offset"),
    "odd_offset_mask": (5, 49, 30, 5, 3, False, "offset"),
    "one_group_mask": (3, 64, 30, 3, 1, False, "trunk"),
    "groups_over_windows_p": (2, 64, 30, 2, 3, True, "trunk"),
    "tiny_n16": (5, 16, 8, 5, 5, True, "contig"),
}
# (threads, blocks per SM, stages, P.V threads): the shipped block gets every
# case; the sweep's others a flagship, a window-7, an odd, a walk and the
# tiny case each
SHIPPED = (256, 2, 2, 128)
BLOCKS = {SHIPPED: list(CASES),
          (256, 2, 2, 256): ["flagship_mask_trunk_p", "ws7_nomask", "odd_hd15_mask_p",
                             "one_group_mask", "tiny_n16"],
          (256, 2, 1, 128): ["flagship_mask_trunk_p", "ws7_mask_p", "odd_offset_p",
                             "one_group_mask", "tiny_n16"],
          (256, 3, 2, 128): ["flagship_nomask_trunk", "ws7_nomask", "odd_hd15_even_strides_p",
                             "one_group_mask", "tiny_n16"],
          (256, 3, 1, 128): ["flagship_mask_padded", "ws7_mask_p", "odd_offset_mask",
                             "groups_over_windows_p", "tiny_n16"],
          (128, 4, 1, 64): ["flagship_nomask_contig_p", "ws7_mask_p", "odd_offset_mask",
                            "groups_over_windows_p", "tiny_n16"],
          (128, 4, 1, 128): ["flagship_mask_trunk_p", "ws7_nomask", "odd_hd15_mask_p",
                             "one_group_mask", "tiny_n16"]}


def _label(blk):
    return "x".join(map(str, blk))


def _layouts(b_, n, hd, layout):
    """Each tensor's (offset, window, head, token strides, buffer size) in
    elements: the trunk's qkv buffer (B_, N, 3, nh, hd) for q, k, v, its
    (B_, N, nh, hd) buffer for out; ``padded`` puts 2 unused elements after
    each head, ``padded1`` one (an odd hd with even strides); ``offset``
    starts contiguous tensors one element into their buffers."""
    lays = {}
    for t in ("q", "k", "v", "out"):
        if layout in ("contig", "offset"):
            off = int(layout == "offset")
            lays[t] = (off, NH * n * hd, n * hd, hd, off + b_ * NH * n * hd + 8)
        else:
            hs = hd + {"padded": 2, "padded1": 1}.get(layout, 0)
            slots = 1 if t == "out" else 3
            slot = 0 if slots == 1 else "qkv".index(t)
            lays[t] = (slot * NH * hs, n * slots * NH * hs, hs, slots * NH * hs,
                       b_ * n * slots * NH * hs)
    return {f"lay_{t}": np.array(v, np.int64) for t, v in lays.items()}


def _inputs(name):
    b_, n, hd, nw, groups, with_p, layout = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    arrs = {t: rng.standard_normal((b_, NH, n, hd)).astype(f) for t in ("q", "k", "v")}
    arrs["bias"] = (0.1 * rng.standard_normal((NH, n, n))).astype(f)
    if nw:
        arrs["mask"] = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(f)
    arrs["scale"] = np.array(hd ** -0.5, f)
    arrs["meta"] = np.array([b_, NH, n, hd, groups, int(with_p)], np.int64)
    arrs.update(_layouts(b_, n, hd, layout))
    return arrs


def _plain(arrs):
    t = {k: torch.from_numpy(v) for k, v in arrs.items() if k in ("q", "k", "v", "bias", "mask")}
    p = torch.empty(t["q"].shape[:3] + (t["q"].shape[2],))
    out = at._torch_attention(t["q"], t["k"], t["v"], t["bias"], t.get("mask"),
                              float(arrs["scale"]), p)
    return {"out": out.numpy(), "p": p.numpy()}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """block -> the emulated kernel's outputs for that block's cases."""
    root = tmp_path_factory.mktemp("attn_fwd_f32_emu")
    libs = emu.build(root, "window_attn_fwd.cu", {
        _label(blk): [] if blk == SHIPPED else [
            f"SEI_ATTN_FWD_F32_{k}={v}" for k, v in zip(("THREADS", "MINB", "STAGES", "PV"), blk)]
        for blk in BLOCKS})

    def run(blk):
        inputs = {f"{name}/{key}": v for name in BLOCKS[blk] for key, v in _inputs(name).items()}
        return emu.run(root, RUNNER, libs[_label(blk)], {**inputs, "pad": np.array(PAD)})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per block, side by side
        return dict(zip(BLOCKS, pool.map(run, BLOCKS)))


@pytest.mark.parametrize("block,name", [(b, n) for b, names in BLOCKS.items() for n in names],
                         ids=lambda x: _label(x) if isinstance(x, tuple) else x)
def test_emulated_f32_attn_fwd_matches_plain(emulated, block, name):
    got = emulated[block]
    want = _plain(_inputs(name))
    assert int(got[f"{name}/out_stray"]) == 0, "out: written outside its view"
    np.testing.assert_allclose(got[f"{name}/out"], want["out"], rtol=RTOL, atol=ATOL,
                               err_msg="out")
    if CASES[name][5]:
        assert int(got[f"{name}/p_stray"]) == 0, "p_out: written outside it"
        np.testing.assert_allclose(got[f"{name}/p"], want["p"], rtol=RTOL, atol=ATOL,
                                   err_msg="p_out")
    else:
        assert f"{name}/p" not in got
