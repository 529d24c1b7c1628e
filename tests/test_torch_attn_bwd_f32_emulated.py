"""The f32 attention backward kernel's logic, run on the CPU.

``sei_tpu_torch/ops/csrc/window_attn_bwd.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp, ``cp.async`` a synchronous copy,
dynamic shared memory NaN-filled at launch).  The shared library is loaded
with ``ctypes`` in a subprocess and called through its C entry point
``sei_window_attn_bwd`` on seeded inputs; dq, dk, dv, the dbias partials
(summed over groups, as the wrapper sums them) and att are held against the
plain version ``_torch_attention_bwd`` at ``chip_smoke.py``'s tolerances:
dq, dk, dv 2e-5 abs / 1e-4 rel, dbias 1e-4, att 2e-5 / 1e-5.

Every tensor lies in a NaN-filled buffer of its own, so a read of an
element the kernel should not read, or a write outside an output's view,
shows.  The cases cover N = 64 and 49 (window 7) and 16, hd = 30 and
narrower (and an odd 15), no mask and a shift-like mask, contiguous
tensors, the trunk's strided views of its (B_, N, 3, nh, hd) qkv buffer and
(B_, N, nh, hd) proj buffer (with and without padding between heads), views
at an odd element offset (the one-element path), window counts that
``groups`` does not divide, att on and off, and a saved f32 p.  The library
is built with the shipped block (256 threads, 2 blocks per SM) and with the
tile sweep's others (``-DSEI_ATTN_BWD_F32_THREADS``, ``_MINB``).
"""

import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import attention as at

from . import cuda_emulation as emu

TOL = {"dq": (2e-5, 1e-4), "dk": (2e-5, 1e-4), "dv": (2e-5, 1e-4), "dbias": (1e-4, 1e-4),
       "att": (2e-5, 1e-5)}
NH = 2
OUTS = ("dq", "dk", "dv", "att")

# loads the library, builds each case's strided views in NaN buffers, calls
# the entry point, and saves the outputs and whether anything outside the
# output views was written
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
        return as_strided(buf[off:], shape=shape, strides=(sw * 4, sh * 4, sn * 4, 4))

    for name in sorted({k.split("/")[0] for k in inp.files}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        b_, nh, n, hd, groups, with_att = (int(x) for x in g("meta")[:6])
        scale = float(g("scale"))
        shape = (b_, nh, n, hd)
        bufs, views = {}, {}
        for t in ("q", "k", "v", "do", *[o for o in ("dq", "dk", "dv", "att")
                                         if o != "att" or with_att]):
            lay = g(f"lay_{t}")
            bufs[t] = np.full(int(lay[4]), np.nan, np.float32)
            views[t] = view(bufs[t], lay, shape)
            if t in ("q", "k", "v", "do"):
                views[t][...] = g(t)
        bias = np.ascontiguousarray(g("bias"))
        mask = None if g("mask") is None else np.ascontiguousarray(g("mask"))
        p = None if g("p") is None else np.ascontiguousarray(g("p"))
        part = np.full((groups, nh, n, n), np.nan, np.float32)
        ptr = lambda t: None if t is None else t.ctypes.data
        vptr = lambda t: views[t].__array_interface__["data"][0] if t in views else None
        strides = []
        for t in ("q", "k", "v", "do", "dq", "dk", "dv", "att" if with_att else "q"):
            strides += [int(x) for x in g(f"lay_{t}")[1:4]]
        code = fn(0, 0, vptr("q"), vptr("k"), vptr("v"), ptr(bias), ptr(mask), ptr(p),
                  vptr("do"), vptr("dq"), vptr("dk"), vptr("dv"), vptr("att"), ptr(part), b_,
                  nh, n, hd, 0 if mask is None else mask.shape[0], groups, *strides, scale, None)
        if code:
            sys.exit(f"{name}: sei_window_attn_bwd returned {code}")
        outs[f"{name}/dbias_part"] = part
        for t in ("dq", "dk", "dv", "att"):
            if t not in views:
                continue
            outs[f"{name}/{t}"] = np.array(views[t])
            stray = bufs[t].copy()
            view(stray, g(f"lay_{t}"), shape)[...] = np.nan
            outs[f"{name}/{t}_stray"] = np.array(np.count_nonzero(~np.isnan(stray)))
    np.savez(sys.argv[3], **outs)
""")

# name: (windows B_, N, hd, mask windows nW (0: none), groups, att, layout, saved p)
CASES = {
    "flagship_mask_trunk_att": (6, 64, 30, 3, 4, True, "trunk", False),
    "flagship_nomask_trunk_att": (5, 64, 30, 0, 2, True, "trunk", False),
    "flagship_nomask_contig": (4, 64, 30, 0, 3, False, "contig", False),
    "flagship_mask_padded": (6, 64, 30, 2, 4, False, "padded", False),
    "ws7_mask_att": (6, 49, 30, 3, 4, True, "padded", False),
    "ws7_nomask": (3, 49, 30, 0, 2, False, "contig", False),
    "narrow_hd8_mask_att": (4, 64, 8, 2, 3, True, "trunk", False),
    "odd_hd15_mask_att": (4, 49, 15, 2, 3, True, "trunk", False),
    "odd_offset_att": (3, 64, 30, 0, 2, True, "offset", False),
    "saved_p_mask": (4, 64, 30, 2, 3, False, "trunk", True),
    "saved_p_att": (3, 64, 30, 0, 2, True, "contig", True),
    "tiny_n16": (5, 16, 8, 5, 5, True, "contig", False),
}
# the shipped block gets every case; the sweep's other two blocks a
# flagship, a window-7, an odd, a saved-p and the tiny case each
BLOCKS = {"256x2": list(CASES),
          "256x1": ["flagship_mask_trunk_att", "ws7_mask_att", "odd_offset_att",
                    "saved_p_mask", "tiny_n16"],
          "128x2": ["flagship_nomask_trunk_att", "ws7_nomask", "odd_hd15_mask_att",
                    "saved_p_att", "tiny_n16"]}


def _layouts(b_, n, hd, layout, with_att):
    """Each tensor's (offset, window, head, token strides, buffer size) in
    elements: the trunk's qkv buffer (B_, N, 3, nh, hd) for q, k, v and dq,
    dk, dv, its proj buffer (B_, N, nh, hd) for do and att; ``padded`` puts 2
    unused elements after each head; ``offset`` starts contiguous tensors
    one element into their buffers."""
    lays = {}
    for t in ("q", "k", "v", "do", "dq", "dk", "dv", "att"):
        if layout in ("contig", "offset"):
            off = int(layout == "offset")
            lays[t] = (off, NH * n * hd, n * hd, hd, off + b_ * NH * n * hd + 8)
        else:
            hs = hd + 2 * (layout == "padded")
            slots = 1 if t in ("do", "att") else 3
            slot = 0 if slots == 1 else "qkv".index(t[-1])
            lays[t] = (slot * NH * hs, n * slots * NH * hs, hs, slots * NH * hs,
                       b_ * n * slots * NH * hs)
    if not with_att:
        del lays["att"]
    return {f"lay_{t}": np.array(v, np.int64) for t, v in lays.items()}


def _inputs(name):
    b_, n, hd, nw, groups, with_att, layout, saved = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    arrs = {t: rng.standard_normal((b_, NH, n, hd)).astype(f) for t in ("q", "k", "v")}
    arrs["do"] = (0.5 * rng.standard_normal((b_, NH, n, hd))).astype(f)
    arrs["bias"] = (0.1 * rng.standard_normal((NH, n, n))).astype(f)
    if nw:
        arrs["mask"] = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(f)
    arrs["scale"] = np.array(hd ** -0.5, f)
    if saved:
        t = {k: torch.from_numpy(arrs[k]) for k in ("q", "k", "bias")}
        m = torch.from_numpy(arrs["mask"]) if nw else None
        arrs["p"] = at._probs(t["q"], t["k"], t["bias"], m, float(arrs["scale"])).numpy()
    arrs["meta"] = np.array([b_, NH, n, hd, groups, int(with_att)], np.int64)
    arrs.update(_layouts(b_, n, hd, layout, with_att))
    return arrs


def _plain(name, arrs):
    t = {k: torch.from_numpy(v) for k, v in arrs.items() if k in ("q", "k", "v", "do", "bias",
                                                                    "mask", "p")}
    res = at._torch_attention_bwd(t["q"], t["k"], t["v"], t["bias"], t.get("mask"), t["do"],
                                  float(arrs["scale"]), t.get("p"), with_att=True)
    return dict(zip(("dq", "dk", "dv", "dbias", "att"), (r.numpy() for r in res)))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """block -> the emulated kernel's outputs for that block's cases."""
    root = tmp_path_factory.mktemp("attn_bwd_f32_emu")
    libs = emu.build(root, "window_attn_bwd.cu", {
        blk: [f"SEI_ATTN_BWD_F32_{k}={v}" for k, v in zip(("THREADS", "MINB"), blk.split("x"))]
        for blk in BLOCKS})
    def run(blk):
        return emu.run(root, RUNNER, libs[blk], {f"{name}/{key}": v for name in BLOCKS[blk]
                                                 for key, v in _inputs(name).items()})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per block, side by side
        return dict(zip(libs, pool.map(run, libs)))


@pytest.mark.parametrize("block,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_f32_attn_bwd_matches_plain(emulated, block, name):
    got = emulated[block]
    want = _plain(name, _inputs(name))
    with_att = CASES[name][5]
    for t in OUTS:
        if t == "att" and not with_att:
            assert f"{name}/att" not in got
            continue
        assert int(got[f"{name}/{t}_stray"]) == 0, f"{t}: written outside its view"
        np.testing.assert_allclose(got[f"{name}/{t}"], want[t], rtol=TOL[t][1], atol=TOL[t][0],
                                   err_msg=t)
    dbias = got[f"{name}/dbias_part"].sum(0)
    np.testing.assert_allclose(dbias, want["dbias"], rtol=TOL["dbias"][1],
                               atol=TOL["dbias"][0], err_msg="dbias")
