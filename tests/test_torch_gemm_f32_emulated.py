"""The f32 forward GEMM kernel's index logic, run on the CPU.

``sei_tpu_torch/ops/csrc/gemm_bias_epilogue.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``, ``__syncthreads`` a barrier, ``cp.async`` a
synchronous copy).  The shared library is loaded with ``ctypes`` in a
subprocess, called through its C entry point ``sei_gemm_bias_epilogue``
on seeded inputs, and its outputs are held against the plain version
``_torch_gemm_bias_epilogue`` at 1e-4 (abs and rel, as ``chip_smoke.py``).

The cases cover every epilogue (gelu_pair's f32 gelu' included), ragged M,
K and N (tails of the block tile and of the 20-deep slice), odd widths and a
view at an odd offset (the one-element path), and the window store with and
without shift; the library is built at the shipped tile and at other tiles
and slice depths of the tile sweep (``-DSEI_FWD_F32_BM``, ``_BN``, ``_BK``).
"""

import textwrap

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import swin_trunk as st

from . import cuda_emulation as emu

RTOL = ATOL = 1e-4
EPILOGUES = {"none": 0, "gelu": 1, "residual": 2, "gelu_pair": 3}

# loads the library, calls the entry point on each case of inputs.npz, saves
# the outputs (and gelu') to outputs.npz
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.sei_gemm_bias_epilogue
    fn.argtypes = [I, I, P, P, P, P, P, I, P, P, *[I] * 10, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    outs = {}

    def view(arr, offset):  # arr's values at `offset` elements into a larger buffer
        buf = np.zeros(arr.size + offset, np.float32)
        buf[offset:] = arr.ravel()
        return buf, buf[offset:].reshape(arr.shape)

    def p(a):
        return None if a is None else a.ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files}):
        g = lambda k: inp[f"{name}/{k}"]
        m, k, n, epi, rpi, windowed, h, w, ws, shift, offset = (int(v) for v in g("meta"))
        _, a = view(g("a"), offset)
        _, wt = view(g("w"), offset)
        _, out = view(np.full(m * n, np.nan, np.float32), offset)
        res = dpm = gp = None
        if epi == 2:
            _, res = view(g("res"), offset)
            dpm = np.ascontiguousarray(g("dpm"))
        if epi == 3:
            _, gp = view(np.full(m * n, np.nan, np.float32), offset)
        bias = np.ascontiguousarray(g("b"))
        code = fn(0, 0, p(a), p(wt), p(bias), p(out), p(gp), 0, p(res), p(dpm), m, k, n, epi,
                  rpi, windowed, h, w, ws, shift, None)
        if code:
            sys.exit(f"{name}: sei_gemm_bias_epilogue returned {code}")
        outs[f"{name}/out"] = out.copy()
        if gp is not None:
            outs[f"{name}/gp"] = gp.copy()
    np.savez(sys.argv[3], **outs)
""")

# (name, M, K, N, epilogue, window (H, W, ws, shift) or None, element offset)
CASES = [
    ("aligned_none", 130, 24, 100, "none", None, 0),
    ("aligned_gelu", 130, 24, 100, "gelu", None, 0),
    ("aligned_gelu_pair", 130, 24, 100, "gelu_pair", None, 0),
    ("aligned_residual", 130, 24, 100, "residual", None, 0),
    ("k_tail_none", 70, 28, 36, "none", None, 0),
    ("k_tail_gelu_pair", 70, 28, 36, "gelu_pair", None, 0),
    ("width180_residual", 200, 36, 180, "residual", None, 0),
    ("width180_gelu", 200, 36, 180, "gelu", None, 0),
    ("odd_none", 65, 17, 33, "none", None, 0),
    ("odd_gelu", 65, 17, 33, "gelu", None, 0),
    ("odd_gelu_pair", 65, 17, 33, "gelu_pair", None, 0),
    ("odd_residual", 66, 17, 33, "residual", None, 0),
    ("offset_gelu_pair", 90, 24, 40, "gelu_pair", None, 1),
    ("offset_residual", 90, 24, 40, "residual", None, 1),
    ("window_shift0", 192, 24, 20, "residual", (8, 12, 4, 0), 0),
    ("window_shift2", 192, 24, 20, "residual", (8, 12, 4, 2), 0),
    ("window_shift2_odd", 192, 13, 17, "residual", (8, 12, 4, 2), 0),
]
# the shipped tile gets every case; the other tiles of the sweep one aligned,
# one ragged and one windowed case each
TILES = {"128x96x20": [c[0] for c in CASES],
         "128x96x12": ["k_tail_none", "width180_residual", "odd_gelu", "window_shift2"],
         "64x96x12": ["aligned_residual", "odd_gelu_pair", "window_shift2"],
         "128x192x12": ["width180_residual", "odd_gelu_pair", "window_shift2"],
         "64x192x12": ["width180_gelu", "k_tail_gelu_pair", "window_shift2_odd"]}


def _inputs(case):
    name, m, k, n, epi, win, offset = case
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    arrs = {"a": rng.standard_normal((m, k)).astype(f),
            "w": (rng.standard_normal((k, n)) * 0.3).astype(f),
            "b": (rng.standard_normal(n) * 0.1).astype(f)}
    b_img, rpi = 1, 0
    if epi == "residual":
        b_img = 2 if m % 2 == 0 else 1
        rpi = m // b_img
        arrs["res"] = rng.standard_normal((m, n)).astype(f)
        arrs["dpm"] = np.array([0.5, 1.25][:b_img], f)
    h, w, ws, shift = win or (0, 0, 0, 0)
    if win:
        assert m == b_img * h * w
    arrs["meta"] = np.array([m, k, n, EPILOGUES[epi], rpi, int(win is not None), h, w, ws,
                             shift, offset], np.int64)
    return arrs


def _plain(case, arrs):
    name, m, k, n, epi, win, _ = case
    t = {key: torch.from_numpy(v) for key, v in arrs.items() if key != "meta"}
    wm = st.WindowMap(*win) if win else None
    res = t.get("res")
    if res is not None and wm is not None:
        res = res.view(-1, wm.h, wm.w, n)
    gp = torch.empty(m, n) if epi == "gelu_pair" else None
    out = st._torch_gemm_bias_epilogue(t["a"], t["w"], t["b"], epi, res, t.get("dpm"), wm, gp)
    return out.reshape(m, n).numpy(), None if gp is None else gp.numpy()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """tile -> the emulated kernel's outputs for that tile's cases."""
    root = tmp_path_factory.mktemp("gemm_f32_emu")
    libs = emu.build(root, "gemm_bias_epilogue.cu", {
        tile: [f"SEI_FWD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK"), tile.split("x"))]
        for tile in TILES})
    by_name = {c[0]: c for c in CASES}
    return {tile: emu.run(root, RUNNER, lib, {f"{name}/{key}": v for name in TILES[tile]
                                              for key, v in _inputs(by_name[name]).items()})
            for tile, lib in libs.items()}


@pytest.mark.parametrize("tile,name", [(t, n) for t, names in TILES.items() for n in names])
def test_emulated_f32_kernel_matches_plain(emulated, tile, name):
    case = next(c for c in CASES if c[0] == name)
    want, want_gp = _plain(case, _inputs(case))
    got = emulated[tile][f"{name}/out"].reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if want_gp is not None:
        np.testing.assert_allclose(emulated[tile][f"{name}/gp"].reshape(want.shape), want_gp,
                                   rtol=RTOL, atol=ATOL)
