"""The f32 data-grad kernel's index logic, run on the CPU.

``sei_tpu_torch/ops/csrc/gemm_bwd.cu`` is compiled as it is by the host's
``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier; the tensor-core kernels are
left out without ``__CUDACC__``).  The shared library is loaded with
``ctypes`` in a subprocess, called through its C entry point
``sei_gemm_dgrad`` on seeded inputs, and its outputs are held against the
plain version ``_torch_gemm_dgrad`` at 1e-4 (abs and rel, as
``chip_smoke.py``).

The cases cover the f32 step's four calls at a small M (fc2 with the
drop-path scale and gelu', fc1, proj with the window gather and shift, qkv),
ragged M, K and N (tails of the block tile and of the 20-deep slice), odd
widths and views at an odd offset (the one-element path), the window gather
with shift 0 and with a shift, the scale on and off and gp on and off; the
library is built at the shipped tile and at the other tiles and depths of
the tile sweep (``-DSEI_DGRAD_F32_BM``, ``_BN``, ``_BK``).
"""

import textwrap

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import swin_trunk as st

from . import cuda_emulation as emu

RTOL = ATOL = 1e-4

# loads the library, calls the entry point on each case of inputs.npz, saves
# the outputs to outputs.npz
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.sei_gemm_dgrad
    fn.argtypes = [I, I, P, I, P, P, P, I, P, I, *[I] * 9, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    outs = {}

    def view(arr, offset):  # arr's values at `offset` elements into a NaN-padded buffer
        buf = np.full(arr.size + offset + 64, np.nan, np.float32)
        buf[offset:offset + arr.size] = arr.ravel()
        return buf[offset:offset + arr.size].reshape(arr.shape)

    def p(a):
        return None if a is None else a.ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        m, k, n, rpi, windowed, h, w, ws, shift, offset = (int(v) for v in g("meta"))
        dy, wt = view(g("dy"), offset), view(g("w"), offset)
        gp = None if g("gp") is None else view(g("gp"), offset)
        scale = None if g("scale") is None else np.ascontiguousarray(g("scale"))
        out = view(np.full(m * k, np.nan, np.float32), offset)
        code = fn(0, 0, p(dy), 0, p(wt), p(scale), p(gp), 0, p(out), 0, m, n, k, rpi,
                  windowed, h, w, ws, shift, None)
        if code:
            sys.exit(f"{name}: sei_gemm_dgrad returned {code}")
        outs[f"{name}/out"] = out.copy()
    np.savez(sys.argv[3], **outs)
""")

# (name, M, K, N, images with a scale (0: none), gp, window (H, W, ws, shift)
# or None, element offset); the window cases hold images x H x W rows
CASES = [
    ("fc2_step", 256, 360, 180, 2, True, None, 0),
    ("fc1_step", 200, 180, 360, 0, False, None, 0),
    ("proj_step", 192, 180, 180, 2, False, (8, 12, 4, 2), 0),
    ("qkv_step", 130, 180, 540, 0, False, None, 0),
    ("window_shift0", 192, 40, 24, 2, False, (8, 12, 4, 0), 0),
    ("window_shift2_gp", 192, 24, 40, 2, True, (8, 12, 4, 2), 0),
    ("window_shift2_odd", 192, 13, 17, 2, False, (8, 12, 4, 2), 0),
    ("ragged_kn_gp", 70, 100, 44, 0, True, None, 0),
    ("ragged_m_scale_gp", 129, 36, 28, 3, True, None, 0),
    ("odd", 65, 33, 17, 0, False, None, 0),
    ("odd_scale_gp", 66, 17, 33, 2, True, None, 0),
    ("offset_scale_gp", 90, 40, 24, 2, True, None, 1),
    ("offset", 90, 24, 40, 0, False, None, 1),
    ("tiny", 3, 8, 4, 1, True, None, 0),
]
# the shipped tile gets every case; the other tiles and depths of the sweep
# one step, one ragged, one odd and one windowed case each
TILES = {"96x96x20": [c[0] for c in CASES],
         "128x96x20": ["fc2_step", "ragged_m_scale_gp", "odd_scale_gp", "proj_step"],
         "64x96x20": ["qkv_step", "ragged_m_scale_gp", "offset", "window_shift2_odd"],
         "96x96x12": ["fc1_step", "ragged_kn_gp", "odd", "proj_step"],
         "64x192x20": ["fc1_step", "ragged_kn_gp", "odd", "window_shift2_odd"],
         "128x192x12": ["qkv_step", "ragged_kn_gp", "offset_scale_gp", "window_shift2_gp"],
         "96x128x16": ["fc2_step", "ragged_kn_gp", "offset_scale_gp", "window_shift0"]}


def _inputs(case):
    name, m, k, n, images, with_gp, win, offset = case
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    arrs = {"dy": rng.standard_normal((m, n)).astype(f),
            "w": (rng.standard_normal((k, n)) * 0.3).astype(f)}
    if with_gp:
        arrs["gp"] = rng.standard_normal((m, k)).astype(f)
    if images:
        arrs["scale"] = np.array([0.0, 1.25, 1 / 0.9][:images], f)
    h, w, ws, shift = win or (0, 0, 0, 0)
    if win:
        assert m == images * h * w
    arrs["meta"] = np.array([m, k, n, m // images if images else 0, int(win is not None), h, w,
                             ws, shift, offset], np.int64)
    return arrs


def _plain(case, arrs):
    name, m, k, n, images, with_gp, win, _ = case
    t = {key: torch.from_numpy(v) for key, v in arrs.items() if key != "meta"}
    wm = st.WindowMap(*win) if win else None
    dy = t["dy"].view(images, wm.h, wm.w, n) if wm else t["dy"]
    return st._torch_gemm_dgrad(dy, t["w"], t.get("scale"), wm, t.get("gp")).numpy()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """tile -> the emulated kernel's outputs for that tile's cases."""
    root = tmp_path_factory.mktemp("gemm_dgrad_f32_emu")
    libs = emu.build(root, "gemm_bwd.cu", {
        tile: [f"SEI_DGRAD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK"), tile.split("x"))]
        for tile in TILES})
    by_name = {c[0]: c for c in CASES}
    return {tile: emu.run(root, RUNNER, lib, {f"{name}/{key}": v for name in TILES[tile]
                                              for key, v in _inputs(by_name[name]).items()})
            for tile, lib in libs.items()}


@pytest.mark.parametrize("tile,name", [(t, n) for t, names in TILES.items() for n in names])
def test_emulated_f32_dgrad_matches_plain(emulated, tile, name):
    case = next(c for c in CASES if c[0] == name)
    want = _plain(case, _inputs(case))
    got = emulated[tile][f"{name}/out"].reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
