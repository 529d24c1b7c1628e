"""The f32 weight-grad kernel's index logic, run on the CPU.

``sei_tpu_torch/ops/csrc/gemm_bwd.cu`` is compiled as it is by the host's
``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier, ``cp.async`` a synchronous
copy; the tensor-core kernels are left out without ``__CUDACC__``).  The
shared library is loaded with ``ctypes`` in a subprocess and called through
its C entry point ``sei_gemm_wgrad`` with explicit split counts on seeded
inputs; the partials (NaN-filled before the call, so an element no block
wrote shows) are summed in split order, and dW and db are held against the
plain version ``_torch_gemm_wgrad`` at ``chip_smoke.py``'s wgrad tolerances
(1e-3 abs + 1e-4 rel: sums over the token axis in another order).

The cases cover the f32 step's four calls at a small M (fc2 with the
drop-path scale, fc1, proj with the window gather at shift 0 and with a
shift, qkv), M off the slice depth, K and N off the block tile, odd widths
and a view at an odd offset in a NaN-padded buffer (the one-element path),
and a split count that leaves the last split without rows (its partial must
be zeros); the library is built at the shipped tile and at the other tiles
and depths of the tile sweep (``-DSEI_WGRAD_F32_BM``, ``_BN``, ``_BK``,
``_TM``, ``_TN``).  ``sei_gemm_wgrad_f32_splits`` is held against its rule
(one wave of the card's blocks, at most one split per slice) on an emulated
card of 132 SMs holding one block each.
"""

import textwrap

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import swin_trunk as st

from . import cuda_emulation as emu

ATOL, RTOL = 1e-3, 1e-4
SMS = 132  # the stub's SMs (one block of any kernel per SM)

# loads the library, calls the entry point on each case of inputs.npz, saves
# the partials and the split counts of the shapes in "splits_shapes"
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.sei_gemm_wgrad
    fn.argtypes = [I, I, P, P, I, P, P, P, *[I] * 11, P]
    fn.restype = I
    lib.sei_gemm_wgrad_f32_splits.argtypes = [I, I, I, I]
    lib.sei_gemm_wgrad_f32_splits.restype = I
    inp = np.load(sys.argv[2])
    outs = {}

    def view(arr, offset):  # arr's values at `offset` elements into a NaN-padded buffer
        buf = np.full(arr.size + offset + 64, np.nan, np.float32)
        buf[offset:offset + arr.size] = arr.ravel()
        return buf[offset:offset + arr.size].reshape(arr.shape)

    def p(a):
        return None if a is None else a.ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        m, k, n, rpi, windowed, h, w, ws, shift, offset, splits = (int(v) for v in g("meta"))
        a, dy = view(g("a"), offset), view(g("dy"), offset)
        scale = None if g("scale") is None else np.ascontiguousarray(g("scale"))
        dw = np.full((splits, k, n), np.nan, np.float32)
        db = np.full((splits, n), np.nan, np.float32)
        code = fn(0, 0, p(a), p(dy), 0, p(scale), p(dw), p(db), m, k, n, splits, rpi, 0,
                  windowed, h, w, ws, shift, None)
        if code:
            sys.exit(f"{name}: sei_gemm_wgrad returned {code}")
        outs[f"{name}/dw"], outs[f"{name}/db"] = dw, db
    outs["splits"] = np.array([lib.sei_gemm_wgrad_f32_splits(0, *map(int, s))
                               for s in inp["splits_shapes"]], np.int64)
    np.savez(sys.argv[3], **outs)
""")

# (name, M, K, N, images with a scale (0: none), window (H, W, ws, shift) or
# None, element offset, splits); the window cases hold images x H x W rows
CASES = [
    ("fc2_step", 256, 360, 180, 2, None, 0, 3),
    ("fc1_step", 200, 180, 360, 0, None, 0, 2),
    ("proj_shift0", 192, 180, 180, 2, (8, 12, 4, 0), 0, 3),
    ("proj_shift2", 192, 180, 180, 2, (8, 12, 4, 2), 0, 2),
    ("qkv_step", 130, 180, 540, 0, None, 0, 2),
    ("m_off_slice", 77, 40, 24, 1, None, 0, 3),
    ("kn_off_tile", 64, 100, 44, 2, None, 0, 2),
    ("odd", 65, 33, 17, 0, None, 0, 2),
    ("offset_scale", 90, 40, 24, 2, None, 1, 2),
    ("odd_window", 192, 13, 17, 2, (8, 12, 4, 2), 0, 3),
    ("empty_split", 32, 24, 20, 2, None, 0, 3),
    ("tiny", 3, 8, 4, 1, None, 0, 1),
]
# (BM, BN, BK, TM, TN) -> cases: the shipped tile gets every case, the
# other tiles and depths of the sweep one step call, one ragged, one odd or
# windowed case and the empty split each
SHIPPED = (96, 96, 28, 8, 6)
TILES = {SHIPPED: [c[0] for c in CASES],
         (96, 96, 16, 8, 6): ["fc2_step", "m_off_slice", "odd_window", "empty_split"],
         (96, 96, 20, 8, 6): ["proj_shift2", "m_off_slice", "offset_scale", "empty_split"],
         (96, 96, 24, 8, 6): ["fc1_step", "m_off_slice", "odd", "empty_split"],
         (64, 96, 32, 8, 6): ["qkv_step", "kn_off_tile", "odd", "empty_split"],
         (60, 96, 24, 6, 6): ["fc1_step", "kn_off_tile", "odd_window", "empty_split"],
         (96, 60, 24, 6, 6): ["qkv_step", "proj_shift0", "offset_scale", "empty_split"]}
# the f32 step's four calls per block at both graphs, for the split rule
SPLITS_SHAPES = [(t, k, n) for t in (36864, 18432)
                 for k, n in ((360, 180), (180, 360), (180, 180), (180, 540))] + [(40, 180, 180)]


def _name(tile):
    return "x".join(map(str, tile))


def _inputs(case):
    name, m, k, n, images, win, offset, splits = case
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    h, w, ws, shift = win or (0, 0, 0, 0)
    dy_shape = (images, h, w, n) if win else (m, n)
    arrs = {"a": rng.standard_normal((m, k)).astype(f), "dy": rng.standard_normal(dy_shape).astype(f)}
    if images:
        arrs["scale"] = np.array([0.0, 1.25, 1 / 0.9][:images], f)
    if win:
        assert m == images * h * w
    arrs["meta"] = np.array([m, k, n, m // images if images else 0, int(win is not None), h, w,
                             ws, shift, offset, splits], np.int64)
    return arrs


def _plain(case, arrs):
    win = case[5]
    t = {key: torch.from_numpy(v) for key, v in arrs.items() if key != "meta"}
    dw, db = st._torch_gemm_wgrad(t["a"], t["dy"], t.get("scale"), st.WindowMap(*win) if win else None)
    return dw.numpy(), db.numpy()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """tile -> the emulated kernel's outputs for that tile's cases."""
    root = tmp_path_factory.mktemp("gemm_wgrad_f32_emu")
    libs = emu.build(root, "gemm_bwd.cu", {
        _name(tile): [f"SEI_WGRAD_F32_{k}={v}" for k, v in zip(("BM", "BN", "BK", "TM", "TN"), tile)]
        for tile in TILES})
    by_name = {c[0]: c for c in CASES}
    out = {}
    for tile in TILES:
        inputs = {f"{name}/{key}": v for name in TILES[tile]
                  for key, v in _inputs(by_name[name]).items()}
        inputs["splits_shapes"] = np.array(SPLITS_SHAPES, np.int64)
        out[tile] = emu.run(root, RUNNER, libs[_name(tile)], inputs)
    return out


@pytest.mark.parametrize("tile,name", [(t, n) for t, names in TILES.items() for n in names],
                         ids=lambda v: _name(v) if isinstance(v, tuple) else v)
def test_emulated_f32_wgrad_matches_plain(emulated, tile, name):
    case = next(c for c in CASES if c[0] == name)
    want_dw, want_db = _plain(case, _inputs(case))
    dw, db = emulated[tile][f"{name}/dw"], emulated[tile][f"{name}/db"]
    np.testing.assert_allclose(dw.sum(0), want_dw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(db.sum(0), want_db, rtol=RTOL, atol=ATOL)
    if name == "empty_split":  # 32 rows in chunks of 16 rows or more: none left for split 2
        assert not dw[-1].any() and not db[-1].any()


@pytest.mark.parametrize("tile", list(TILES), ids=_name)
def test_emulated_f32_wgrad_split_rule(emulated, tile):
    """One wave: 132 SMs x 1 block (the stub's occupancy) over the tiles of
    the call, at most one split per slice of M, at least one split."""
    bm, bn, bk = tile[:3]
    want = [max(1, min(-(-m // bk), SMS // (-(-k // bm) * -(-n // bn))))
            for m, k, n in SPLITS_SHAPES]
    assert emulated[tile]["splits"].tolist() == want
