"""The bf16 LayerNorm forward kernel's logic run on the CPU, and its plain
version against the JAX package.

``sei_tpu_torch/ops/csrc/ln_rows.cu`` is compiled as it is by the host's
``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp, ``cp.async`` a synchronous
copy).  The shared library is loaded with ``ctypes`` in a subprocess and
called through its C entry point ``sei_ln_rows_bf16`` (the vector kernel:
bf16 x, f32 gamma and beta, bf16 out) on seeded inputs in both of the
trunk's forms: LN1 (the shifted window map on the load) and LN2 (rows in
pixel order).  The output is held against the plain version
``_torch_ln_rows`` at ``chip_smoke.py``'s gate on bf16 outputs (1e-2 x
(|plain| + max |plain|)), and at least 99% of its elements must equal the
plain version's bits, so a missed or doubled rounding shows.

Every buffer lies in a larger one filled with NaN (x, gamma and beta too,
so a load past a row, past C or past ``rows`` poisons the statistics), at
an address aligned to 16 bytes; the output goes in NaN-filled and a write
outside its view is counted.  The cases cover C = 180 (three quads of 4
channels per lane at 16 lanes, the last lane group idle past 180), C = 12,
16 and 256, the window map at shift 0 and shift > 0, row counts that a
block's rows per step do not divide, fewer rows than warps, grids that
leave blocks without rows, and more rows than the grid takes in one step
per warp.  One case runs twice in a row: both calls give the same bits.  A
call with C % 4 != 0 must be refused.  The library is built as shipped and
with the sweep's other switches (8 and 32 lanes per row, two, three and
four steps per warp, 4, 8 and 16 warps).

Last, the plain version against the JAX package's LN forward on the CPU:
``sei_tpu.ops.swin_trunk._ln_fwd`` on the rolled, window-partitioned image
(``_window_tokens``, :263-270, :432-433) or on the rows in pixel order,
then the bf16 cast the JAX trunk makes before the GEMM that reads it
(:429-430, :537-539), on the same seeded bf16 inputs, at the same gate.
"""

import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.swin_trunk import TrunkDims, _ln_fwd, _window_tokens
from sei_tpu_torch.ops import swin_trunk as st

from . import cuda_emulation as emu

BF16_RTOL = 1e-2  # chip_smoke.py's gate on bf16 outputs
EXACT_SHARE = 0.99  # of the output's elements equal to the plain version's bits
PAD = 1024  # NaN elements before and after every buffer

# loads the library, places each case's buffers in NaN-filled ones (bf16 as
# uint16 bits), calls the entry point (twice for a repeat case) and saves
# the output and the stray writes around it
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_ln_rows_bf16
    fn.argtypes = [I, P, P, P, P, L, I, F, I, *[I] * 5, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    pad = int(inp["pad"])
    outs = {}
    NAN = {np.uint16: 0x7FC0, np.float32: np.nan}

    def placed(a, dtype, n=None):  # a copy of a (or n NaNs) in a NaN buffer, 16-byte aligned
        n = a.size if a is not None else n
        buf = np.full(n + 3 * pad, NAN[dtype], dtype)
        at = next(i for i in range(pad, 2 * pad) if (buf.ctypes.data + buf.itemsize * i) % 16 == 0)
        if a is not None:
            buf[at:at + n] = a.ravel()
        return buf, at

    def ptr(buf, at):
        return buf[at:].ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"]
        rows, c, blocks, windowed, h, w, ws, shift, calls = (int(v) for v in g("meta"))
        x = placed(g("x"), np.uint16)
        gam, bet = placed(g("gamma"), np.float32), placed(g("beta"), np.float32)
        out, oa = placed(None, np.uint16, rows * c)
        for call in range(calls):
            code = fn(0, ptr(*x), ptr(*gam), ptr(*bet), ptr(out, oa), rows, c, 1e-5, blocks,
                      windowed, h, w, ws, shift, None)
            if code:
                sys.exit(f"{name}: sei_ln_rows_bf16 returned {code}")
            outs[f"{name}/out{call}"] = out[oa:oa + rows * c].copy()
        edges = np.concatenate([out[:oa], out[oa + rows * c:]])
        outs[f"{name}/stray"] = np.array(np.count_nonzero(edges != 0x7FC0))
        # a call the kernel must refuse: C not a multiple of 4
        if fn(0, ptr(*x), ptr(*gam), ptr(*bet), ptr(out, oa), rows, c - 2, 1e-5, blocks,
              0, 0, 0, 0, 0, None) == 0:
            sys.exit(f"{name}: C = {c - 2} was not refused")
    np.savez(sys.argv[3], **outs)
""")

# name: (images, h, w, C, window shift (None: rows in pixel order), ws,
# blocks, calls)
CASES = {
    "ln1_c180_shift": (2, 8, 8, 180, 2, 4, 2, 1),
    "ln1_c180_shift0": (2, 8, 8, 180, 0, 4, 3, 1),
    "ln2_c180": (1, 9, 23, 180, None, 0, 2, 1),
    "ln2_c180_one_block": (1, 10, 15, 180, None, 0, 1, 1),
    "ln1_c12_shift": (1, 8, 12, 12, 2, 4, 2, 1),
    "ln2_c16_five_rows": (1, 1, 5, 16, None, 0, 1, 1),
    "ln1_c16_shift": (2, 4, 8, 16, 2, 4, 2, 1),
    "ln1_c180_idle_blocks": (1, 4, 8, 180, 0, 4, 6, 1),
    "ln2_c256": (1, 7, 10, 256, None, 0, 2, 1),
    "ln1_c256_shift": (1, 8, 8, 256, 2, 4, 2, 1),
    "ln2_c180_twice": (1, 6, 13, 180, None, 0, 3, 2),
}
# the shipped build gets every case; the sweep's others a windowed, a
# pixel-order, a small-C, a wide-C, an idle-block and a repeat case each
SHIPPED = "shipped"
BUILDS = {"shipped": [],
          "stages2_warps8": ["SEI_LN_BF16_STAGES=2", "SEI_LN_BF16_WARPS=8",
                             "SEI_LN_BF16_MINB=4"],
          "lanes8_stages3": ["SEI_LN_BF16_LANES=8", "SEI_LN_BF16_STAGES=3"],
          "lanes32_warps8": ["SEI_LN_BF16_LANES=32", "SEI_LN_BF16_WARPS=8"],
          "warps4_minb8": ["SEI_LN_BF16_WARPS=4", "SEI_LN_BF16_MINB=8"],
          "stages3_warps8": ["SEI_LN_BF16_STAGES=3", "SEI_LN_BF16_WARPS=8",
                             "SEI_LN_BF16_MINB=4"],
          "stages4_warps16": ["SEI_LN_BF16_STAGES=4", "SEI_LN_BF16_WARPS=16",
                              "SEI_LN_BF16_MINB=2"]}
BLOCKS = {"shipped": list(CASES),
          **{b: ["ln1_c180_shift", "ln2_c180_one_block", "ln1_c12_shift", "ln2_c256",
                 "ln1_c180_idle_blocks", "ln2_c180_twice"] for b in BUILDS if b != SHIPPED}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _case(name):
    """The case's torch inputs (x bf16, gamma and beta f32) and window map."""
    b, h, w, c, shift, ws, _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    x = torch.from_numpy((rng.standard_normal((b, h, w, c)) + 0.5).astype(f)).bfloat16()
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(f))
    beta = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(f))
    wm = None if shift is None else st.WindowMap(h, w, ws, shift)
    return (x if wm else x.view(-1, c)), gamma, beta, wm


def _inputs(name):
    x, gamma, beta, wm = _case(name)
    b, h, w, c, shift, ws, blocks, calls = CASES[name]
    return {"x": _bits(x), "gamma": gamma.numpy(), "beta": beta.numpy(),
            "meta": np.array([x.numel() // c, c, blocks, int(wm is not None), h, w, ws,
                              shift or 0, calls], np.int64)}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """build -> the emulated kernel's outputs for that build's cases."""
    root = tmp_path_factory.mktemp("ln_bf16_emu")
    libs = emu.build(root, "ln_rows.cu", BUILDS)

    def run(build):
        inputs = {f"{n}/{k}": v for n in BLOCKS[build] for k, v in _inputs(n).items()}
        return emu.run(root, RUNNER, libs[build], {**inputs, "pad": np.array(PAD)})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per build, side by side
        return dict(zip(libs, pool.map(run, libs)))


def _close_bf16(name, got, want):
    """chip_smoke.py's compare_bf16 on a bf16 output, and EXACT_SHARE of its
    bits equal."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), f"{name}: non-finite output"
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(w.abs().max()), err_msg=name)
    exact = float((g == w).float().mean())
    assert exact >= EXACT_SHARE, f"{name}: only {exact:.4f} of the elements equal the plain bits"


@pytest.mark.parametrize("build,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_bf16_ln_matches_plain(emulated, build, name):
    got = emulated[build]
    x, gamma, beta, wm = _case(name)
    want = st._torch_ln_rows(x, gamma, beta, wm)
    assert int(got[f"{name}/stray"]) == 0, "out: written outside its view"
    calls = CASES[name][-1]
    for call in range(calls):
        _close_bf16(f"out (call {call})", _bf16(got[f"{name}/out{call}"]).view(want.shape), want)
        np.testing.assert_array_equal(got[f"{name}/out{call}"], got[f"{name}/out0"],
                                      err_msg=f"call {call} differs from call 0")


# -- the plain version against the JAX package's LN forward (CPU) --------------


@pytest.mark.parametrize("c", [16, 180])
@pytest.mark.parametrize("shift", [None, 0, 4])
def test_plain_bf16_ln_matches_jax(c, shift):
    """LN1 (the rolled image's window tokens, :432-433) and LN2 (rows in
    pixel order), each rounded to bf16 as the JAX trunk casts the LN output
    before its GEMM (:429-430, :537-539)."""
    b, h, w, ws = 2, 16, 8, 8
    rng = np.random.default_rng(25 + c + (shift if shift is not None else 7))
    f = np.float32
    xb = torch.from_numpy((rng.standard_normal((b, h, w, c)) + 0.5).astype(f)).bfloat16()
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    beta = (0.1 * rng.standard_normal(c)).astype(f)

    x32 = jnp.asarray(xb.float().numpy())
    if shift is not None:
        dims = TrunkDims(d=2, b=b, g=b, h=h, w=w, c=c, nh=2, ws=ws, ch=2 * c, shift=shift)
        if shift:
            x32 = jnp.roll(x32, (-shift, -shift), axis=(1, 2))
        x32 = _window_tokens(x32, dims)
    y, _, _ = _ln_fwd(x32.reshape(-1, c), jnp.asarray(gamma), jnp.asarray(beta))
    want = torch.from_numpy(np.array(y.astype(jnp.bfloat16).astype(jnp.float32))).bfloat16()

    wm = None if shift is None else st.WindowMap(h, w, ws, shift)
    got = st._torch_ln_rows(xb if wm else xb.view(-1, c), torch.from_numpy(gamma),
                            torch.from_numpy(beta), wm)
    assert got.dtype == torch.bfloat16
    _close_bf16("ln", got, want)
