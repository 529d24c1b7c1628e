"""The bf16 LayerNorm backward kernel's logic run on the CPU, and its plain
version against the JAX package.

``sei_tpu_torch/ops/csrc/ln_rows_bwd.cu`` is compiled as it is by the host's
``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp, ``atomicInc`` a locked update).
The shared library is loaded with ``ctypes`` in a subprocess and called
through its C entry point ``sei_ln_rows_bwd_bf16`` on seeded inputs in both
of the bf16 step's forms: LN2 (bf16 x, f32 dz, bf16 residual gradient ->
f32 dx) and LN1 (bf16 x, bf16 dz, f32 residual gradient -> bf16 dx, the
window map on the load of x and the store of dx).  dx, dgamma and dbeta
are held against the plain version ``_torch_ln_rows_bwd`` at
``chip_smoke.py``'s tolerances: bf16 dx to 1e-2 x (|plain| + max |plain|),
f32 outputs to 1e-3 + 1e-4 x |plain| (sums of up to a few hundred rows in
another order); at least 99% of a bf16 dx's elements must equal the plain
version's bits, so a missed or doubled rounding shows.

Every buffer lies in a larger one filled with NaN (inputs too, so a load
past a row, past C or past ``rows`` poisons the sums), at an address
aligned to 16 bytes as the wrapper requires; dx, the block partials and
dgamma / dbeta go in NaN-filled, a write outside dx's view is counted, and
the completion ticket must be back at 0 after each call.  The cases cover
C = 180 (three quads of 4 channels per lane at 16 lanes, the last lane
group idle past 180), C = 12, 16 and 256, the window map at shift 0 and
shift > 0, no residual gradient, row counts that a block's rows per step do
not divide, fewer rows than warps, and grids that leave blocks without rows
(their partials are zeros in the sum).  One case runs twice in a row: both
calls give the same bits.  The library is built as shipped (16 lanes per
row, a ring of two stages per warp, 16 warps, the last block summing) and
with the sweep's other switches (8 and 32 lanes per row, three and four
stages, 8 warps, the sum as a second kernel).

Last, the plain version against the JAX package's LN backward on the CPU:
``sei_tpu.ops.swin_trunk._ln_fwd`` / ``_ln_bwd`` with the dgamma / dbeta
sums of its trunk backward (:670-672 for LN2; :851-857 for LN1, the
window-token gradient un-windowed and rolled back before the LN backward),
on the same seeded f32 inputs; f32 throughout, rtol 1e-5 and atol 1e-5 of
each output's largest entry (sums in other orders).
"""

import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sei_tpu.ops.swin_trunk import TrunkDims, _ln_bwd, _ln_fwd, _unwindow_tokens
from sei_tpu_torch.ops import swin_trunk as st

from . import cuda_emulation as emu

BF16_RTOL = 1e-2  # chip_smoke.py's gate on bf16 outputs
F32_TOL = (1e-3, 1e-4)  # chip_smoke.py's (atol, rtol) on the LN backward's f32 outputs
EXACT_SHARE = 0.99  # of a bf16 dx's elements equal to the plain version's bits
PAD = 1024  # NaN elements before and after every buffer

# loads the library, places each case's buffers in NaN-filled ones (bf16 as
# uint16 bits), calls the entry point (twice for a repeat case) and saves
# the outputs, the stray writes around dx and the ticket after each call
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_ln_rows_bwd_bf16
    fn.argtypes = [I, P, P, P, I, P, I, P, I, P, P, P, L, I, F, *[I] * 6, P]
    fn.restype = I
    ticket = lib.sei_ln_rows_bwd_ticket
    ticket.argtypes = [I, P]
    ticket.restype = I
    inp = np.load(sys.argv[2])
    pad = int(inp["pad"])
    outs = {}
    NAN = {np.uint16: 0x7FC0, np.float32: np.nan}

    def placed(a, dtype):  # a copy of a in a NaN buffer, 16-byte aligned
        n = 0 if a is None else a.size
        buf = np.full(n + 3 * pad, NAN[dtype], dtype)
        at = next(i for i in range(pad, 2 * pad) if (buf.ctypes.data + buf.itemsize * i) % 16 == 0)
        if a is not None:
            buf[at:at + n] = a.ravel()
        return buf, at

    def ptr(buf, at):
        return buf[at:].ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        rows, c, blocks, windowed, h, w, ws, shift, dz_bf16, res, dx_bf16, calls = (
            int(v) for v in g("meta"))
        ty = lambda bf: np.uint16 if bf else np.float32
        x, xa = placed(g("x"), np.uint16)
        gam, ga = placed(g("gamma"), np.float32)
        dz, za = placed(g("dz"), ty(dz_bf16))
        dres = placed(g("dres"), ty(res == 2))
        dx, dxa = placed(np.full(rows * c, NAN[ty(dx_bf16)], ty(dx_bf16)), ty(dx_bf16))
        part, pa = placed(np.full(blocks * 2 * c, np.nan, np.float32), np.float32)
        dg, dga = placed(np.full(c, np.nan, np.float32), np.float32)
        db, dba = placed(np.full(c, np.nan, np.float32), np.float32)
        for call in range(calls):
            code = fn(0, ptr(x, xa), ptr(gam, ga), ptr(dz, za), dz_bf16,
                      ptr(*dres) if res else None, int(res == 2), ptr(dx, dxa), dx_bf16,
                      ptr(part, pa), ptr(dg, dga), ptr(db, dba), rows, c, 1e-5, blocks,
                      windowed, h, w, ws, shift, None)
            if code:
                sys.exit(f"{name}: sei_ln_rows_bwd_bf16 returned {code}")
            t = np.zeros(1, np.uint32)
            if ticket(0, t.ctypes.data):
                sys.exit(f"{name}: sei_ln_rows_bwd_ticket failed")
            outs[f"{name}/ticket{call}"] = t.copy()
            outs[f"{name}/dx{call}"] = dx[dxa:dxa + rows * c].copy()
            outs[f"{name}/dgamma{call}"] = dg[dga:dga + c].copy()
            outs[f"{name}/dbeta{call}"] = db[dba:dba + c].copy()
        edges = np.concatenate([dx[:dxa], dx[dxa + rows * c:]])
        outs[f"{name}/dx_stray"] = np.array(np.count_nonzero(edges != 0x7FC0) if dx_bf16
                                            else np.count_nonzero(~np.isnan(edges)))
    np.savez(sys.argv[3], **outs)
""")

# name: (form, images, h, w, C, window shift (None: rows in pixel order), ws,
# residual gradient, blocks, calls)
CASES = {
    "ln1_c180_shift": ("ln1", 2, 8, 8, 180, 2, 4, True, 2, 1),
    "ln1_c180_shift0": ("ln1", 2, 8, 8, 180, 0, 4, True, 3, 1),
    "ln1_c180_nores": ("ln1", 1, 8, 12, 180, 2, 4, False, 2, 1),
    "ln2_c180": ("ln2", 1, 9, 23, 180, None, 0, True, 2, 1),
    "ln2_c180_nores_one_block": ("ln2", 1, 10, 15, 180, None, 0, False, 1, 1),
    "ln1_c12_shift": ("ln1", 1, 8, 12, 12, 2, 4, True, 2, 1),
    "ln2_c16_five_rows": ("ln2", 1, 1, 5, 16, None, 0, True, 1, 1),
    "ln1_c180_idle_blocks": ("ln1", 1, 4, 8, 180, 0, 4, True, 6, 1),
    "ln2_c256": ("ln2", 1, 7, 10, 256, None, 0, True, 2, 1),
    "ln2_c180_twice": ("ln2", 1, 6, 13, 180, None, 0, True, 3, 2),
}
# the shipped build gets every case; the sweep's others a windowed, a
# pixel-order, a small-C and an idle-block case each
SHIPPED = "shipped"
BUILDS = {"shipped": [],
          "lanes8_stages3": ["SEI_LN_BWD_BF16_LANES=8", "SEI_LN_BWD_BF16_STAGES=3",
                             "SEI_LN_BWD_BF16_WARPS=8"],
          "lanes32": ["SEI_LN_BWD_BF16_LANES=32"],
          "warps8_stages3": ["SEI_LN_BWD_BF16_WARPS=8", "SEI_LN_BWD_BF16_STAGES=3",
                             "SEI_LN_BWD_BF16_MINB=2"],
          "sum_kernel_stages4": ["SEI_LN_BWD_BF16_TICKET=0", "SEI_LN_BWD_BF16_STAGES=4"]}
BLOCKS = {"shipped": list(CASES),
          **{b: ["ln1_c180_shift", "ln2_c180_nores_one_block", "ln1_c12_shift",
                 "ln1_c180_idle_blocks", "ln2_c180_twice"] for b in BUILDS if b != SHIPPED}}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _case(name):
    """The case's torch inputs (x bf16, gamma f32, dz and dres in the form's
    dtypes), window map and output dtype."""
    form, b, h, w, c, shift, ws, res, _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    ln1 = form == "ln1"
    x = torch.from_numpy((rng.standard_normal((b, h, w, c)) + 0.5).astype(f)).bfloat16()
    rows = b * h * w
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(f))
    dz = torch.from_numpy(rng.standard_normal((rows, c)).astype(f))
    dz = dz.bfloat16() if ln1 else dz
    dres = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(f)) if res else None
    dres = dres if dres is None or ln1 else dres.bfloat16()
    wm = None if shift is None else st.WindowMap(h, w, ws, shift)
    return (x if wm else x.view(rows, c)), gamma, dz, wm, (
        None if dres is None else dres if wm else dres.view(rows, c)), (
        torch.bfloat16 if ln1 else torch.float32)


def _inputs(name):
    x, gamma, dz, wm, dres, out_dtype = _case(name)
    _, b, h, w, c, shift, ws, res, blocks, calls = CASES[name]
    rows = x.numel() // c
    arrs = {"x": _bits(x), "gamma": gamma.numpy(),
            "dz": _bits(dz) if dz.dtype == torch.bfloat16 else dz.numpy()}
    if dres is not None:
        arrs["dres"] = _bits(dres) if dres.dtype == torch.bfloat16 else dres.numpy()
    res_code = 0 if dres is None else 2 if dres.dtype == torch.bfloat16 else 1
    arrs["meta"] = np.array([rows, c, blocks, int(wm is not None), h, w, ws, shift or 0,
                             int(dz.dtype == torch.bfloat16), res_code,
                             int(out_dtype == torch.bfloat16), calls], np.int64)
    return arrs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """build -> the emulated kernel's outputs for that build's cases."""
    root = tmp_path_factory.mktemp("ln_bwd_bf16_emu")
    libs = emu.build(root, "ln_rows_bwd.cu", BUILDS)

    def run(build):
        inputs = {f"{n}/{k}": v for n in BLOCKS[build] for k, v in _inputs(n).items()}
        return emu.run(root, RUNNER, libs[build], {**inputs, "pad": np.array(PAD)})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per build, side by side
        return dict(zip(libs, pool.map(run, libs)))


def _close(name, got, want):
    """chip_smoke.py's compare_bf16: bf16 to BF16_RTOL of |plain| and of its
    largest entry (and EXACT_SHARE of the bits equal), f32 to F32_TOL."""
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * float(w.abs().max()), err_msg=name)
        exact = float((g == w).float().mean())
        assert exact >= EXACT_SHARE, f"{name}: only {exact:.4f} of the elements equal the plain bits"
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL[1], atol=F32_TOL[0],
                                   err_msg=name)


@pytest.mark.parametrize("build,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_bf16_ln_bwd_matches_plain(emulated, build, name):
    got = emulated[build]
    x, gamma, dz, wm, dres, out_dtype = _case(name)
    want = st._torch_ln_rows_bwd(x, gamma, dz, wm, dres, out_dtype)
    calls = CASES[name][-1]
    assert int(got[f"{name}/dx_stray"]) == 0, "dx: written outside its view"
    for call in range(calls):
        assert int(got[f"{name}/ticket{call}"][0]) == 0, f"call {call}: ticket not back at 0"
        raw = got[f"{name}/dx{call}"]
        dx = (_bf16(raw) if out_dtype == torch.bfloat16 else torch.from_numpy(raw)).view(x.shape)
        _close(f"dx (call {call})", dx, want[0])
        _close(f"dgamma (call {call})", torch.from_numpy(got[f"{name}/dgamma{call}"]), want[1])
        _close(f"dbeta (call {call})", torch.from_numpy(got[f"{name}/dbeta{call}"]), want[2])
    for key in ("dx", "dgamma", "dbeta"):  # a call repeated gives the same bits
        for call in range(1, calls):
            np.testing.assert_array_equal(got[f"{name}/{key}{call}"], got[f"{name}/{key}0"],
                                          err_msg=f"{key}: call {call} differs from call 0")


# -- the plain version against the JAX package's LN backward (f32, CPU) --------


@pytest.mark.parametrize("form,shift,res", [("ln2", None, True), ("ln2", None, False),
                                            ("ln1", 0, True), ("ln1", 2, True),
                                            ("ln1", 2, False)])
def test_plain_ln_bwd_matches_jax(form, shift, res):
    """LN2 (rows in pixel order, dx2 = dout + LN backward, :670-672) and LN1
    (dz in window-token order: un-windowed and rolled by +shift before the
    LN backward, dx = dx2 + ..., :851-857)."""
    b, h, w, c, ws = 2, 8, 12, 20, 4
    rng = np.random.default_rng(16 + (shift or 0) + 2 * res + 4 * (form == "ln1"))
    f = np.float32
    x = (rng.standard_normal((b, h, w, c)) + 0.5).astype(f)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(f)
    dz = rng.standard_normal((b * h * w, c)).astype(f)
    dres = rng.standard_normal((b, h, w, c)).astype(f) if res else np.zeros((b, h, w, c), f)

    _, xhat, inv = _ln_fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.zeros(c))
    if form == "ln1":
        dims = TrunkDims(d=2, b=b, g=b, h=h, w=w, c=c, nh=2, ws=ws, ch=2 * c, shift=shift)
        da = _unwindow_tokens(jnp.asarray(dz).reshape(-1, ws * ws, c), b, dims)
        if shift:
            da = jnp.roll(da, (shift, shift), axis=(1, 2))
    else:
        da = jnp.asarray(dz).reshape(b, h, w, c)
    want = (jnp.asarray(dres) + _ln_bwd(da, xhat, inv, jnp.asarray(gamma)),
            jnp.sum(da * xhat, axis=(0, 1, 2)), jnp.sum(da, axis=(0, 1, 2)))

    wm = st.WindowMap(h, w, ws, shift) if form == "ln1" else None
    xt = torch.from_numpy(x)
    got = st._torch_ln_rows_bwd(xt if wm else xt.view(-1, c), torch.from_numpy(gamma),
                                torch.from_numpy(dz), wm,
                                torch.from_numpy(dres).view(xt.shape if wm else (-1, c))
                                if res else None)
    for name, g, w_ in zip(("dx", "dgamma", "dbeta"), got, want):
        w_ = np.asarray(w_).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5, atol=1e-5 * np.abs(w_).max(),
                                   err_msg=name)
