"""The f32 LayerNorm backward kernel's logic run on the CPU, and its plain
version against the JAX package.

``sei_tpu_torch/ops/csrc/ln_rows_bwd.cu`` is compiled as it is by the host's
``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp, ``cp.async`` a synchronous copy,
``atomicInc`` a locked update).  The shared library is loaded with
``ctypes`` in a subprocess and called through its C entry point
``sei_ln_rows_bwd_f32`` (the vector kernel with f32 x, dz, dres and dx: the
f32 step's recompute backward) on seeded inputs in both of the trunk's
forms: LN2 (rows in pixel order, the block output's gradient added) and LN1
(the window map on the load of x and the store of dx, the residual
gradient dx2 added).  dx, dgamma and dbeta are held against the plain
version ``_torch_ln_rows_bwd`` at ``chip_smoke.py``'s f32 tolerances: dx to
1e-5 + 1e-5 x |plain| (a row's sums in another order), dgamma and dbeta to
1e-3 + 1e-4 x |plain| (sums of up to a few hundred rows in another order).

Every buffer lies in a larger one filled with NaN (inputs too, so a load
past a row, past C or past ``rows`` poisons the sums), at an address
aligned to 16 bytes as the wrapper requires; dx, the block partials and
dgamma / dbeta go in NaN-filled, a write outside dx's view is counted, and
the completion ticket must be back at 0 after each call.  The cases cover
C = 180 (two quads of 4 channels per lane at 32 lanes, three at 16, the
last lanes idle past 180), C = 12, 16 and 256, the window map at shift 0 and
shift > 0, no residual gradient, row counts that a block's rows per step do
not divide, fewer rows than warps, and grids that leave blocks without rows
(their partials are zeros in the sum).  One case runs twice in a row: both
calls give the same bits.  The library is built as shipped (32 lanes per
row, one row per warp) and with the sweep's other switches (8 and 16 lanes
per row, three and four stages, 8 warps, the sum as a second kernel).

Last, the plain version against the JAX package's LN backward on the CPU:
``sei_tpu.ops.swin_trunk._ln_fwd`` / ``_ln_bwd`` with the dgamma / dbeta
sums of its trunk backward (:670-672 for LN2; :851-857 for LN1, the
window-token gradient un-windowed and rolled back before the LN backward),
at the flagship width C = 180 and at C = 16, on the same seeded f32 inputs;
rtol 1e-5 and atol 1e-5 of each output's largest entry (sums in other
orders).
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

DX_TOL = (1e-5, 1e-5)  # chip_smoke.py's (atol, rtol) on the f32 LN backward's dx
SUM_TOL = (1e-3, 1e-4)  # and on its dgamma, dbeta
PAD = 1024  # NaN elements before and after every buffer

# loads the library, places each case's buffers in NaN-filled ones, calls
# the entry point (twice for a repeat case) and saves the outputs, the stray
# writes around dx and the ticket after each call
RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.sei_ln_rows_bwd_f32
    fn.argtypes = [I, P, P, P, I, P, I, P, I, P, P, P, L, I, F, *[I] * 6, P]
    fn.restype = I
    ticket = lib.sei_ln_rows_bwd_ticket
    ticket.argtypes = [I, P]
    ticket.restype = I
    inp = np.load(sys.argv[2])
    pad = int(inp["pad"])
    outs = {}

    def placed(a, n=None):  # a copy of a (or n NaNs) in a NaN buffer, 16-byte aligned
        n = a.size if a is not None else n
        buf = np.full(n + 3 * pad, np.nan, np.float32)
        at = next(i for i in range(pad, 2 * pad) if (buf.ctypes.data + 4 * i) % 16 == 0)
        if a is not None:
            buf[at:at + n] = a.ravel()
        return buf, at

    def ptr(buf, at):
        return buf[at:].ctypes.data

    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        g = lambda k: inp[f"{name}/{k}"] if f"{name}/{k}" in inp.files else None
        rows, c, blocks, windowed, h, w, ws, shift, res, calls = (int(v) for v in g("meta"))
        x, gam, dz = placed(g("x")), placed(g("gamma")), placed(g("dz"))
        dres = placed(g("dres")) if res else None
        dx, dxa = placed(None, rows * c)
        part, dg, db = placed(None, blocks * 2 * c), placed(None, c), placed(None, c)
        for call in range(calls):
            code = fn(0, ptr(*x), ptr(*gam), ptr(*dz), 0, ptr(*dres) if res else None, 0,
                      ptr(dx, dxa), 0, ptr(*part), ptr(*dg), ptr(*db), rows, c, 1e-5, blocks,
                      windowed, h, w, ws, shift, None)
            if code:
                sys.exit(f"{name}: sei_ln_rows_bwd_f32 returned {code}")
            t = np.zeros(1, np.uint32)
            if ticket(0, t.ctypes.data):
                sys.exit(f"{name}: sei_ln_rows_bwd_ticket failed")
            outs[f"{name}/ticket{call}"] = t.copy()
            outs[f"{name}/dx{call}"] = dx[dxa:dxa + rows * c].copy()
            outs[f"{name}/dgamma{call}"] = dg[0][dg[1]:dg[1] + c].copy()
            outs[f"{name}/dbeta{call}"] = db[0][db[1]:db[1] + c].copy()
        edges = np.concatenate([dx[:dxa], dx[dxa + rows * c:]])
        outs[f"{name}/dx_stray"] = np.array(np.count_nonzero(~np.isnan(edges)))
        # a call the kernel must refuse: C not a multiple of 4
        if fn(0, ptr(*x), ptr(*gam), ptr(*dz), 0, None, 0, ptr(dx, dxa), 0, ptr(*part),
              ptr(*dg), ptr(*db), rows, c - 2, 1e-5, blocks, 0, 0, 0, 0, 0, None) == 0:
            sys.exit(f"{name}: C = {c - 2} was not refused")
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
    "ln1_c16_shift": ("ln1", 2, 4, 8, 16, 2, 4, True, 2, 1),
    "ln1_c180_idle_blocks": ("ln1", 1, 4, 8, 180, 0, 4, True, 6, 1),
    "ln2_c256": ("ln2", 1, 7, 10, 256, None, 0, True, 2, 1),
    "ln1_c256_shift": ("ln1", 1, 8, 8, 256, 2, 4, True, 2, 1),
    "ln2_c180_twice": ("ln2", 1, 6, 13, 180, None, 0, True, 3, 2),
}
# the shipped build gets every case; the sweep's others a windowed, a
# pixel-order, a small-C, a wide-C, an idle-block and a repeat case each
SHIPPED = "shipped"
BUILDS = {"shipped": [],
          "lanes16": ["SEI_LN_BWD_F32_LANES=16"],
          "lanes8_warps8": ["SEI_LN_BWD_F32_LANES=8", "SEI_LN_BWD_F32_WARPS=8"],
          "lanes16_warps8_stages4": ["SEI_LN_BWD_F32_LANES=16", "SEI_LN_BWD_F32_WARPS=8",
                                     "SEI_LN_BWD_F32_STAGES=4", "SEI_LN_BWD_F32_MINB=2"],
          "sum_kernel_stages3": ["SEI_LN_BWD_F32_TICKET=0", "SEI_LN_BWD_F32_STAGES=3"]}
BLOCKS = {"shipped": list(CASES),
          **{b: ["ln1_c180_shift", "ln2_c180_nores_one_block", "ln1_c12_shift", "ln2_c256",
                 "ln1_c180_idle_blocks", "ln2_c180_twice"] for b in BUILDS if b != SHIPPED}}


def _case(name):
    """The case's f32 torch inputs (x, gamma, dz, dres) and window map."""
    form, b, h, w, c, shift, ws, res, _, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = np.float32
    x = torch.from_numpy((rng.standard_normal((b, h, w, c)) + 0.5).astype(f))
    rows = b * h * w
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c)).astype(f))
    dz = torch.from_numpy(rng.standard_normal((rows, c)).astype(f))
    dres = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(f)) if res else None
    wm = None if shift is None or form == "ln2" else st.WindowMap(h, w, ws, shift)
    if wm is None:
        x = x.view(rows, c)
        dres = None if dres is None else dres.view(rows, c)
    return x, gamma, dz, wm, dres


def _inputs(name):
    x, gamma, dz, wm, dres = _case(name)
    _, b, h, w, c, shift, ws, res, blocks, calls = CASES[name]
    arrs = {"x": x.numpy(), "gamma": gamma.numpy(), "dz": dz.numpy()}
    if dres is not None:
        arrs["dres"] = dres.numpy()
    arrs["meta"] = np.array([x.numel() // c, c, blocks, int(wm is not None), h, w, ws, shift or 0,
                             int(res), calls], np.int64)
    return arrs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """build -> the emulated kernel's outputs for that build's cases."""
    root = tmp_path_factory.mktemp("ln_bwd_f32_emu")
    libs = emu.build(root, "ln_rows_bwd.cu", BUILDS)

    def run(build):
        inputs = {f"{n}/{k}": v for n in BLOCKS[build] for k, v in _inputs(n).items()}
        return emu.run(root, RUNNER, libs[build], {**inputs, "pad": np.array(PAD)})

    with ThreadPoolExecutor(len(libs)) as pool:  # one subprocess per build, side by side
        return dict(zip(libs, pool.map(run, libs)))


def _close(name, got, want, tol):
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol[0], rtol=tol[1], err_msg=name)


@pytest.mark.parametrize("build,name", [(b, n) for b, names in BLOCKS.items() for n in names])
def test_emulated_f32_ln_bwd_matches_plain(emulated, build, name):
    got = emulated[build]
    x, gamma, dz, wm, dres = _case(name)
    want = st._torch_ln_rows_bwd(x, gamma, dz, wm, dres)
    calls = CASES[name][-1]
    assert int(got[f"{name}/dx_stray"]) == 0, "dx: written outside its view"
    for call in range(calls):
        assert int(got[f"{name}/ticket{call}"][0]) == 0, f"call {call}: ticket not back at 0"
        dx = torch.from_numpy(got[f"{name}/dx{call}"]).view(x.shape)
        _close(f"dx (call {call})", dx, want[0], DX_TOL)
        _close(f"dgamma (call {call})", torch.from_numpy(got[f"{name}/dgamma{call}"]), want[1],
               SUM_TOL)
        _close(f"dbeta (call {call})", torch.from_numpy(got[f"{name}/dbeta{call}"]), want[2],
               SUM_TOL)
    for key in ("dx", "dgamma", "dbeta"):  # a call repeated gives the same bits
        for call in range(1, calls):
            np.testing.assert_array_equal(got[f"{name}/{key}{call}"], got[f"{name}/{key}0"],
                                          err_msg=f"{key}: call {call} differs from call 0")


# -- the plain version against the JAX package's LN backward (f32, CPU) --------


@pytest.mark.parametrize("c", [16, 180])
@pytest.mark.parametrize("form,shift,res", [("ln2", None, True), ("ln1", 0, True),
                                            ("ln1", 4, True), ("ln1", 4, False)])
def test_plain_f32_ln_bwd_matches_jax(c, form, shift, res):
    """LN2 (rows in pixel order, dx2 = dout + LN backward, :670-672) and LN1
    (dz in window-token order: un-windowed and rolled by +shift before the
    LN backward, dx = dx2 + ..., :851-857), at the f32 step's width and a
    narrow one."""
    b, h, w, ws = 1, 16, 8, 8
    rng = np.random.default_rng(25 + c + (shift or 0) + 2 * res + 4 * (form == "ln1"))
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
