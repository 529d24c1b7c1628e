"""K8 ``copy_probe``'s index logic (16-byte packs, the scalar head and tail,
the unrolled grid-stride loop), run on the CPU.

``sei_tpu_torch/ops/csrc/launch_probe.cu`` is compiled as it is by the
host's ``g++`` against the stub of ``tests/cuda_emulation.py`` (each CUDA
thread a ``std::thread``), at the shipped unroll and at 1 and 3
(``-DSEI_COPY_PROBE_UNROLL``).  A subprocess loads it with ``ctypes`` and
calls ``sei_copy_probe`` on x at each element offset from a 16-byte
boundary (y at the same offset, as the wrapper allocates it), counts that
leave a tail or hold less than one pack, and 1 or 3 blocks, in f32 and
bf16; the output must equal the plain version ``_torch_copy_probe`` bit
for bit, and the buffer around it must stay untouched (NaN-filled).  The
C entry must refuse a y whose offset differs from x's.
"""

import textwrap

import numpy as np
import pytest
import torch

from sei_tpu_torch.ops import launch_probe as lp

from . import cuda_emulation as emu

PAD = 16  # elements of NaN on each side of x and of y
_BITS = {"f32": torch.int32, "bf16": torch.int16}

RUNNER = textwrap.dedent(r"""
    import ctypes, sys
    import numpy as np

    lib = ctypes.CDLL(sys.argv[1])
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.sei_copy_probe
    fn.argtypes = [I, I, P, P, L, I, I, P]
    fn.restype = I
    inp = np.load(sys.argv[2])
    pad = int(inp["pad"])
    outs = {}
    for name in sorted({k.split("/")[0] for k in inp.files if "/" in k}):
        x = inp[f"{name}/x"]  # the NaN-padded buffer, raw bits
        is_bf16, n, offset, blocks, add, y_shift = (int(v) for v in inp[f"{name}/meta"])
        # a 16-byte aligned copy of each buffer, x's values at `offset` elements in
        xb = np.zeros(x.size + 16, x.dtype)
        start = (-xb.ctypes.data % 16) // x.itemsize
        xb[start:start + x.size] = x
        yb = np.full_like(xb, x[0])  # x[0] is padding: NaN
        xp = xb.ctypes.data + (start + pad + offset) * x.itemsize
        yp = yb.ctypes.data + (start + pad + offset + y_shift) * x.itemsize
        code = fn(0, is_bf16, xp, yp, n, blocks, add, None)
        outs[f"{name}/code"] = np.array(code)
        outs[f"{name}/y"] = yb[start:start + x.size].copy()
    np.savez(sys.argv[3], **outs)
""")

BUILDS = {"shipped": [], "unroll1": ["SEI_COPY_PROBE_UNROLL=1"],
          "unroll3": ["SEI_COPY_PROBE_UNROLL=3"]}
# (n, element offset, blocks); the shipped build gets every case
CASES = [(n, off, blocks) for n in (1, 6, 9, 37, 1001, 4099) for off in (0, 1, 3, 5, 7)
         for blocks in (1, 3)]
OTHER_BUILDS = [(1001, 3, 1), (4099, 0, 3), (37, 5, 3)]


def _name(dtype, n, off, blocks, add):
    return f"{dtype}_n{n}_o{off}_b{blocks}_add{int(add)}"


def _x(dtype, n, off, seed):
    """The plain tensor of x's n values and the NaN-padded buffer around
    them, as raw bits (int32 for f32, int16 for bf16)."""
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy((rng.standard_normal(n) * 8).astype(np.float32))
    t = vals.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    nan = torch.full((PAD + off,), float("nan"), dtype=t.dtype)
    buf = torch.cat([nan, t, torch.full((PAD,), float("nan"), dtype=t.dtype)])
    return t, buf.view(_BITS[dtype]).numpy()


def _inputs(cases, y_shift=0):
    arrs = {"pad": np.array(PAD)}
    for dtype in ("f32", "bf16"):
        for n, off, blocks in cases:
            for add in (True, False):
                name = _name(dtype, n, off, blocks, add)
                arrs[f"{name}/x"] = _x(dtype, n, off, n + off)[1]
                arrs[f"{name}/meta"] = np.array([dtype == "bf16", n, off, blocks, add, y_shift])
    return arrs


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    root = tmp_path_factory.mktemp("copy_probe_emu")
    libs = emu.build(root, "launch_probe.cu", BUILDS)
    out = {build: emu.run(root, RUNNER, lib, _inputs(CASES if build == "shipped"
                                                      else OTHER_BUILDS))
           for build, lib in libs.items()}
    out["misaligned_y"] = emu.run(root, RUNNER, libs["shipped"], _inputs([(64, 0, 1)], 1))
    return out


@pytest.mark.parametrize("build,case", [("shipped", c) for c in CASES]
                         + [(b, c) for b in ("unroll1", "unroll3") for c in OTHER_BUILDS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_copy_probe_matches_plain(emulated, build, case, dtype):
    n, off, blocks = case
    for add in (True, False):
        name = _name(dtype, n, off, blocks, add)
        assert int(emulated[build][f"{name}/code"]) == 0
        got = emulated[build][f"{name}/y"]
        x, _ = _x(dtype, n, off, n + off)
        want = lp._torch_copy_probe(x, add).view(_BITS[dtype]).numpy()
        np.testing.assert_array_equal(got[PAD + off:PAD + off + n], want)
        untouched = np.concatenate([got[:PAD + off], got[PAD + off + n:]])
        assert np.all(untouched == got[0])  # the NaN padding, bit for bit


def test_emulated_copy_probe_refuses_a_y_off_xs_alignment(emulated):
    for key, code in emulated["misaligned_y"].items():
        if key.endswith("/code"):
            assert int(code) != 0, key
