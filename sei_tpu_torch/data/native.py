"""The native PNG loader: decode and shorter-side resize on the host
(counterpart of ``sei_tpu/data/native.py`` and ``csrc/sei_loader.cc``);
``GroundTruthDataset`` reads every PNG file through it, and its
``load_all`` on a pool of threads.

:func:`decode` reads a file, checks its chunks and inflates its image data
with the standard library's ``zlib`` (:func:`.loader.read_png_rows`), then
calls ``csrc/png_loader.cc`` through ``ctypes``: the row filters undone
and the samples turned into float32 CHW in [0, 1] (the numpy reader's
channel policy and its division by 255, bit for bit), then the antialiased
bicubic resize by taps, with the weights of
:func:`~sei_tpu_torch.ops.bicubic.resize_matrix` (the numpy path's numbers;
its sums in another order: within ~1e-7).  ``zlib`` and ``ctypes`` release
the GIL, so the threads run in parallel.

The library is built with ``g++`` at first use into
``sei_tpu_torch/_build/`` (gitignored), under a name hashed from the source
and the flags, and renamed into place when whole, so processes that build
at once do not read a partial file.  Nothing falls back: a failed build, a
corrupt file or an unsupported PNG raises; the numpy codec
(:func:`.loader.read_image`, with ``ops.resize.resize_shorter_side_np``) is
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops.bicubic import resize_matrix, shorter_side_sizes
from .loader import read_png_rows

SOURCE = Path(__file__).resolve().parent / "csrc" / "png_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sei_png_unfilter": ([_P, _I, _I, _I, _P], _I),
               "sei_resize_taps": ([_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                                    _P], None)}
_ERRORS = {1: "unknown PNG filter type", 2: "unsupported samples per pixel"}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loader's shared library, built at first use (``g++``)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libsei_png_{digest}.so"
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("sei_tpu_torch: g++ not found; the native PNG loader is built "
                               "from sei_tpu_torch/data/csrc/png_loader.cc with it")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix="libsei_png_", suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", tmp], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"sei_tpu_torch: building the native PNG loader failed:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(out))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


@functools.lru_cache(maxsize=None)
def taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The antialiased resize of an axis by taps: each output's first input
    index, its tap count, and its weights (padded to the longest row), the
    nonzero span of :func:`resize_matrix`'s row."""
    m = resize_matrix(in_size, out_size, antialias=True, scale=in_size / out_size)
    nz = m != 0
    first = nz.argmax(axis=1)
    count = in_size - nz[:, ::-1].argmax(axis=1) - first
    weights = np.zeros((out_size, int(count.max())), np.float32)
    for i in range(out_size):
        weights[i, :count[i]] = m[i, first[i]:first[i] + count[i]]
    return first.astype(np.intc), count.astype(np.intc), weights


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode(path: str) -> np.ndarray:
    """An 8-bit PNG as float32 (3, H, W) in [0, 1]: what
    ``loader.read_image(path)`` returns, bit for bit."""
    rows, h, w, spp = read_png_rows(path)
    if spp == 2:  # the numpy reader's channel policy refuses grey + alpha
        raise ValueError(f"{path}: Unexpected number of channels: {spp}")
    out = np.empty((3, h, w), np.float32)
    code = library().sei_png_unfilter(_ptr(rows), h, w, spp, _ptr(out))
    if code:
        raise ValueError(f"{path}: {_ERRORS.get(code, f'decode error {code}')}")
    return out


def resize_shorter_side(x: np.ndarray, size: int) -> np.ndarray:
    """``ops.resize.resize_shorter_side_np(x, size)`` (antialiased) of a
    float32 (C, H, W) image, by taps."""
    c, h, w = x.shape
    out_h, out_w = shorter_side_sizes(h, w, size)
    if (out_h, out_w) == (h, w):
        return x
    x = np.ascontiguousarray(x, np.float32)
    th, tw = taps(h, out_h), taps(w, out_w)
    out = np.empty((c, out_h, out_w), np.float32)
    tmp = np.empty((c, h, out_w), np.float32)
    library().sei_resize_taps(_ptr(x), c, h, w, _ptr(out), out_h, out_w,
                              *(_ptr(a) for a in th), th[2].shape[1],
                              *(_ptr(a) for a in tw), tw[2].shape[1], _ptr(tmp))
    return out
