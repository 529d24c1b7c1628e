"""Build and load the port's CUDA kernels (plain C interface, ctypes).

The sources under ``csrc/`` are compiled at first use, on the machine with the
GPU, into one shared library under ``sei_tpu_torch/_build/`` (listed in
``.gitignore``): one ``nvcc -c`` per ``.cu`` file, all started together, then
one link.  The library name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Importing
this module compiles nothing; only :func:`library` does, and only a CUDA
tensor reaches it.

Each C entry point takes the CUDA device index first, then whether its
storage type is bf16 (1) or f32 (0), and the stream last; it launches on that
stream and returns ``cudaGetLastError()``; :func:`check` turns a non-zero
code into an exception.  The f32 and bf16 instantiations of every kernel are
templates of one source, built together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-gencode", "arch=compute_90a,code=sm_90a",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sei_ln_rows": [_I, _I, _P, _P, _P, _P, _L, _I, _F, _I, _I, _I, _I, _I, _P],
    "sei_gemm_bias_epilogue": [_I, _I, *[_P] * 5, _I, _P, _P, *[_I] * 10, _P],
    "sei_window_attn_fwd": [_I, _I, *[_P] * 7, _L, *[_I] * 5, *[_L] * 12, _F, _P],
    "sei_window_attn_fwd_f32_blocks_per_sm": [_I],
    "sei_window_attn_fwd_bf16_blocks_per_sm": [_I],
    "sei_window_attn_bwd": [_I, _I, *[_P] * 12, _L, *[_I] * 5, *[_L] * 24, _F, _P],
    "sei_window_attn_bwd_f32_blocks_per_sm": [_I, _I],
    "sei_window_attn_bwd_bf16_blocks_per_sm": [_I],
    "sei_ln_rows_bwd": [_I, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _L, _I, _F,
                        *[_I] * 6, _P],
    "sei_ln_rows_bwd_bf16": [_I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _L, _I, _F,
                             *[_I] * 6, _P],
    "sei_ln_rows_bwd_bf16_blocks_per_sm": [_I] * 5,
    "sei_ln_rows_bwd_bf16_config": [_I],
    "sei_ln_rows_bwd_bf16_ticket": [_I, _P],
    "sei_gemm_dgrad": [_I, _I, _P, _I, _P, _P, _P, _I, _P, _I, *[_I] * 9, _P],
    "sei_gemm_wgrad": [_I, _I, _P, _P, _I, _P, _P, _P, *[_I] * 11, _P],
    "sei_gemm_wgrad_f32_splits": [_I, _I, _I, _I],
    "sei_copy_probe": [_I, _I, _P, _P, _L, _I, _I, _P],
    "sei_trunk_skeleton": [_I, _I, *[_P] * 19, _L, _L, *[_I] * 4, _P],
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of this process's build (0.0 when loaded as built)
    log: str        # nvcc / ptxas output of the build ("" when loaded as built)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("sei_tpu_torch: nvcc not found; the CUDA kernels "
                           "are built on the machine with the GPU")
    return path


def _digest(flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, sources: list[Path], flags: tuple[str, ...]) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        objs = [tmp / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *flags, "-I", str(CSRC), "-c", str(s),
                              "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        so = tmp / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)
        return "".join(f"== {s.name}\n{log}" for s, log in zip(sources, logs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library(defines: tuple[str, ...] = ()) -> Built:
    """Build (if needed) and load the kernel library; cached per process.
    ``defines``: extra ``-D`` macros for a variant of the library (the tile
    sweep's), part of its name; the kernel wrappers load the default one."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"libsei_kernels_{_digest(flags)}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        t0 = time.perf_counter()
        log = _compile(out, sources, flags)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sei_error_string.argtypes = [ctypes.c_int]
    lib.sei_error_string.restype = ctypes.c_char_p
    return Built(lib, out, seconds, log)


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().lib.sei_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def partial_count(work_items: int, blocks_per_partial: int = 1, per_sm: int = 2) -> int:
    """How many partials a reduction kernel should write: enough blocks
    (``blocks_per_partial`` per partial) for ``per_sm`` on each of the card's
    SMs, never more partials than there are work items to split."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return max(1, min(work_items, per_sm * sms // blocks_per_partial))
