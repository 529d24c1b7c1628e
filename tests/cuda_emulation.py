"""Run a CUDA source's f32 kernels on the CPU: their index logic, not their timing.

A source under ``sei_tpu_torch/ops/csrc`` is compiled as it is by the host's
``g++`` against a small stub of the CUDA features the f32 kernels use
(:data:`STUB`, written as ``cuda_runtime.h``): each CUDA thread of a block
runs as a ``std::thread`` (the blocks one after another, so ``__shared__``
arrays are plain statics and dynamic shared memory one NaN-filled buffer),
``__syncthreads`` is a barrier, ``__shfl_xor_sync`` an exchange between the
32 threads of a warp at a barrier of their own, ``cp.async`` a synchronous
copy (zero-filled where the kernel asks for none), and ``float4``, ``erff``,
``expf`` and ``INFINITY`` come from the host.  Without ``__CUDACC__`` the
sources leave out their tensor-core kernels, whose entry points then refuse.
The shared library is loaded with ``ctypes`` in a subprocess (a fault there
fails the test instead of the worker), called on inputs from an ``.npz``
file, and its outputs come back in another.  This checks a kernel's tiling,
staging, masks and strides, not the GPU compiler: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` do that on the card.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sei_tpu_torch.ops import _build

CSRC = _build.CSRC
TIMEOUT_S = 120

STUB = r"""
// Host stand-ins for the CUDA features of the f32 kernels (one block at a
// time, one std::thread per CUDA thread)
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float __fmul_rn(float a, float b) { return a * b; }
using std::max;
using std::min;

struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;

struct SeiBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n = 0, waiting = 0;
  unsigned long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned long g = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != g; });
    }
  }
};
inline SeiBarrier sei_barrier;
inline void __syncthreads() { sei_barrier.wait(); }

template <int BYTES>
inline void cp_async(void* dst, const void* src, bool valid) {
  if (valid)
    memcpy(dst, src, BYTES);
  else
    memset(dst, 0, BYTES);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

// __shfl_xor_sync: the 32 lanes of a warp (threads 32 w .. 32 w + 31 of a
// one-dimensional block) meet at the warp's own barrier, each leaves its
// value in its slot, meet again, and read the partner's slot; every lane
// of the warp must call it, as with a full mask on the card
struct SeiWarps {
  SeiBarrier bar[32];
  uint64_t slot[32][32];
};
inline SeiWarps sei_warps;
template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  static_assert(sizeof(V) <= sizeof(uint64_t), "one slot per lane");
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  memcpy(&sei_warps.slot[warp][lane], &v, sizeof(V));
  sei_warps.bar[warp].wait();
  V out;
  memcpy(&out, &sei_warps.slot[warp][lane ^ lane_mask], sizeof(V));
  sei_warps.bar[warp].wait();
  return out;
}

// dynamic shared memory: one buffer for the block that runs, NaN-filled at
// each launch so that a read of an element no thread wrote shows
inline std::vector<float4> sei_dynamic_smem;
#define SEI_DYNAMIC_SMEM(type, name) \
  type* name = reinterpret_cast<type*>(sei_dynamic_smem.data())

// the tensor-core paths are not emulated
[[noreturn]] inline void sei_not_emulated() { abort(); }
inline void ldmatrix_x4(unsigned (&)[4], const void*) { sei_not_emulated(); }
inline void ldmatrix_x4_trans(unsigned (&)[4], const void*) { sei_not_emulated(); }
inline void mma_bf16_16816(float (&)[4], const unsigned (&)[4], unsigned, unsigned) {
  sei_not_emulated();
}

template <typename... P>
auto sei_host_launch(dim3 grid, dim3 block, void (*kernel)(P...)) {
  return [=](auto... args) {
    for (unsigned w = 0; w * 32 < block.x; ++w)
      sei_warps.bar[w].n = std::min(32u, block.x - 32 * w);
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          sei_barrier.n = block.x;
          std::vector<std::thread> threads;
          for (unsigned t = 0; t < block.x; ++t)
            threads.emplace_back([=] {
              blockIdx = dim3(bx, by, bz);
              threadIdx = dim3(t);
              kernel(args...);
            });
          for (auto& th : threads) th.join();
        }
  };
}
#define SEI_LAUNCH(grid, block, stream, ...) ((void)(stream), sei_host_launch(grid, block, __VA_ARGS__))
inline void sei_dynamic_smem_alloc(size_t bytes) {
  const float nan = NAN;
  sei_dynamic_smem.assign((bytes + 15) / 16, float4{nan, nan, nan, nan});
}
#define SEI_LAUNCH_SMEM(grid, block, smem, stream, ...) \
  ((void)(stream), sei_dynamic_smem_alloc(smem), sei_host_launch(grid, block, __VA_ARGS__))
"""


def build(root: Path, source: str, variants: dict[str, list[str]]) -> dict[str, Path]:
    """Compile ``csrc/<source>`` for the CPU once per variant (name -> ``-D``
    macros), the g++ processes side by side; returns name -> shared library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    stub = root / "stub"
    stub.mkdir(exist_ok=True)
    (stub / "cuda_runtime.h").write_text(STUB)
    (stub / "cuda_bf16.h").write_text('#pragma once\n#include "cuda_runtime.h"\n')
    procs = {}
    for name, defines in variants.items():
        lib = root / f"lib_{Path(source).stem}_{name}.so"
        cmd = ["g++", "-std=c++17", "-O1", "-fno-strict-aliasing", "-fPIC", "-shared",
               "-pthread", "-x", "c++", *(f"-D{d}" for d in defines), "-I", str(stub),
               "-I", str(CSRC), str(CSRC / source), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate(timeout=TIMEOUT_S)[0]
        assert proc.returncode == 0, f"g++ failed on {source} ({name}):\n{log}"
        libs[name] = lib
    return libs


def run(root: Path, runner: str, lib: Path, inputs: dict[str, np.ndarray]) -> dict:
    """Save ``inputs``, run the ``runner`` script on ``lib`` in a subprocess
    (``runner.py LIB INPUTS.npz OUTPUTS.npz``) and return its outputs."""
    script = root / f"runner_{lib.stem}.py"
    script.write_text(runner)
    inp, out = root / f"in_{lib.stem}.npz", root / f"out_{lib.stem}.npz"
    np.savez(inp, **inputs)
    proc = subprocess.run([sys.executable, str(script), str(lib), str(inp), str(out)],
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, f"emulated run ({lib.name}) failed:\n{proc.stdout}\n{proc.stderr}"
    return dict(np.load(out))
