"""Run a CUDA source's kernels on the CPU: their index logic, not their timing.

A source under ``sei_tpu_torch/ops/csrc`` is compiled as it is by the host's
``g++`` against a small stub of the CUDA features the kernels use
(:data:`STUB`, written as ``cuda_runtime.h``): each CUDA thread of a block
runs as a ``std::thread`` (the blocks one after another, so ``__shared__``
arrays are plain statics and dynamic shared memory one buffer, filled before
each block with the word ``0x7FC07FC0``, a NaN whether read as f32 or as
either bf16 half), ``__syncthreads`` is a barrier, ``__shfl_xor_sync`` an
exchange between the 32 threads of a warp at a barrier of their own
(``__syncwarp`` that barrier alone), ``ldmatrix_x4``, ``ldmatrix_x4_trans`` and ``mma_bf16_16816`` the same
exchange of row addresses or fragment registers, gathered by the PTX
layouts (the mma sums exact bf16 products in f32), ``cp.async`` a
synchronous copy (zero-filled where the kernel asks for none), the card
has 132 SMs that hold one block of any kernel each, ``atomicInc`` is a
locked update, ``__threadfence`` a fence, ``__ldcg`` a plain load,
``cudaMemcpyFromSymbol`` a copy of the host variable, ``cudaGetErrorString``
a fixed text, ``rsqrtf`` is
``1 / sqrtf``, ``blockDim`` and ``gridDim`` are the launch's, and ``float4``,
``erff``, ``expf`` and ``INFINITY`` come from the host.  Without
``__CUDACC__`` the GEMM sources leave out their tensor-core kernels, whose
entry points then refuse.
The shared library is loaded with ``ctypes`` in a subprocess (a fault there
fails the test instead of the worker), called on inputs from an ``.npz``
file, and its outputs come back in another.  This checks a kernel's tiling,
staging, fragment layouts, masks and strides, not the GPU compiler:
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` do that on the card.
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
// Host stand-ins for the CUDA features of the kernels (one block at a time,
// one std::thread per CUDA thread)
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
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
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline double div_rn_f64(double a, double b) { return a / b; }
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
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef struct CUstream_st* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "error" : "no error"; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
// the emulated card has the H100's 132 SMs
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

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

// atomics and fences (the blocks run one after another; the counter is
// taken by one thread of a block at a time)
inline std::mutex sei_atomic_mutex;
inline unsigned atomicInc(unsigned* a, unsigned limit) {
  std::lock_guard<std::mutex> lock(sei_atomic_mutex);
  const unsigned old = *a;
  *a = old >= limit ? 0u : old + 1u;
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <typename V>
inline V __ldcg(const V* p) { return *p; }
enum cudaMemcpyKind { cudaMemcpyDeviceToHost = 2 };
template <typename S>
inline cudaError_t cudaMemcpyFromSymbol(void* dst, const S& symbol, size_t count,
                                        size_t offset = 0,
                                        cudaMemcpyKind = cudaMemcpyDeviceToHost) {
  memcpy(dst, reinterpret_cast<const char*>(&symbol) + offset, count);
  return cudaSuccess;
}

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

// __syncwarp: the 32 lanes of the warp meet at its barrier
inline void __syncwarp(unsigned = 0xffffffffu) { sei_warps.bar[threadIdx.x / 32].wait(); }

// dynamic shared memory: one buffer for the block that runs, filled before
// each block with the word 0x7FC07FC0, a NaN read as one f32 or as either
// bf16 half, so that a read of an element no thread wrote shows
inline std::vector<float4> sei_dynamic_smem;
inline void sei_dynamic_smem_fill() {
  const uint32_t word = 0x7FC07FC0u;
  for (float4& v : sei_dynamic_smem) {
    memcpy(&v.x, &word, 4);
    memcpy(&v.y, &word, 4);
    memcpy(&v.z, &word, 4);
    memcpy(&v.w, &word, 4);
  }
}
#define SEI_DYNAMIC_SMEM(type, name) \
  type* name = reinterpret_cast<type*>(sei_dynamic_smem.data())

// The tensor-core building blocks of common.cuh, from the PTX ISA's
// fragment layouts, on the same warp exchange: each lane posts its row
// address (ldmatrix) or its fragment registers (mma) in a slot of its own,
// the warp meets at its barrier, each lane gathers what the layout gives it,
// and the warp meets again before a slot is reused.
struct SeiFrags {
  uint32_t slot[32][32][6];
};
inline SeiFrags sei_frags;

inline uint16_t sei_b16(const void* row, int col) {
  uint16_t v;
  memcpy(&v, static_cast<const char*>(row) + 2 * col, 2);
  return v;
}

// ldmatrix .x4 (.trans): lane l names row l % 8 of matrix l / 8 (16 bytes);
// r[m] of lane l is elements (l / 4, 2 (l % 4) + j) of matrix m, j = 0, 1,
// low half first (trans: elements (2 (l % 4) + j, l / 4))
inline void sei_ldmatrix(unsigned (&r)[4], const void* smem, bool trans) {
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  memcpy(&sei_warps.slot[warp][lane], &smem, sizeof(smem));
  sei_warps.bar[warp].wait();
  for (int m = 0; m < 4; ++m) {
    uint16_t e[2];
    for (int j = 0; j < 2; ++j) {
      const int row = trans ? 2 * (lane % 4) + j : lane / 4, col = trans ? lane / 4 : 2 * (lane % 4) + j;
      const void* addr;
      memcpy(&addr, &sei_warps.slot[warp][8 * m + row], sizeof(addr));
      e[j] = sei_b16(addr, col);
    }
    r[m] = uint32_t(e[0]) | (uint32_t(e[1]) << 16);
  }
  sei_warps.bar[warp].wait();
}
inline void ldmatrix_x4(unsigned (&r)[4], const void* smem) { sei_ldmatrix(r, smem, false); }
inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) { sei_ldmatrix(r, smem, true); }

inline float sei_bf(uint32_t reg, int j) { return __uint_as_float(j ? reg & 0xffff0000u : reg << 16); }

// mma.m16n8k16 bf16, f32 accumulators: A 16x16 row-major (lane l: a[0] row
// l/4, columns 2 (l%4) + j; a[1] row l/4 + 8; a[2], a[3] the same 8 columns
// on), B 16x8 col-major (b0: rows 2 (l%4) + j, column l/4; b1: rows 8 on),
// d[e]: row l/4 + 8 (e / 2), column 2 (l%4) + e % 2.  Products of bf16 are
// exact in f32; the sum runs over k in ascending order.
inline void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* mine = sei_frags.slot[warp][lane];
  memcpy(mine, a, 16);
  mine[4] = b0;
  mine[5] = b1;
  sei_warps.bar[warp].wait();
  for (int e = 0; e < 4; ++e) {
    const int row = lane / 4 + 8 * (e / 2), col = 2 * (lane % 4) + e % 2;
    float acc = d[e];
    for (int kk = 0; kk < 16; ++kk) {
      // A (row, kk): lane 4 (row % 8) + (kk % 8) / 2, register (kk / 8) * 2 + row / 8
      const uint32_t* la = sei_frags.slot[warp][4 * (row % 8) + (kk % 8) / 2];
      const float x = sei_bf(la[(kk / 8) * 2 + row / 8], kk % 2);
      // B (kk, col): lane 4 col + (kk % 8) / 2, register b0 or b1
      const uint32_t* lb = sei_frags.slot[warp][4 * col + (kk % 8) / 2];
      const float y = sei_bf(lb[4 + kk / 8], kk % 2);
      acc += x * y;
    }
    d[e] = acc;
  }
  sei_warps.bar[warp].wait();
}

template <typename... P>
auto sei_host_launch(dim3 grid, dim3 block, void (*kernel)(P...)) {
  return [=](auto... args) {
    for (unsigned w = 0; w * 32 < block.x; ++w)
      sei_warps.bar[w].n = std::min(32u, block.x - 32 * w);
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          sei_dynamic_smem_fill();
          sei_barrier.n = block.x;
          std::vector<std::thread> threads;
          for (unsigned t = 0; t < block.x; ++t)
            threads.emplace_back([=] {
              blockIdx = dim3(bx, by, bz);
              threadIdx = dim3(t);
              blockDim = block;
              gridDim = grid;
              kernel(args...);
            });
          for (auto& th : threads) th.join();
        }
  };
}
#define SEI_LAUNCH(grid, block, stream, ...) ((void)(stream), sei_host_launch(grid, block, __VA_ARGS__))
inline void sei_dynamic_smem_alloc(size_t bytes) { sei_dynamic_smem.resize((bytes + 15) / 16); }
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
