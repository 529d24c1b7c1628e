// ln_rows: LayerNorm over the channel axis of a (rows, C) matrix, with the
// cyclic shift and window partition folded into the load.  Storage type T
// (float or bf16) for x and the output; f32 statistics and f32 gamma/beta.
//
// Replaces the LN1/LN2 stages of the TPU trunk kernel
// (sei_tpu/ops/swin_trunk.py _fwd_kernel -> _ln_fwd, :242-249, and the roll +
// _window_tokens of :263-270, :432-433; in bf16 the output is cast before
// the GEMM that reads it, :429-430 and :537-539).  On the H100 it is bound by
// bytes: each row is read once and written once (2 x sizeof(T) x C bytes per
// row, a few flops per byte; 3.35 TB/s).  Both kernels compute two-pass
// mean/variance in f32, rsqrtf, eps 1e-5 as the reference; the window gather
// is an index computation on the load (no separate roll/partition pass over
// memory), and the output is rounded to T once, on the store.
//
// Two kernels, one per storage type:
//
// - f32 (ln_rows_kernel<float>, the eval and the f32 step): one warp per
//   row, the row held in registers (C <= 256, 8 values per lane), the sums
//   by warp shuffles.
//
// - bf16 (ln_rows_vec_kernel, every bf16 call; C % 4 == 0, C <= 256, x and
//   the output aligned to 4 elements, which the wrapper checks).  A row is 4
//   channels per 8-byte access spread over SEI_LN_BF16_LANES lanes (at C =
//   180 and 16 lanes 45 of the 48 slots of 4 channels do work; one warp per
//   row with 2-byte loads kept 70% of its lanes busy), a warp runs 32 /
//   LANES rows at once, their sums by butterflies inside each lane group,
//   and writes each row as 8-byte stores.  Each warp holds SEI_LN_BF16_STAGES
//   steps in registers: the loads of the next STAGES - 1 are issued (the
//   window map's index arithmetic included) before one is computed.  gamma
//   and beta sit in shared memory, read as float4 at each lane's channels.
//   The grid is one wave (blocks per SM from the occupancy calculator), each
//   warp walking row groups gridDim * WARPS apart.  The build shipped (16
//   lanes, one step per warp, 16 warps, two blocks per SM) was the fastest
//   of dgrad_tile_sweep.py --ln-bf16's builds: on the H100 the four calls of
//   a SwinBlock at T = 36864 take about 0.045 ms, 70% of their byte bound,
//   against 0.063 for the one-warp-per-row kernel (its windowed call at 40%)
//   (PERF.md).  Rows loaded ahead in registers were slower, and so was a
//   cp.async ring of 2 or 4 stages per warp in shared memory (measured
//   before it was taken out): more resident warps hide the load latency
//   better than fewer warps holding more rows each.

#include "common.cuh"

// the bf16 kernel's build switches (dgrad_tile_sweep.py --ln-bf16)
#ifndef SEI_LN_BF16_LANES
#define SEI_LN_BF16_LANES 16  // lanes per row
#endif
#ifndef SEI_LN_BF16_STAGES
#define SEI_LN_BF16_STAGES 1  // steps a warp holds: STAGES - 1 loaded ahead of the one computed
#endif
#ifndef SEI_LN_BF16_WARPS
#define SEI_LN_BF16_WARPS 16  // warps per block
#endif
#ifndef SEI_LN_BF16_MINB
#define SEI_LN_BF16_MINB 2  // blocks per SM the registers are capped for
#endif

namespace {

constexpr int kMaxPerLane = 8;  // C <= 32 * 8 = 256 channels
constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out,
               long long rows, int C, float eps, WinMap map) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + row_to_pixel(row, map) * C;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    const float d = c < C ? v[i] - mu : 0.f;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)C + eps);
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = from_f<T>((v[i] - mu) * inv * gamma[c] + beta[c]);
  }
}

// ---- the bf16 kernel ---------------------------------------------------------

constexpr int kLanes = SEI_LN_BF16_LANES;
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kStages = SEI_LN_BF16_STAGES;
constexpr int kVecWarps = SEI_LN_BF16_WARPS;
constexpr int kVecThreads = kVecWarps * 32;
constexpr int kMaxQuads = 64;  // C <= 256: 64 quads of 4 channels
constexpr int kMaxSlots = kMaxQuads / kLanes;
static_assert(kLanes == 8 || kLanes == 16 || kLanes == 32, "8, 16 or 32 lanes per row");
static_assert(kStages >= 1 && kStages <= 4, "1 to 4 steps per warp");
static_assert(kVecWarps >= 1 && kVecWarps <= 32, "at most 1024 threads");

typedef Pack<bf16, 4> Quad;

// a step's SLOTS quads of one lane (quad q0 + kLanes s of its lane group's row)
template <int SLOTS>
struct Step {
  Quad q[SLOTS];
};

// issue the lane's loads of `row` into step `st`; zeros and no load past
// `rows` or C
template <int SLOTS>
__device__ __forceinline__ void load_row(Step<SLOTS>& st, const bf16* x, long long row,
                                         long long rows, int C, int q0, const WinMap& map) {
  const bool ok = row < rows;
  const long long pix = ok ? row_to_pixel(row, map) * C : 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int c = 4 * (q0 + kLanes * s);
    st.q[s] = ok && c < C ? load_pack<bf16, 4>(x + pix + c) : zero_pack<bf16, 4>();
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kVecThreads, SEI_LN_BF16_MINB)
ln_rows_vec_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ out, long long rows, int C,
                   float eps, WinMap map) {
  constexpr int D = kStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanes;  // the lane group's row within the warp's
  const int q0 = lane % kLanes;   // the lane's first quad
  __shared__ __align__(16) float sgam[4 * kMaxQuads], sbet[4 * kMaxQuads];
  for (int c = threadIdx.x; c < 4 * kMaxQuads; c += kVecThreads) {
    sgam[c] = c < C ? gamma[c] : 0.f;
    sbet[c] = c < C ? beta[c] : 0.f;
  }
  __syncthreads();

  // warp step k takes the row group gw + k * nw (kRowsPerWarp rows); a warp
  // walks while its group exists, so every lane of it runs each step.  Step
  // k lives in slot k % D; the loads of D - 1 steps are in flight while one
  // is computed.
  const long long groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long nw = (long long)gridDim.x * kVecWarps;
  const long long gw = (long long)blockIdx.x * kVecWarps + warp;
  Step<SLOTS> buf[D];
#pragma unroll
  for (int d = 0; d < D - 1; ++d)
    load_row<SLOTS>(buf[d], x, (gw + d * nw) * kRowsPerWarp + sub, rows, C, q0, map);

  for (long long k0 = 0; gw + k0 * nw < groups; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long k = k0 + d;
      if (gw + k * nw >= groups) break;  // uniform across the warp
      const int ahead = (d + D - 1) % D;  // the slot step k - 1 used (k's own when D = 1)
      load_row<SLOTS>(buf[ahead], x, (gw + (k + D - 1) * nw) * kRowsPerWarp + sub, rows, C, q0,
                      map);
      const long long row = (gw + k * nw) * kRowsPerWarp + sub;
      float v[4 * SLOTS];
      float sx = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[4 * s + j] = to_f(buf[d].q[s].v[j]);
          sx += v[4 * s + j];
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) sx += __shfl_xor_sync(0xffffffffu, sx, o);
      const float mu = sx / (float)C;
      float ss = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const bool in_row = 4 * (q0 + kLanes * s) < C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dd = in_row ? v[4 * s + j] - mu : 0.f;
          ss += dd * dd;
        }
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / (float)C + eps);
      if (row < rows) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int c = 4 * (q0 + kLanes * s);
          if (c >= C) continue;
          const float4 gm = *reinterpret_cast<const float4*>(sgam + c);
          const float4 bt = *reinterpret_cast<const float4*>(sbet + c);
          const float gmv[4] = {gm.x, gm.y, gm.z, gm.w}, btv[4] = {bt.x, bt.y, bt.z, bt.w};
          Quad o;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o.v[j] = from_f<bf16>((v[4 * s + j] - mu) * inv * gmv[j] + btv[j]);
          store_pack<bf16, 4>(out + row * C + c, o);
        }
      }
    }
  }
}

template <int S>
struct SlotCount {
  static constexpr int value = S;
};

// f(SlotCount<S>{}) with S = ceil(C / 4 / kLanes), 1 <= S <= kMaxSlots
template <int S = 1, typename F>
void with_slots(int slots, const F& f) {
  if constexpr (S < kMaxSlots) {
    if (slots > S) return with_slots<S + 1>(slots, f);
  }
  f(SlotCount<S>{});
}

bool vec_takes(int C) { return C > 0 && C <= 4 * kMaxQuads && C % 4 == 0; }

}  // namespace

extern "C" const char* sei_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// f32 storage (bf16 calls: sei_ln_rows_bf16)
extern "C" int sei_ln_rows(int device, const void* x,
                           const float* gamma, const float* beta, void* out,
                           long long rows, int C, float eps, int windowed, int H,
                           int W, int ws, int shift, void* stream) {
  if (C <= 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const WinMap map{windowed, H, W, ws, shift};
  SEI_LAUNCH((unsigned)blocks, kWarpsPerBlock * 32, (cudaStream_t)stream, ln_rows_kernel<float>)(
      static_cast<const float*>(x), gamma, beta, static_cast<float*>(out), rows, C, eps, map);
  return (int)cudaGetLastError();
}

// bf16 storage: x and out aligned to 4 elements, C % 4 == 0; `blocks` of
// the vector kernel (sei_ln_rows_bf16_blocks_per_sm: one wave)
extern "C" int sei_ln_rows_bf16(int device, const void* x, const float* gamma, const float* beta,
                                void* out, long long rows, int C, float eps, int blocks,
                                int windowed, int H, int W, int ws, int shift, void* stream) {
  if (!vec_takes(C) || blocks <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  with_slots((C / 4 + kLanes - 1) / kLanes, [&](auto sl) {
    constexpr int S = decltype(sl)::value;
    SEI_LAUNCH(blocks, kVecThreads, (cudaStream_t)stream, ln_rows_vec_kernel<S>)(
        static_cast<const bf16*>(x), gamma, beta, static_cast<bf16*>(out), rows, C, eps, map);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// blocks of the bf16 kernel one SM holds at C (the wrapper's grid: one wave)
extern "C" int sei_ln_rows_bf16_blocks_per_sm(int device, int C) {
  if (!vec_takes(C) || cudaSetDevice(device) != cudaSuccess) return 0;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  with_slots((C / 4 + kLanes - 1) / kLanes, [&](auto sl) {
    constexpr int S = decltype(sl)::value;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ln_rows_vec_kernel<S>,
                                                        kVecThreads, 0);
  });
  return err == cudaSuccess ? blocks : 0;
}

// the bf16 kernel's build: 0 lanes per row, 1 steps per warp, 2 warps per
// block, 3 blocks per SM its registers are capped for
extern "C" int sei_ln_rows_bf16_config(int what) {
  const int config[] = {kLanes, kStages, kVecWarps, SEI_LN_BF16_MINB};
  return what >= 0 && what < 4 ? config[what] : -1;
}
