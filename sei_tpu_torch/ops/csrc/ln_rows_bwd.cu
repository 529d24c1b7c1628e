// ln_rows_bwd: backward of ln_rows (LayerNorm over the channel axis, eps
// 1e-5, f32 statistics) with the window map folded into the load of x and the
// store of dx, and an optional residual gradient added on the store:
//   dx[p(r)] = dres[p(r)] + inv * (g - mean(g) - xhat * mean(g xhat)),
//   g = dz[r] * gamma,  xhat = (x[p(r)] - mu) * inv,
//   dgamma = sum_r dz[r] xhat,  dbeta = sum_r dz[r],
// with p = row_to_pixel (common.cuh): window reverse + unshift on the store,
// the mirror of ln_rows' shift + window partition on the load.  x has the
// storage type T; dz, dres and dx are f32 or T per call (template
// parameters): in bf16 the LN2 backward reads an f32 dz and the bf16
// block-output gradient and writes the f32 residual gradient dx2, the LN1
// backward reads the bf16 da and the f32 dx2 and writes the block's bf16 dx
// (sei_tpu/ops/swin_trunk.py :672, :711, :854-858).  dgamma and dbeta are
// always f32.
//
// Replaces the LN backward stages of the TPU trunk's backward kernel
// (sei_tpu/ops/swin_trunk.py _ln_bwd :252-257, called from _block_bwd_image
// :672 and :855-857, with the un-window and roll of :851-853, the residual
// add dx = dx2 + ... of :857 / :711, and the dgamma / dbeta sums of :670-671
// and :855-856).  On the H100 it is bound by bytes: each row reads x, dz and
// dres once and writes dx once (4 x 2-4 bytes per channel, a few flops per
// byte); at C = 180 the bf16 step's LN2 call moves 2160 bytes a row and its
// LN1 call 1800.
//
// Two kernels, one per storage type:
//
// - f32 (ln_rows_bwd_kernel, the trunk's f32 recompute backward): one warp
//   per row, the row in registers (C <= 256, 8 values per lane), the
//   statistics recomputed from x in f32 exactly as ln_rows computes them;
//   each warp keeps its dgamma/dbeta sums in registers over the rows it
//   walks, the block reduces its warps in shared memory and writes one (C,)
//   partial per block, which the caller sums.
//
// - bf16 (ln_rows_bwd_vec_kernel, every bf16 call; C % 4 == 0, C <= 256, each
//   buffer aligned to 4 elements, which the wrapper checks).  A row is 4
//   channels per access (8 bytes of bf16, 16 of f32; every row the trunk
//   passes starts at a whole pixel, so at a multiple of that) spread over
//   SEI_LN_BWD_BF16_LANES lanes: at C = 180 and 16 lanes 45 of the 48 slots
//   of 4 channels do work (one warp per row with scalar loads kept 70% of its
//   lanes busy), and a warp runs 32 / LANES rows at once, their sums by
//   butterflies inside each lane group.  Each warp keeps a ring of
//   SEI_LN_BWD_BF16_STAGES steps in shared memory (fewer where a wide C
//   would overflow it), filled by cp.async, each lane copying its own quads
//   of x, dz and dres and reading back only those (no barrier between
//   lanes): while one step is computed the copies of the next STAGES - 1
//   are in flight, without the registers a second row held in them would
//   cost (the first designs spilled there); copies past `rows` or C are
//   zero-fills that read nothing.  The statistics are
//   those of the f32 kernel (two-pass mean / variance over the row in f32,
//   rsqrtf, eps), the output rounded once on the store.  The grid is one
//   wave (blocks per SM from the occupancy calculator), each warp walking
//   row groups gridDim * WARPS apart.  dgamma and dbeta leave the call
//   finished, in a fixed order: each block sums its warps in shared memory
//   into one partial (C dgamma then C dbeta floats), and the last block to
//   finish sums the partials in block order (a ticket counter that only
//   signals completion; atomicInc wraps it back to 0, so every call and
//   every replay of a captured graph finds it at 0; one counter per
//   device, so two calls must not run at once on two streams), or, with
//   SEI_LN_BWD_BF16_TICKET = 0, a second kernel does (ln_rows_bwd_sum_kernel,
//   one block per 16 float4 columns).  No value is summed by an atomic: two
//   runs give the same bits.  The build shipped (16 lanes, two stages, 16
//   warps, the last block summing) was the fastest of dgrad_tile_sweep.py
//   --ln-bwd-bf16's eight: on the H100 the bf16 step's LN2 + LN1 take
//   0.069 ms per SwinBlock at T = 36864, 63% of their byte bound, against
//   0.113 for the one-warp-per-row kernel and its two torch sums (PERF.md).

#include "common.cuh"

// the bf16 kernel's build switches (dgrad_tile_sweep.py --ln-bwd-bf16)
#ifndef SEI_LN_BWD_BF16_LANES
#define SEI_LN_BWD_BF16_LANES 16  // lanes per row
#endif
#ifndef SEI_LN_BWD_BF16_STAGES
#define SEI_LN_BWD_BF16_STAGES 2  // stages of each warp's cp.async ring (fewer where C needs)
#endif
#ifndef SEI_LN_BWD_BF16_WARPS
#define SEI_LN_BWD_BF16_WARPS 16  // warps per block
#endif
#ifndef SEI_LN_BWD_BF16_MINB
#define SEI_LN_BWD_BF16_MINB 1  // blocks per SM the registers are capped for
#endif
#ifndef SEI_LN_BWD_BF16_TICKET
#define SEI_LN_BWD_BF16_TICKET 1  // 1: the last block sums the partials; 0: a second kernel
#endif

namespace {

constexpr int kMaxPerLane = 8;  // C <= 32 * 8 = 256 channels
constexpr int kWarpsPerBlock = 8;

template <typename T, typename TDZ, typename TRES, typename TDX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const TDZ* __restrict__ dz, const TRES* __restrict__ dres,
                   TDX* __restrict__ dx, float* __restrict__ dgamma_part,
                   float* __restrict__ dbeta_part, long long rows, int C,
                   float eps, WinMap map) {
  __shared__ float sg[kWarpsPerBlock][32 * kMaxPerLane];
  __shared__ float sb[kWarpsPerBlock][32 * kMaxPerLane];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float gacc[kMaxPerLane], bacc[kMaxPerLane], gm[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    gacc[i] = 0.f;
    bacc[i] = 0.f;
    const int c = lane + 32 * i;
    gm[i] = c < C ? gamma[c] : 0.f;
  }

  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + warp; row < rows;
       row += stride) {  // uniform across the warp
    const long long pix = row_to_pixel(row, map) * C;
    const T* xr = x + pix;
    const TDZ* dzr = dz + row * C;
    const TRES* rr = dres ? dres + pix : nullptr;
    // every load of the row issued up front (x, dz and dres are independent)
    float v[kMaxPerLane], g[kMaxPerLane], dzv[kMaxPerLane], rv[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f(xr[c]) : 0.f;
      dzv[i] = c < C ? to_f(dzr[c]) : 0.f;
      rv[i] = (rr && c < C) ? to_f(rr[c]) : 0.f;
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
    float sg_ = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      const float d = dzv[i];
      v[i] = c < C ? (v[i] - mu) * inv : 0.f;  // xhat
      g[i] = d * gm[i];
      gacc[i] = fmaf(d, v[i], gacc[i]);
      bacc[i] += d;
      sg_ += g[i];
      sgx = fmaf(g[i], v[i], sgx);
    }
    const float mean_g = warp_sum(sg_) / (float)C;
    const float mean_gx = warp_sum(sgx) / (float)C;
    TDX* dxr = dx + pix;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < C) dxr[c] = from_f<TDX>((g[i] - mean_g - v[i] * mean_gx) * inv + rv[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    sg[warp][lane + 32 * i] = gacc[i];
    sb[warp][lane + 32 * i] = bacc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kWarpsPerBlock * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarpsPerBlock; ++wi) {
      a += sg[wi][c];
      b += sb[wi][c];
    }
    dgamma_part[(long long)blockIdx.x * C + c] = a;
    dbeta_part[(long long)blockIdx.x * C + c] = b;
  }
}

// ---- the bf16 kernel ---------------------------------------------------------

constexpr int kLanes = SEI_LN_BWD_BF16_LANES;
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kStages = SEI_LN_BWD_BF16_STAGES;
constexpr int kVecWarps = SEI_LN_BWD_BF16_WARPS;
constexpr int kVecThreads = kVecWarps * 32;
constexpr int kMaxQuads = 64;  // C <= 256: 64 quads of 4 channels
constexpr int kMaxSlots = kMaxQuads / kLanes;
constexpr int kSumCols = 16;  // float4 columns of the partials per block of the sum kernel
constexpr size_t kSmemBudget = 220 * 1024;  // of the 227 KB a block may hold, beside sgam
static_assert(kLanes == 8 || kLanes == 16 || kLanes == 32, "8, 16 or 32 lanes per row");
static_assert(kStages >= 2, "a stage in use and at least one in flight");
static_assert(kVecWarps >= 1 && kVecWarps <= 16, "at most 512 threads");

// the completion ticket of the last-block sum, one per device
__device__ unsigned g_ln_bwd_ticket = 0;

// a and b summed over the lanes of a lane group (xor butterflies inside it)
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

__device__ __forceinline__ float group_sum(float a) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// One warp's stage of the ring in shared memory: one row per lane group,
// SLOTS quads of x, dz and dres per lane (quad q0 + kLanes s of the row at
// index (sub SLOTS + s) kLanes + q0, so each lane reads back what it copied).
// The ring holds as many stages as the budget allows, up to kStages.
template <typename TDZ, typename TRES, int SLOTS>
struct Ring {
  static constexpr int kQuads = 32 * SLOTS;
  static constexpr size_t kZ = kQuads * sizeof(Pack<bf16, 4>);  // dz's offset
  static constexpr size_t kR = kZ + kQuads * sizeof(Pack<TDZ, 4>);  // dres's offset
  static constexpr size_t kBytes = kR + kQuads * sizeof(Pack<TRES, 4>);
  static constexpr int kDepth =
      kVecWarps * kStages * kBytes <= kSmemBudget ? kStages
                                                  : (int)(kSmemBudget / (kVecWarps * kBytes));
  static_assert(kDepth >= 2, "two stages of every warp fit the block's shared memory");
  // dynamic shared memory of a block: the ring, later the warps' dgamma |
  // dbeta sums (2 C floats each) and the partials' sum scratch
  static constexpr size_t smem() {
    const size_t ring = kVecWarps * kDepth * kBytes;
    const size_t red = kVecWarps * 8 * kLanes * SLOTS * sizeof(float);
    const size_t scratch = (kVecThreads > 128 ? kVecThreads : 128) * sizeof(float4);
    return ring > red ? (ring > scratch ? ring : scratch) : (red > scratch ? red : scratch);
  }
};

// cp.async the lane's quads of `row` (x and dres at its pixel, dz at the
// row) into stage `st` and commit them as one group; zeros and no load past
// `rows`, past C, or for dres when there is none.  Returns the pixel offset.
template <typename TDZ, typename TRES, int SLOTS>
__device__ __forceinline__ long long stage_row(char* st, const bf16* x, const TDZ* dz,
                                               const TRES* dres, long long row, long long rows,
                                               int C, int sub, int q0, const WinMap& map) {
  typedef Ring<TDZ, TRES, SLOTS> R;
  const bool ok = row < rows;
  const long long pix = ok ? row_to_pixel(row, map) * C : 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int c = 4 * (q0 + kLanes * s);
    const bool valid = ok && c < C;
    const int i = (sub * SLOTS + s) * kLanes + q0;
    cp_async<sizeof(Pack<bf16, 4>)>(reinterpret_cast<Pack<bf16, 4>*>(st) + i, x + pix + c, valid);
    cp_async<sizeof(Pack<TDZ, 4>)>(reinterpret_cast<Pack<TDZ, 4>*>(st + R::kZ) + i,
                                   dz + row * C + c, valid);
    cp_async<sizeof(Pack<TRES, 4>)>(reinterpret_cast<Pack<TRES, 4>*>(st + R::kR) + i,
                                    dres ? dres + pix + c : dres, valid && dres);
  }
  cp_async_commit();
  return pix;
}

// dgamma[c], dbeta[c] for the float4 columns [col0, col1) of the partials
// (P rows of [dgamma | dbeta], 2 C floats each): each thread sums one column
// over the partials sub, sub + subs, ... in order, then the subs in order
// (scratch: max(blockDim, columns) float4 of shared memory)
__device__ __forceinline__ void sum_partials(const float* part, int P, int C, int col0,
                                             int col1, float* dgamma, float* dbeta,
                                             float4* scratch) {
  const int cols = col1 - col0;
  const int subs = max(1, (int)blockDim.x / cols);
  const float4* p4 = reinterpret_cast<const float4*>(part);
  const int pitch = C / 2;  // float4 columns of one partial
  for (int i = threadIdx.x; i < subs * cols; i += blockDim.x) {
    const int sub = i / cols, col = col0 + i % cols;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int b = sub; b < P; b += subs) {
      const float4 v = __ldcg(p4 + (long long)b * pitch + col);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    scratch[i] = a;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    float4 a = scratch[j];
    for (int sub = 1; sub < subs; ++sub) {
      const float4 v = scratch[sub * cols + j];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    const int col = col0 + j;
    float* out = col < C / 4 ? dgamma + 4 * col : dbeta + 4 * (col - C / 4);
    *reinterpret_cast<float4*>(out) = a;
  }
}

template <typename TDZ, typename TRES, typename TDX, int SLOTS>
__global__ void __launch_bounds__(kVecThreads, SEI_LN_BWD_BF16_MINB)
ln_rows_bwd_vec_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                       const TDZ* __restrict__ dz, const TRES* __restrict__ dres,
                       TDX* __restrict__ dx, float* __restrict__ part,
                       float* __restrict__ dgamma, float* __restrict__ dbeta, long long rows,
                       int C, float eps, WinMap map) {
  typedef Ring<TDZ, TRES, SLOTS> R;
  constexpr int D = R::kDepth;
  SEI_DYNAMIC_SMEM(float4, smem);
  __shared__ __align__(16) float sgam[4 * kMaxQuads];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanes;  // the lane group's row within the warp's
  const int q0 = lane % kLanes;   // the lane's first quad
  for (int c = threadIdx.x; c < 4 * kMaxQuads; c += kVecThreads) sgam[c] = c < C ? gamma[c] : 0.f;
  __syncthreads();

  float gacc[4 * SLOTS], bacc[4 * SLOTS];
#pragma unroll
  for (int i = 0; i < 4 * SLOTS; ++i) gacc[i] = bacc[i] = 0.f;

  // warp step k takes the row group gw + k * nw (kRowsPerWarp rows); a warp
  // walks while its group exists, so every lane of it runs each step.  Step
  // k lives in stage k % D; the copies of D - 1 steps are in flight while
  // one is computed.
  const long long groups = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long nw = (long long)gridDim.x * kVecWarps;
  const long long gw = (long long)blockIdx.x * kVecWarps + warp;
  char* ring = reinterpret_cast<char*>(smem) + (size_t)warp * D * R::kBytes;
  long long pix[D];
#pragma unroll
  for (int d = 0; d < D - 1; ++d)
    pix[d] = stage_row<TDZ, TRES, SLOTS>(ring + d * R::kBytes, x, dz, dres,
                                         (gw + d * nw) * kRowsPerWarp + sub, rows, C, sub, q0,
                                         map);

  for (long long k0 = 0; gw + k0 * nw < groups; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long k = k0 + d;
      if (gw + k * nw >= groups) break;  // uniform across the warp
      const int ahead = (d + D - 1) % D;  // the stage step k - 1 used
      pix[ahead] = stage_row<TDZ, TRES, SLOTS>(ring + ahead * R::kBytes, x, dz, dres,
                                               (gw + (k + D - 1) * nw) * kRowsPerWarp + sub,
                                               rows, C, sub, q0, map);
      cp_async_wait<D - 1>();  // step k's copies have landed
      const long long row = (gw + k * nw) * kRowsPerWarp + sub;
      const char* st = ring + d * R::kBytes;
      float v[4 * SLOTS], dzv[4 * SLOTS], g[4 * SLOTS];
      float sx = 0.f, sg_ = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int i = (sub * SLOTS + s) * kLanes + q0;
        const Pack<bf16, 4> xq = reinterpret_cast<const Pack<bf16, 4>*>(st)[i];
        const Pack<TDZ, 4> zq = reinterpret_cast<const Pack<TDZ, 4>*>(st + R::kZ)[i];
        const float4 gm = *reinterpret_cast<const float4*>(sgam + 4 * (q0 + kLanes * s));
        const float gmv[4] = {gm.x, gm.y, gm.z, gm.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * s + j;
          v[e] = to_f(xq.v[j]);
          dzv[e] = to_f(zq.v[j]);
          sx += v[e];
          g[e] = dzv[e] * gmv[j];
          sg_ += g[e];
        }
      }
      group_sum2(sx, sg_);
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
      const float inv = rsqrtf(group_sum(ss) / (float)C + eps);
      float sgx = 0.f;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const bool in_row = 4 * (q0 + kLanes * s) < C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * s + j;
          v[e] = in_row ? (v[e] - mu) * inv : 0.f;  // xhat
          gacc[e] = fmaf(dzv[e], v[e], gacc[e]);
          bacc[e] += dzv[e];
          sgx = fmaf(g[e], v[e], sgx);
        }
      }
      const float mean_g = sg_ / (float)C;
      const float mean_gx = group_sum(sgx) / (float)C;
      if (row < rows) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int c = 4 * (q0 + kLanes * s);
          if (c >= C) continue;
          const Pack<TRES, 4> rq =
              reinterpret_cast<const Pack<TRES, 4>*>(st + R::kR)[(sub * SLOTS + s) * kLanes + q0];
          Pack<TDX, 4> o;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = 4 * s + j;
            o.v[j] = from_f<TDX>((g[e] - mean_g - v[e] * mean_gx) * inv + to_f(rq.v[j]));
          }
          store_pack<TDX, 4>(dx + pix[d] + c, o);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory becomes the warps' sums

  // the warp's lane groups hold the same channels: add them (xor kLanes,
  // 2 kLanes, ...), then warp by warp in shared memory, in warp order
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 4 * SLOTS; ++i) {
      gacc[i] += __shfl_xor_sync(0xffffffffu, gacc[i], o);
      bacc[i] += __shfl_xor_sync(0xffffffffu, bacc[i], o);
    }
  float* red = reinterpret_cast<float*>(smem);  // per warp: dgamma | dbeta
  if (sub == 0) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int c = 4 * (q0 + kLanes * s);
      if (c >= C) continue;
      *reinterpret_cast<float4*>(red + warp * 2 * C + c) =
          make_float4(gacc[4 * s], gacc[4 * s + 1], gacc[4 * s + 2], gacc[4 * s + 3]);
      *reinterpret_cast<float4*>(red + warp * 2 * C + C + c) =
          make_float4(bacc[4 * s], bacc[4 * s + 1], bacc[4 * s + 2], bacc[4 * s + 3]);
    }
  }
  __syncthreads();
  float4* part4 = reinterpret_cast<float4*>(part + (long long)blockIdx.x * 2 * C);
  for (int j = threadIdx.x; j < C / 2; j += kVecThreads) {
    float4 a = reinterpret_cast<const float4*>(red)[j];
#pragma unroll
    for (int w = 1; w < kVecWarps; ++w) {
      const float4 b = reinterpret_cast<const float4*>(red + w * 2 * C)[j];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    part4[j] = a;
  }
#if SEI_LN_BWD_BF16_TICKET
  // the last block to take a ticket sums every block's partial
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(&g_ln_bwd_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    sum_partials(part, gridDim.x, C, 0, C / 2, dgamma, dbeta, smem);
  }
#else
  (void)dgamma;
  (void)dbeta;
#endif
}

// the partials' sum as a kernel of its own: block b takes the float4 columns
// [kSumCols b, kSumCols (b + 1)) of [dgamma | dbeta]
__global__ void __launch_bounds__(kVecThreads)
ln_rows_bwd_sum_kernel(const float* __restrict__ part, int P, int C, float* __restrict__ dgamma,
                       float* __restrict__ dbeta) {
  __shared__ float4 scratch[kVecThreads > kSumCols ? kVecThreads : kSumCols];
  const int col0 = blockIdx.x * kSumCols;
  sum_partials(part, P, C, col0, min(col0 + kSumCols, C / 2), dgamma, dbeta, scratch);
}

template <typename T>
struct Tag {
  typedef T type;
};

template <int S>
struct SlotCount {
  static constexpr int value = S;
};

// f(SlotCount<S>{}) with S = the call's quads per lane, 1 <= S <= kMaxSlots
template <int S = 1, typename F>
void with_slots(int slots, const F& f) {
  if constexpr (S < kMaxSlots) {
    if (slots > S) return with_slots<S + 1>(slots, f);
  }
  f(SlotCount<S>{});
}

// f(Tag<TDZ>{}, Tag<TRES>{}, Tag<TDX>{}, SlotCount<S>{}): the call's buffer
// types (each bf16 or f32 by its flag) and S = ceil(C / 4 / kLanes)
template <typename F>
void with_types(int dz_bf16, int dres_bf16, int dx_bf16, int C, const F& f) {
  const int slots = (C / 4 + kLanes - 1) / kLanes;
  auto dx_t = [&](auto tdz, auto tres) {
    auto go = [&](auto tdx) { with_slots(slots, [&](auto sl) { f(tdz, tres, tdx, sl); }); };
    if (dx_bf16)
      go(Tag<bf16>{});
    else
      go(Tag<float>{});
  };
  auto res_t = [&](auto tdz) {
    if (dres_bf16)
      dx_t(tdz, Tag<bf16>{});
    else
      dx_t(tdz, Tag<float>{});
  };
  if (dz_bf16)
    res_t(Tag<bf16>{});
  else
    res_t(Tag<float>{});
}

}  // namespace

extern "C" int sei_ln_rows_bwd(int device, int is_bf16, const void* x,
                               const float* gamma, const void* dz, int dz_bf16,
                               const void* dres, int dres_bf16, void* dx,
                               int dx_bf16, float* dgamma_part,
                               float* dbeta_part, long long rows, int C,
                               float eps, int blocks, int windowed, int H, int W,
                               int ws, int shift, void* stream) {
  // f32 storage only (bf16 calls: sei_ln_rows_bwd_bf16)
  if (is_bf16 || dz_bf16 || dres_bf16 || dx_bf16) return (int)cudaErrorInvalidValue;
  if (C <= 0 || C > 32 * kMaxPerLane || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (rows < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  SEI_LAUNCH(blocks, kWarpsPerBlock * 32, (cudaStream_t)stream,
             ln_rows_bwd_kernel<float, float, float, float>)(
      static_cast<const float*>(x), gamma, static_cast<const float*>(dz),
      static_cast<const float*>(dres), static_cast<float*>(dx), dgamma_part, dbeta_part, rows,
      C, eps, map);
  return (int)cudaGetLastError();
}

// bf16 storage: x bf16, dz / dres / dx each bf16 or f32 (the flags), every
// buffer aligned to 4 elements; part is a (blocks, 2 C) f32 scratch, dgamma
// and dbeta the (C,) f32 outputs
extern "C" int sei_ln_rows_bwd_bf16(int device, const void* x, const float* gamma,
                                    const void* dz, int dz_bf16, const void* dres,
                                    int dres_bf16, void* dx, int dx_bf16, float* part,
                                    float* dgamma, float* dbeta, long long rows, int C,
                                    float eps, int blocks, int windowed, int H, int W, int ws,
                                    int shift, void* stream) {
  if (C <= 0 || C > 4 * kMaxQuads || C % 4 || blocks <= 0 || rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  cudaStream_t s = (cudaStream_t)stream;
  with_types(dz_bf16, dres_bf16, dx_bf16, C, [&](auto tdz, auto tres, auto tdx, auto sl) {
    typedef typename decltype(tdz)::type TDZ;
    typedef typename decltype(tres)::type TRES;
    typedef typename decltype(tdx)::type TDX;
    constexpr int S = decltype(sl)::value;
    const auto kernel = ln_rows_bwd_vec_kernel<TDZ, TRES, TDX, S>;
    const size_t smem = Ring<TDZ, TRES, S>::smem();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return;
    SEI_LAUNCH_SMEM(blocks, kVecThreads, smem, s, kernel)(
        static_cast<const bf16*>(x), gamma, static_cast<const TDZ*>(dz),
        static_cast<const TRES*>(dres), static_cast<TDX*>(dx), part, dgamma, dbeta, rows, C,
        eps, map);
  });
  if (err != cudaSuccess) return (int)err;
  if (!SEI_LN_BWD_BF16_TICKET) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    SEI_LAUNCH((C / 2 + kSumCols - 1) / kSumCols, kVecThreads, s, ln_rows_bwd_sum_kernel)(
        part, blocks, C, dgamma, dbeta);
  }
  return (int)cudaGetLastError();
}

// blocks of the bf16 kernel one SM holds for a call's types and C (the
// wrapper's grid: one wave)
extern "C" int sei_ln_rows_bwd_bf16_blocks_per_sm(int device, int dz_bf16, int dres_bf16,
                                                  int dx_bf16, int C) {
  if (C <= 0 || C > 4 * kMaxQuads || C % 4 || cudaSetDevice(device) != cudaSuccess) return 0;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  with_types(dz_bf16, dres_bf16, dx_bf16, C, [&](auto tdz, auto tres, auto tdx, auto sl) {
    typedef typename decltype(tdz)::type TDZ;
    typedef typename decltype(tres)::type TRES;
    constexpr int S = decltype(sl)::value;
    const auto kernel = ln_rows_bwd_vec_kernel<TDZ, TRES, typename decltype(tdx)::type, S>;
    const size_t smem = Ring<TDZ, TRES, S>::smem();
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kVecThreads, smem);
  });
  return err == cudaSuccess ? blocks : 0;
}

// the bf16 kernel's build: 0 lanes per row, 1 stages of each warp's ring
// (at most), 2 warps per block, 3 blocks per SM its registers are capped
// for, 4 the last block sums the partials (1) or a second kernel does (0)
extern "C" int sei_ln_rows_bwd_bf16_config(int what) {
  const int config[] = {kLanes, kStages, kVecWarps, SEI_LN_BWD_BF16_MINB, SEI_LN_BWD_BF16_TICKET};
  return what >= 0 && what < 5 ? config[what] : -1;
}

// the completion ticket of `device` into *value (0 between calls)
extern "C" int sei_ln_rows_bwd_bf16_ticket(int device, unsigned* value) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(value, g_ln_bwd_ticket, sizeof(unsigned));
}
