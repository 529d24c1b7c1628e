// window_attn_bwd: gradients of o = softmax(scale * q k^T + bias[h]
// (+ mask[w % nW])) v over windows of N <= 64 tokens, head dim hd <= 32.
// Storage type T (float, or bf16 for the bf16 training recipe) for q, k, v,
// do, dq, dk, dv and the saved probabilities; f32 scores, softmax, ds and
// dbias.
//
// Replaces sei_tpu/ops/attention.py _bwd_kernel (:117-152, called from
// _bwd_pallas :155) and the attention section of the TPU trunk's backward
// (sei_tpu/ops/swin_trunk.py _block_bwd_image :733-805), in both of its
// forms: p recomputed from q, k, bias and mask (with_saved=False, K6), or p
// read from the forward's save (with_saved=True, :742-757; K7), in which case
// neither q k^T nor the softmax is recomputed.  Then
//   dv = p_T^T do,  dp = do v^T,  ds = p (dp - rowsum(dp p)),
//   dq = scale ds_T k,  dk = scale ds_T^T q,  dbias = sum over windows of ds,
// with p_T = p rounded to T (what P.V read in the forward, :767), ds and
// dbias in f32, ds_T = ds rounded to T (:779) and dq, dk, dv rounded to T
// (:797-800).  At the flagship shapes (N = 64, hd = 30) one (window, head)
// pair is 5 x 2 x 64 x 64 x 30 = 1.2 MFLOP against 7 x 64 x 30 elements of
// q, k, v, do, dq, dk, dv (+ 64 x 64 of p when saved): in f32 ~23 flops per
// byte, at the H100's FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20); in bf16
// ~21 with the p read, far below the bf16 ridge of 295, so bytes bound it.
// The f32 kernel can also write att = p v from the p it recomputes (att,
// as window_attn_fwd's out; the TPU trunk derives att from the same p,
// t_parts :768-772), so the trunk's recompute backward launches no
// attention forward: one more 64x64x32 product per pair.
//
// Strides are arguments: the trunk reads q/k/v/do straight from its qkv and
// proj buffers and writes dq/dk/dv into the (B_, N, 3, nh, hd) buffer the
// qkv weight-grad and data-grad GEMMs read.  Every block owns one head and
// walks the windows g, g + groups, ... of its group, summing dbias over
// them; it writes one (N, N) partial, which the caller sums (no atomics, so
// the gradient is the same from run to run).
//
// bf16 (window_attn_bwd_kernel<bf16>, K7 with the saved p): a 128-thread
// block, dbias in registers (thread (j, half) owns column j, rows half,
// half + 2, ...).  Per window: q, k and do staged in shared memory as f32
// padded to 32 (+1 column against bank conflicts), the thread's v row in
// registers, the 64x64 probability tile in shared memory -- loaded from the
// save, or recomputed with the same max-subtracted f32 softmax as
// window_attn_fwd -- the rowsum(dp p) reduced with warp shuffles, and ds
// written over p once dv has read it.
//
// f32 (window_attn_bwd_f32_kernel, K6's recompute and the f32 saved-p form)
// is built for the CUDA cores' FP32 pipe, which an SM issues four warp FMAs
// a clock against one 128-byte shared-memory wavefront:
// - Register micro-tiles.  A block of 256 threads (SEI_ATTN_BWD_F32_THREADS;
//   16 x 16, or 8 x 16 at 128) takes one (window, head) at a time.  Thread
//   (ty, tx) owns the scores of rows ty + 16 r (r < 4) and columns tx + 16 c
//   (c < 4): S, then P, then dP and dS stay in its registers, and per 4-deep
//   step of the head dim it reads 4 + 4 float4 of q and k (do and v) for 64
//   FMAs.  A row's 64 columns sit on 16 lanes of one warp, so row max, row
//   sum and rowsum(dp p) are __shfl_xor_sync butterflies over those lanes.
//   The scores and the softmax are window_attn_f32.cuh's, which the f32
//   forward (window_attn_fwd_f32_kernel) runs too: p is the forward's bit
//   for bit, and so is att.
// - The 64x32 products read P or dS from shared memory as the transposed
//   operand [k][row]: the owner threads write both row-major (for dv and
//   dk) and transposed (for dq and att) before one barrier.  Two
//   products run side by side on half the block each, a 4 x 4 tile of
//   outputs per thread (8 x 4 at 128 threads), 2 float4 reads for 16 FMAs;
//   a lone dq takes the whole block at 4 x 2.  Every output is one FMA chain
//   in ascending order of its reduction index, as the bf16 kernel's.
// - dbias accumulates in the registers of the thread that owns each (i, j)
//   across the block's windows; the block writes one partial.  bias[h] +
//   mask[w % nW] is read into registers while the window is staged.  All
//   of it fits the 128 registers of 2 blocks per SM without a spill once
//   the tensors' window and head offsets are 32-bit and recomputed where
//   used (opaque() below).
// - q, k, v and do are copied by cp.async into one stage: 8-byte copies (a
//   head's row starts at 120-byte steps in the (T, 3C) qkv buffer, so 16
//   bytes would be misaligned), one element where hd, a stride or a pointer
//   is odd.  The stage and the four P / dS tiles take 104 KB of shared
//   memory: 2 blocks per SM (SEI_ATTN_BWD_F32_MINB; each covers the other's
//   copies), and the wrapper sizes groups from the kernel's own occupancy so
//   that the grid is one wave.  (A second stage, to copy the next window
//   during this one, measured no faster and left room for only two tiles,
//   whose rewrite cost a barrier and registers.)

#include <climits>
#include <initializer_list>

#include "window_attn_f32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = AN / 2;  // score rows per thread (half, half + 2, ...)

struct Strides {
  long long w, h, n;  // window, head, token; the head-dim stride is 1
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ mask, const T* __restrict__ p_saved,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dbias_part, long long n_windows,
                       int nh, int N, int hd, int nW, int groups, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdq,
                       Strides sdk, Strides sdv, float scale) {
  __shared__ float qs[AN][AD + 1];
  __shared__ float ks[AN][AD + 1];
  __shared__ float dos[AN][AD + 1];
  __shared__ float ps[AN][AN + 1];
  __shared__ float rowdot[2][AN];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int j = tid & (AN - 1);  // this thread's key / score column
  const int half = tid >> 6;     // score rows half, half + 2, ...
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d0 = half * (AD / 2);  // this thread's half of the head dim

  float dbias[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dbias[r] = 0.f;

  for (long long w = grp; w < n_windows; w += groups) {
    const T* qb = q + w * sq.w + h * sq.h;
    const T* kb = k + w * sk.w + h * sk.h;
    const T* vb = v + w * sv.w + h * sv.h;
    const T* db = dout + w * sdo.w + h * sdo.h;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = tid; idx < AN * AD; idx += kThreads) {
      const int n = idx / AD;
      const int d = idx - n * AD;
      const bool ok = n < N && d < hd;
      qs[n][d] = ok ? to_f(qb[n * sq.n + d]) : 0.f;
      ks[n][d] = ok ? to_f(kb[n * sk.n + d]) : 0.f;
      dos[n][d] = ok ? to_f(db[n * sdo.n + d]) : 0.f;
    }
    float vr[AD];
#pragma unroll
    for (int d = 0; d < AD; ++d) vr[d] = (j < N && d < hd) ? to_f(vb[j * sv.n + d]) : 0.f;

    if (p_saved) {
      // the forward's probabilities, a row per warp
      const T* pw = p_saved + ((w * nh + h) * N) * N;
      for (int i = warp; i < N; i += kThreads / 32) {
        if (lane < N) ps[i][lane] = to_f(pw[i * N + lane]);
        if (lane + 32 < N) ps[i][lane + 32] = to_f(pw[i * N + lane + 32]);
      }
      __syncthreads();
    } else {
      __syncthreads();
      // scores, exactly as window_attn_fwd computes them
      if (j < N) {
        const float* bcol = bias + (long long)h * N * N + j;
        const float* mcol = mask ? mask + (w % nW) * N * N + j : nullptr;
        for (int i = half; i < N; i += 2) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < AD; ++d) s = fmaf(qs[i][d], ks[j][d], s);
          s = s * scale + bcol[i * N];
          if (mcol) s += mcol[i * N];
          ps[i][j] = s;
        }
      }
      __syncthreads();
      for (int i = warp; i < N; i += kThreads / 32) {
        const float a = lane < N ? ps[i][lane] : -INFINITY;
        const float b = lane + 32 < N ? ps[i][lane + 32] : -INFINITY;
        const float m = warp_max(fmaxf(a, b));
        const float ea = lane < N ? expf(a - m) : 0.f;
        const float eb = lane + 32 < N ? expf(b - m) : 0.f;
        const float sum = warp_sum(ea + eb);
        if (lane < N) ps[i][lane] = ea / sum;
        if (lane + 32 < N) ps[i][lane + 32] = eb / sum;
      }
      __syncthreads();
    }

    // dp = do v^T (registers) and the row sums of dp * p
    float dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      float t = 0.f;
      dp[r] = 0.f;
      if (i < N) {  // uniform across the warp
        if (j < N) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < AD; ++d) acc = fmaf(dos[i][d], vr[d], acc);
          dp[r] = acc;
          t = ps[i][j] * acc;
        }
        t = warp_sum(t);
        if (lane == 0) rowdot[warp & 1][i] = t;
      }
    }

    // dv_j = sum_i p_T,ij do_i, this thread's half of the head dim
    if (j < N) {
      float acc[AD / 2];
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float p = round_as<T>(ps[i][j]);
#pragma unroll
        for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = fmaf(p, dos[i][d0 + dd], acc[dd]);
      }
      T* out = dv + w * sdv.w + h * sdv.h + j * sdv.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = from_f<T>(acc[dd]);
    }
    __syncthreads();  // rowdot complete; every read of p done

    // ds = p (dp - rowsum), over p in shared memory; dbias accumulates the
    // f32 ds, dq and dk read it rounded to T
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      if (i < N && j < N) {
        const float ds = ps[i][j] * (dp[r] - (rowdot[0][i] + rowdot[1][i]));
        ps[i][j] = round_as<T>(ds);
        dbias[r] += ds;
      }
    }
    __syncthreads();

    // dk_j = scale sum_i ds_ij q_i
    if (j < N) {
      float acc[AD / 2];
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float s = ps[i][j];
#pragma unroll
        for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = fmaf(s, qs[i][d0 + dd], acc[dd]);
      }
      T* out = dk + w * sdk.w + h * sdk.h + j * sdk.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = from_f<T>(acc[dd] * scale);
    }
    // dq_i = scale sum_j ds_ij k_j, a warp per row, a lane per head-dim entry
    if (lane < hd) {
      T* out = dq + w * sdq.w + h * sdq.h;
      for (int i = warp; i < N; i += kThreads / 32) {
        float acc = 0.f;
        for (int jj = 0; jj < N; ++jj) acc = fmaf(ps[i][jj], ks[jj][lane], acc);
        out[i * sdq.n + lane] = from_f<T>(acc * scale);
      }
    }
  }

  if (j < N) {
    float* part = dbias_part + ((long long)grp * nh + h) * N * N + j;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      if (i < N) part[i * N] = dbias[r];
    }
  }
}

// -- f32: register micro-tiles on the CUDA cores (see the note at the top) --

#ifndef SEI_ATTN_BWD_F32_THREADS
#define SEI_ATTN_BWD_F32_THREADS 256
#endif
#ifndef SEI_ATTN_BWD_F32_MINB
#define SEI_ATTN_BWD_F32_MINB 2
#endif

constexpr int FT = SEI_ATTN_BWD_F32_THREADS;  // threads per block
constexpr int FTY = FT / 16;                  // score row groups, 16 lanes per row
constexpr int FRA = AN / FTY;                 // score rows per thread
constexpr int STAGE = 4 * AN * SP;            // floats of one staged window
constexpr int TILE = AN * PP;                 // floats of one P / dS tile
constexpr int F_SMEM = (STAGE + 4 * TILE) * (int)sizeof(float);
static_assert(FT == 128 || FT == 256, "16 lanes per score row, 4 or 8 rows each");

// window, head and token strides in elements, 32-bit: in 64 bits the
// offsets of eight tensors took the registers whose lack made 2 blocks per
// SM spill (the entry point checks that every offset fits)
struct Strides32 {
  int w, h, n;
};

// the tile's rows < N and columns < hd, times mul, into out[w][h][row][d]
template <int P, int VEC>
__device__ __forceinline__ void store_tile(float* out, Strides32 so, int w, int h, int local,
                                           const float (&acc)[ProdTile<P>::RC][ProdTile<P>::CC],
                                           float mul, int N, int hd) {
  typedef ProdTile<P> TL;
  const int r0 = (local / TL::CX) * TL::RC, c0 = (local % TL::CX) * TL::CC;
  // element offsets in 32 bits, one 64-bit address per store
  const int base = opaque(w) * so.w + opaque(h) * so.h + c0;
#pragma unroll
  for (int r = 0; r < TL::RC; ++r) {
    if (r0 + r >= N) continue;
    const int row = base + (r0 + r) * so.n;
#pragma unroll
    for (int c = 0; c < TL::CC; c += VEC) {
      if (c0 + c >= hd) continue;
      if constexpr (VEC == 2) {  // hd even: a pair is all in or all out
        *reinterpret_cast<float2*>(out + (row + c)) =
            make_float2(acc[r][c] * mul, acc[r][c + 1] * mul);
      } else {
        out[row + c] = acc[r][c] * mul;
      }
    }
  }
}

// one 64 x 32 product on P threads (thread `local` of them), stored
template <int P, int VEC>
__device__ __forceinline__ void product(const float* At, const float* Bm, int local, float* out,
                                        Strides32 so, int w, int h, float mul, int N,
                                        int hd) {
  float acc[ProdTile<P>::RC][ProdTile<P>::CC];
  tile_product<P>(At, Bm, local, acc);
  store_tile<P, VEC>(out, so, w, h, local, acc, mul, N, hd);
}

// q, k, v and do of window w, head h into the stage ([4][AN][SP], f32),
// rows >= N and head-dim entries >= hd zero-filled; VEC elements per
// cp.async
template <int VEC>
__device__ __forceinline__ void stage_window(float* st, const float* q, const float* k,
                                             const float* v, const float* dout, Strides32 sq,
                                             Strides32 sk, Strides32 sv, Strides32 sdo, int w,
                                             int h, int N, int hd) {
  constexpr int PR = AD / VEC;  // copies per row
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dout;
    const Strides32 s = t == 0 ? sq : t == 1 ? sk : t == 2 ? sv : sdo;
    const int base = opaque(w) * s.w + opaque(h) * s.h;
    float* dst = st + t * AN * SP;
    for (int idx = threadIdx.x; idx < AN * PR; idx += FT) {
      const int n = idx / PR;
      const int d = (idx - n * PR) * VEC;
      const bool ok = n < N && d < hd;
      cp_async<4 * VEC>(dst + n * SP + d, src + (ok ? base + n * s.n + d : 0), ok);
    }
  }
}

template <int VEC, bool ATT>
__global__ void __launch_bounds__(FT, SEI_ATTN_BWD_F32_MINB)
window_attn_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, const float* __restrict__ p_saved,
                           const float* __restrict__ dout, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv,
                           float* __restrict__ att, float* __restrict__ dbias_part,
                           int n_windows, int nh, int N, int hd, int nW, int groups,
                           Strides32 sq, Strides32 sk, Strides32 sv, Strides32 sdo,
                           Strides32 sdq, Strides32 sdk, Strides32 sdv, Strides32 sat,
                           float scale) {
  SEI_DYNAMIC_SMEM(float, smem);
  float* const st = smem;                // q, k, v, do of the window
  float* const pr = smem + STAGE;        // P row-major [i][j]: dv = P^T do
  float* const dr = pr + TILE;           // dS row-major: dk = dS^T q
  float* const pt = dr + TILE;           // P^T [j][i]: att = P v
  float* const dt = pt + TILE;           // dS^T: dq = dS k
  const float* const qs = st;
  const float* const ks = st + AN * SP;
  const float* const vs = st + 2 * AN * SP;
  const float* const dos = st + 3 * AN * SP;
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int tx = tid & 15;  // columns tx + 16 c
  const int ty = tid >> 4;  // rows ty + FTY r

  float dbias[FRA][4];
#pragma unroll
  for (int r = 0; r < FRA; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dbias[r][c] = 0.f;

  for (int w = grp; w < n_windows; w += groups) {
    __syncthreads();  // the previous window is done with the stage and the tiles
    stage_window<VEC>(st, q, k, v, dout, sq, sk, sv, sdo, w, h, N, hd);
    cp_async_commit();

    // P: saved, or the scores and window_attn_fwd's softmax
    float p[FRA][4];
    if (p_saved) {
      const float* pw = p_saved + ((w * nh + h) * N) * N;
#pragma unroll
      for (int r = 0; r < FRA; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + FTY * r, j = tx + 16 * c;
          p[r][c] = (i < N && j < N) ? pw[i * N + j] : 0.f;
        }
      cp_async_wait<0>();
      __syncthreads();
    } else {
      // bias[h] + mask[w % nW] at this thread's (i, j), read while the window
      // is staged; -inf outside the window, which masks those scores
      float bm[FRA][4];
      const float* bh = bias + h * N * N;
      const float* mw = mask ? mask + (w % nW) * N * N : nullptr;
#pragma unroll
      for (int r = 0; r < FRA; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + FTY * r, j = tx + 16 * c;
          bm[r][c] = -INFINITY;
          if (i < N && j < N) bm[r][c] = mw ? bh[i * N + j] + mw[i * N + j] : bh[i * N + j];
        }
      cp_async_wait<0>();
      __syncthreads();
      window_scores<FTY>(qs, ks, ty, tx, p);
      window_softmax(p, bm, scale);
    }

    // dP = do v^T, then dS = P (dP - rowsum(dP P)) in place, the row sums
    // in the bf16 kernel's order (columns < 32, then >= 32)
    float ds[FRA][4];
#pragma unroll
    for (int r = 0; r < FRA; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[r][c] = 0.f;
#pragma unroll 1
    for (int d = 0; d < AD; d += 4) {
      float4 a[FRA], b[4];
#pragma unroll
      for (int r = 0; r < FRA; ++r)
        a[r] = *reinterpret_cast<const float4*>(dos + (ty + FTY * r) * SP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(vs + (tx + 16 * c) * SP + d);
#pragma unroll
      for (int r = 0; r < FRA; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = ds[r][c];
          s = fmaf(a[r].x, b[c].x, s);
          s = fmaf(a[r].y, b[c].y, s);
          s = fmaf(a[r].z, b[c].z, s);
          ds[r][c] = fmaf(a[r].w, b[c].w, s);
        }
    }
#pragma unroll
    for (int r = 0; r < FRA; ++r) {
      float lo = __fmul_rn(p[r][0], ds[r][0]) + __fmul_rn(p[r][1], ds[r][1]);
      float hi = __fmul_rn(p[r][2], ds[r][2]) + __fmul_rn(p[r][3], ds[r][3]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, o);
        hi += __shfl_xor_sync(0xffffffffu, hi, o);
      }
      const float rowdot = lo + hi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ds[r][c] = p[r][c] * (ds[r][c] - rowdot);
        dbias[r][c] += ds[r][c];
      }
    }

    // P and dS into the tiles, row-major and transposed
#pragma unroll
    for (int r = 0; r < FRA; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + FTY * r, j = tx + 16 * c;
        pr[i * PP + j] = p[r][c];
        dr[i * PP + j] = ds[r][c];
        if (ATT) pt[j * PP + i] = p[r][c];
        dt[j * PP + i] = ds[r][c];
      }
    __syncthreads();

    // dv = P^T do and dk = scale dS^T q side by side, half the block each;
    // then dq = scale dS k, beside att = P v or on the whole block
    constexpr int P2 = FT / 2;
    const int second = tid >= P2;  // warp-uniform
    const int local = tid - second * P2;
    product<P2, VEC>(second ? dr : pr, second ? qs : dos, local, second ? dk : dv,
                     second ? sdk : sdv, w, h, second ? scale : 1.f, N, hd);
    if constexpr (ATT)
      product<P2, VEC>(second ? pt : dt, second ? vs : ks, local, second ? att : dq,
                       second ? sat : sdq, w, h, second ? 1.f : scale, N, hd);
    else
      product<FT, VEC>(dt, ks, tid, dq, sdq, w, h, scale, N, hd);
  }

  float* part = dbias_part + (grp * nh + h) * N * N;
#pragma unroll
  for (int r = 0; r < FRA; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + FTY * r, j = tx + 16 * c;
      if (i < N && j < N) part[i * N + j] = dbias[r][c];
    }
}

struct AttnBwdArgs {
  const void *q, *k, *v;
  const float *bias, *mask;
  const void *p_saved, *dout;
  void *dq, *dk, *dv, *att;
  float* dbias_part;
  long long n_windows;
  int nh, N, hd, nW, groups;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, sat;
  float scale;
};

// a tensor's strides in 32 bits, if its last element's offset fits
bool narrow(const Strides& s, const AttnBwdArgs& a, Strides32& out) {
  const long long last =
      (a.n_windows - 1) * s.w + (a.nh - 1) * s.h + (a.N - 1) * s.n + a.hd - 1;
  out = Strides32{(int)s.w, (int)s.h, (int)s.n};
  return s.w >= 0 && s.h >= 0 && s.n >= 0 && last <= INT_MAX;
}

template <int VEC, bool ATT>
cudaError_t launch_f32_vec(cudaStream_t s, const AttnBwdArgs& a) {
  Strides32 t[8];
  const Strides* wide[8] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv, &a.sat};
  for (int i = 0; i < 8; ++i)
    if ((i < 7 || ATT) && !narrow(*wide[i], a, t[i])) return cudaErrorInvalidValue;
  const long long pairs = a.n_windows * a.nh * a.N * a.N;  // p_saved's elements
  if (a.n_windows > INT_MAX || (a.p_saved && pairs > INT_MAX) ||
      (long long)a.groups * a.nh * a.N * a.N > INT_MAX)
    return cudaErrorInvalidValue;
  const auto kernel = window_attn_bwd_f32_kernel<VEC, ATT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  SEI_LAUNCH_SMEM(dim3(a.nh, a.groups), FT, F_SMEM, s, kernel)(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.mask, static_cast<const float*>(a.p_saved),
      static_cast<const float*>(a.dout), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), static_cast<float*>(a.att), a.dbias_part, (int)a.n_windows,
      a.nh, a.N, a.hd, a.nW, a.groups, t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7],
      a.scale);
  return cudaGetLastError();
}

bool even(const Strides& s) { return s.w % 2 == 0 && s.h % 2 == 0 && s.n % 2 == 0; }

// 8-byte copies and stores where hd, every stride and every pointer allow
// them, else one element
cudaError_t launch_f32(cudaStream_t s, const AttnBwdArgs& a) {
  if (a.n_windows == 0) return cudaSuccess;
  bool vec2 = a.hd % 2 == 0;
  for (const Strides* t : {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv})
    vec2 = vec2 && even(*t);
  for (const void* ptr : {a.q, a.k, a.v, a.dout, (const void*)a.dq, (const void*)a.dk,
                          (const void*)a.dv})
    vec2 = vec2 && (size_t)ptr % 8 == 0;
  if (a.att) vec2 = vec2 && even(a.sat) && (size_t)a.att % 8 == 0;
  if (a.att) return vec2 ? launch_f32_vec<2, true>(s, a) : launch_f32_vec<1, true>(s, a);
  return vec2 ? launch_f32_vec<2, false>(s, a) : launch_f32_vec<1, false>(s, a);
}

}  // namespace

extern "C" int sei_window_attn_bwd(
    int device, int is_bf16, const void* q, const void* k, const void* v,
    const float* bias, const float* mask, const void* p_saved, const void* dout,
    void* dq, void* dk, void* dv, void* att, float* dbias_part, long long n_windows,
    int nh, int N, int hd, int nW, int groups, long long sq_w, long long sq_h,
    long long sq_n, long long sk_w, long long sk_h, long long sk_n,
    long long sv_w, long long sv_h, long long sv_n, long long sdo_w,
    long long sdo_h, long long sdo_n, long long sdq_w, long long sdq_h,
    long long sdq_n, long long sdk_w, long long sdk_h, long long sdk_n,
    long long sdv_w, long long sdv_h, long long sdv_n, long long sat_w,
    long long sat_h, long long sat_n, float scale, void* stream) {
  if (N <= 0 || N > AN || hd <= 0 || hd > AD || nh <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  if (p_saved == nullptr && bias == nullptr) return (int)cudaErrorInvalidValue;
  if (p_saved == nullptr && mask != nullptr && nW <= 0) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (n_windows < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16 && att != nullptr) return (int)cudaErrorInvalidValue;  // att: f32 only
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{sq_w, sq_h, sq_n}, sk{sk_w, sk_h, sk_n}, sv{sv_w, sv_h, sv_n},
      sdo{sdo_w, sdo_h, sdo_n}, sdq{sdq_w, sdq_h, sdq_n}, sdk{sdk_w, sdk_h, sdk_n},
      sdv{sdv_w, sdv_h, sdv_n}, sat{sat_w, sat_h, sat_n};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return (int)launch_f32(s, AttnBwdArgs{q, k, v, bias, mask, p_saved, dout, dq, dk, dv, att,
                                          dbias_part, n_windows, nh, N, hd, nW, groups, sq, sk,
                                          sv, sdo, sdq, sdk, sdv, sat, scale});
  SEI_LAUNCH(dim3(nh, groups), kThreads, s, window_attn_bwd_kernel<bf16>)(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, mask, static_cast<const bf16*>(p_saved), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), dbias_part,
      n_windows, nh, N, hd, nW, groups, sq, sk, sv, sdo, sdq, sdk, sdv, scale);
  return (int)cudaGetLastError();
}

// blocks of the f32 kernel one SM holds (the wrapper sizes its groups by it)
extern "C" int sei_window_attn_bwd_f32_blocks_per_sm(int device, int with_att) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const auto kernel = with_att ? window_attn_bwd_f32_kernel<2, true>
                               : window_attn_bwd_f32_kernel<2, false>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FT, F_SMEM) != cudaSuccess)
    return 0;
  return blocks;
}
