// window_attn_fwd: softmax(scale * q k^T + bias[h] (+ mask[w % nW])) v over
// windows of N <= 64 tokens, head dim hd <= 32.  Storage type T (float, or
// bf16 for the bf16 training recipe) for q, k, v, the output and the saved
// probabilities; f32 scores, bias, mask and softmax.
//
// Replaces sei_tpu/ops/attention.py _fwd_kernel (:65-76) and the attention
// section of the TPU trunk kernel (sei_tpu/ops/swin_trunk.py :446-477),
// including the probability save of mode "full" (p_ref, :487-490; K5): the
// softmax is rounded to T (:467) before P.V reads it and before it is saved,
// and the output is rounded to T (:470-473).  At the flagship shapes (N = 64,
// hd = 30) one (window, head) pair is 2 * 2 * 64 * 64 * 30 = 0.49 MFLOP
// against 4 * 64 * 30 elements of q, k, v and output (+ 64 * 64 of p when
// saved): in f32 ~16 flops per byte, near the FP32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20); in bf16 ~32 (~8 with the p save), far below the bf16
// ridge of 295 (989 TFLOP/s), so bytes bound it.  Strides are arguments, so
// the trunk feeds it straight from the qkv GEMM output (B_, N, 3, nh, hd)
// and writes the (B_, N, nh, hd) layout the proj GEMM reads; p leaves the
// kernel only when the caller asks for it (p_out, (B_, nh, N, N)
// contiguous).
//
// bf16 (window_attn_fwd_kernel<bf16>, K5 with the p save): one 128-thread
// block per (window, head); q and v staged in shared memory as f32 padded to
// 32 (+1 column against bank conflicts), each thread keeps one key row in
// registers and writes one column of the 64x64 score tile (bias and mask
// reads coalesced along that column), the f32 max-subtracted softmax is a
// warp per row, and P.V reads P rows as broadcasts.
//
// f32 (window_attn_fwd_f32_kernel, K1 and the attention of K3/K4) is built
// for the CUDA cores' FP32 pipe, which an SM issues four warp FMAs a clock
// against one 128-byte shared-memory wavefront, on the f32 backward's
// pieces (window_attn_f32.cuh), so its p and att are the backward's bit for
// bit:
// - Register micro-tiles.  A block of 256 threads (SEI_ATTN_FWD_F32_THREADS;
//   16 x 16, or 8 x 16 at 128) takes one (window, head) at a time.  Thread
//   (ty, tx) owns the scores of rows ty + 16 r (r < 4) and columns tx + 16 c
//   (c < 4) and reads 4 + 4 float4 of q and k per 64 FMAs; the row max and
//   sum are __shfl_xor_sync butterflies over the 16 lanes of a row, and
//   bias[h] + mask[w % nW] is added as one value.
// - P.V: the owner threads write P transposed ([j][i]) into one shared tile
//   before one barrier; the 64 x 32 output takes half the block
//   (SEI_ATTN_FWD_F32_PV) at 4 x 4 outputs per thread (8 x 4 at 128
//   threads), two float4 reads per 16 FMAs, each output one FMA chain in
//   ascending j.  (On the whole block, at 4 x 2 outputs and a float4 and
//   a float2 per 8 FMAs, it ran 1-2% slower on the H100: shared-memory
//   reads, not FMAs, pace it.)
// - One head per block, walking the windows g, g + groups, ... of its
//   group: bias[h] stays in registers, mask[w % nW] is read into registers
//   while the window is staged and added after the scores (added before
//   them, every warp waited for the loads: on the H100 a masked call at
//   the eval shape took 0.06 ms more), and the wrapper sizes groups from
//   the kernel's own occupancy so that the grid is one wave.
// - q, k and v are copied by cp.async, the next window's into a second stage
//   during this one's FMAs (SEI_ATTN_FWD_F32_STAGES): 8-byte copies (a
//   head's row starts at 120-byte steps in the (T, 3C) qkv buffer), one
//   element where hd, a stride or a pointer is odd.  Two stages of 27 KB
//   and the 17 KB P tile take 71 KB of dynamic shared memory: 2 blocks per
//   SM (SEI_ATTN_FWD_F32_MINB, 128 registers).
// - Window and head offsets are 64-bit, so any tensor the bf16 kernel takes
//   the f32 one takes too.

#include <initializer_list>

#include "window_attn_f32.cuh"

namespace {

constexpr int kThreads = 128;

struct Strides {
  long long w, h, n;  // window, head, token; the head-dim stride is 1
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ mask, T* __restrict__ out,
                       T* __restrict__ p_out, int nh, int N, int hd, int nW,
                       Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  __shared__ float qs[AN][AD + 1];
  __shared__ float vs[AN][AD + 1];
  __shared__ float ps[AN][AN + 1];

  const int tid = threadIdx.x;
  const long long w = blockIdx.x / nh;
  const int h = (int)(blockIdx.x - w * nh);
  const T* qb = q + w * sq.w + h * sq.h;
  const T* kb = k + w * sk.w + h * sk.h;
  const T* vb = v + w * sv.w + h * sv.h;
  T* ob = out + w * so.w + h * so.h;

  for (int idx = tid; idx < AN * AD; idx += kThreads) {
    const int n = idx / AD;
    const int d = idx - n * AD;
    const bool ok = n < N && d < hd;
    qs[n][d] = ok ? to_f(qb[n * sq.n + d]) : 0.f;
    vs[n][d] = ok ? to_f(vb[n * sv.n + d]) : 0.f;
  }
  const int j = tid & (AN - 1);  // this thread's key / score column
  const int half = tid >> 6;     // rows half, half + 2, ...
  float kr[AD];
#pragma unroll
  for (int d = 0; d < AD; ++d) kr[d] = (j < N && d < hd) ? to_f(kb[j * sk.n + d]) : 0.f;
  __syncthreads();

  if (j < N) {
    const float* bcol = bias + (long long)h * N * N + j;
    const float* mcol = mask ? mask + (w % nW) * N * N + j : nullptr;
    for (int i = half; i < N; i += 2) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < AD; ++d) s = fmaf(qs[i][d], kr[d], s);
      s = s * scale + bcol[i * N];
      if (mcol) s += mcol[i * N];
      ps[i][j] = s;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  T* pb = p_out ? p_out + ((w * nh + h) * N) * N : nullptr;
  for (int i = warp; i < N; i += kThreads / 32) {
    const float a = lane < N ? ps[i][lane] : -INFINITY;
    const float b = lane + 32 < N ? ps[i][lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(a, b));
    const float ea = lane < N ? expf(a - m) : 0.f;
    const float eb = lane + 32 < N ? expf(b - m) : 0.f;
    const float sum = warp_sum(ea + eb);
    const float pa = round_as<T>(ea / sum), pb2 = round_as<T>(eb / sum);
    if (lane < N) ps[i][lane] = pa;
    if (lane + 32 < N) ps[i][lane + 32] = pb2;
    if (pb) {
      if (lane < N) pb[i * N + lane] = from_f<T>(pa);
      if (lane + 32 < N) pb[i * N + lane + 32] = from_f<T>(pb2);
    }
  }
  __syncthreads();

  if (lane < hd) {
    for (int i = warp; i < N; i += kThreads / 32) {
      float acc = 0.f;
      for (int jj = 0; jj < N; ++jj) acc = fmaf(ps[i][jj], vs[jj][lane], acc);
      ob[i * so.n + lane] = from_f<T>(acc);
    }
  }
}

// -- f32: register micro-tiles on the CUDA cores (see the note at the top) --

#ifndef SEI_ATTN_FWD_F32_THREADS
#define SEI_ATTN_FWD_F32_THREADS 256
#endif
#ifndef SEI_ATTN_FWD_F32_MINB
#define SEI_ATTN_FWD_F32_MINB 2
#endif
#ifndef SEI_ATTN_FWD_F32_STAGES
#define SEI_ATTN_FWD_F32_STAGES 2
#endif
#ifndef SEI_ATTN_FWD_F32_PV
#define SEI_ATTN_FWD_F32_PV (SEI_ATTN_FWD_F32_THREADS / 2)
#endif

constexpr int FT = SEI_ATTN_FWD_F32_THREADS;  // threads per block
constexpr int FTY = FT / 16;                  // score row groups, 16 lanes per row
constexpr int FRA = AN / FTY;                 // score rows per thread
constexpr int NSTAGE = SEI_ATTN_FWD_F32_STAGES;
constexpr int PV = SEI_ATTN_FWD_F32_PV;  // threads of the P.V product
constexpr int STAGE = 3 * AN * SP;  // floats of one staged window (q, k, v)
constexpr int F_SMEM = (NSTAGE * STAGE + AN * PP) * (int)sizeof(float);
static_assert(FT == 128 || FT == 256, "16 lanes per score row, 4 or 8 rows each");
static_assert(NSTAGE == 1 || NSTAGE == 2, "one or two stages");
static_assert(PV == FT || 2 * PV == FT, "P.V on the whole block or on its first half");

// q, k and v of window w, head h into a stage ([3][AN][SP], f32), rows >= N
// and head-dim entries >= hd zero-filled; VEC elements per cp.async
template <int VEC>
__device__ __forceinline__ void stage_qkv(float* st, const float* q, const float* k,
                                          const float* v, Strides sq, Strides sk, Strides sv,
                                          int w, int h, int N, int hd) {
  constexpr int PR = AD / VEC;  // copies per row
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* src = t == 0 ? q : t == 1 ? k : v;
    const Strides s = t == 0 ? sq : t == 1 ? sk : sv;
    const float* base = src + w * s.w + h * s.h;
    float* dst = st + t * AN * SP;
    for (int idx = threadIdx.x; idx < AN * PR; idx += FT) {
      const int n = idx / PR;
      const int d = (idx - n * PR) * VEC;
      const bool ok = n < N && d < hd;
      cp_async<4 * VEC>(dst + n * SP + d, ok ? base + n * s.n + d : src, ok);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(FT, SEI_ATTN_FWD_F32_MINB)
window_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, float* __restrict__ out,
                           float* __restrict__ p_out, int n_windows, int nh, int N, int hd,
                           int nW, int groups, Strides sq, Strides sk, Strides sv, Strides so,
                           float scale) {
  SEI_DYNAMIC_SMEM(float, smem);
  float* const pt = smem + NSTAGE * STAGE;  // P^T [j][i]: att = P v
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int tx = tid & 15;  // columns tx + 16 c
  const int ty = tid >> 4;  // rows ty + FTY r

  // bias[h] at this thread's (i, j), for every window; -inf outside the
  // window, which masks those scores
  float bh[FRA][4];
#pragma unroll
  for (int r = 0; r < FRA; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + FTY * r, j = tx + 16 * c;
      bh[r][c] = (i < N && j < N) ? bias[(h * N + i) * N + j] : -INFINITY;
    }

  if (NSTAGE == 2 && grp < n_windows) {
    stage_qkv<VEC>(smem, q, k, v, sq, sk, sv, grp, h, N, hd);
    cp_async_commit();
  }
  for (int w = grp, it = 0; w < n_windows; w += groups, ++it) {
    float* const st = smem + (NSTAGE == 2 ? it & 1 : 0) * STAGE;
    // mask[w % nW], read while the window is staged and added to bias[h]
    // after the scores, so that no warp waits for it
    float mk[FRA][4];
    const float* mw = mask ? mask + (w % nW) * N * N : nullptr;
    if (mw) {
#pragma unroll
      for (int r = 0; r < FRA; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + FTY * r, j = tx + 16 * c;
          mk[r][c] = (i < N && j < N) ? mw[i * N + j] : 0.f;
        }
    }
    if (NSTAGE == 1) {
      __syncthreads();  // the previous window is done with the stage and the tile
      stage_qkv<VEC>(st, q, k, v, sq, sk, sv, w, h, N, hd);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // window staged; the previous one done with the other stage, the tile
    if (NSTAGE == 2 && w + groups < n_windows) {
      stage_qkv<VEC>(smem + ((it + 1) & 1) * STAGE, q, k, v, sq, sk, sv, w + groups, h, N, hd);
      cp_async_commit();
    }

    float p[FRA][4], bm[FRA][4];
    window_scores<FTY>(st, st + AN * SP, ty, tx, p);
#pragma unroll
    for (int r = 0; r < FRA; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) bm[r][c] = mw ? bh[r][c] + mk[r][c] : bh[r][c];
    window_softmax(p, bm, scale);

    // P^T into the tile; p into p_out when asked
    float* pw = p_out ? p_out + ((long long)w * nh + h) * N * N : nullptr;
#pragma unroll
    for (int r = 0; r < FRA; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + FTY * r, j = tx + 16 * c;
        pt[j * PP + i] = p[r][c];
        if (pw && i < N && j < N) pw[i * N + j] = p[r][c];
      }
    __syncthreads();

    // att = P v on the first PV threads, rows < N and columns < hd stored
    if (PV == FT || tid < PV) {  // warp-uniform
      typedef ProdTile<PV> TL;
      float acc[TL::RC][TL::CC];
      tile_product<PV>(pt, st + 2 * AN * SP, tid, acc);
      const int r0 = (tid / TL::CX) * TL::RC, c0 = (tid % TL::CX) * TL::CC;
      float* ob = out + w * so.w + h * so.h + c0;
#pragma unroll
      for (int r = 0; r < TL::RC; ++r) {
        if (r0 + r >= N) continue;
        float* row = ob + (r0 + r) * so.n;
#pragma unroll
        for (int c = 0; c < TL::CC; c += VEC) {
          if (c0 + c >= hd) continue;
          if constexpr (VEC == 2)  // hd even: a pair is all in or all out
            *reinterpret_cast<float2*>(row + c) = make_float2(acc[r][c], acc[r][c + 1]);
          else
            row[c] = acc[r][c];
        }
      }
    }
  }
}

struct AttnFwdArgs {
  const void *q, *k, *v;
  const float *bias, *mask;
  void *out, *p_out;
  long long n_windows;
  int nh, N, hd, nW, groups;
  Strides sq, sk, sv, so;
  float scale;
};

template <int VEC>
cudaError_t launch_f32_vec(cudaStream_t s, const AttnFwdArgs& a) {
  const auto kernel = window_attn_fwd_f32_kernel<VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  SEI_LAUNCH_SMEM(dim3(a.nh, a.groups), FT, F_SMEM, s, kernel)(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.mask, static_cast<float*>(a.out),
      static_cast<float*>(a.p_out), (int)a.n_windows, a.nh, a.N, a.hd, a.nW, a.groups, a.sq,
      a.sk, a.sv, a.so, a.scale);
  return cudaGetLastError();
}

bool even(const Strides& s) { return s.w % 2 == 0 && s.h % 2 == 0 && s.n % 2 == 0; }

// 8-byte copies and stores where hd, every stride and every pointer allow
// them, else one element
cudaError_t launch_f32(cudaStream_t s, const AttnFwdArgs& a) {
  bool vec2 = a.hd % 2 == 0 && even(a.sq) && even(a.sk) && even(a.sv) && even(a.so);
  for (const void* ptr : {a.q, a.k, a.v, (const void*)a.out})
    vec2 = vec2 && (size_t)ptr % 8 == 0;
  return vec2 ? launch_f32_vec<2>(s, a) : launch_f32_vec<1>(s, a);
}

}  // namespace

extern "C" int sei_window_attn_fwd(
    int device, int is_bf16, const void* q, const void* k, const void* v,
    const float* bias, const float* mask, void* out, void* p_out,
    long long n_windows, int nh, int N, int hd, int nW, int groups, long long sq_w,
    long long sq_h, long long sq_n, long long sk_w, long long sk_h,
    long long sk_n, long long sv_w, long long sv_h, long long sv_n,
    long long so_w, long long so_h, long long so_n, float scale, void* stream) {
  if (N <= 0 || N > AN || hd <= 0 || hd > AD || nh <= 0)
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && nW <= 0) return (int)cudaErrorInvalidValue;
  if (n_windows < 0) return (int)cudaErrorInvalidValue;
  if (n_windows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{sq_w, sq_h, sq_n}, sk{sk_w, sk_h, sk_n}, sv{sv_w, sv_h, sv_n},
      so{so_w, so_h, so_n};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {  // one block per (head, group of windows)
    if (nh > 65535 || groups <= 0 || groups > 65535 || n_windows > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    return (int)launch_f32(s, AttnFwdArgs{q, k, v, bias, mask, out, p_out, n_windows, nh, N,
                                          hd, nW, groups, sq, sk, sv, so, scale});
  }
  const long long blocks = n_windows * nh;  // bf16: one block per (window, head)
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  SEI_LAUNCH((unsigned)blocks, kThreads, s, window_attn_fwd_kernel<bf16>)(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, mask, static_cast<bf16*>(out), static_cast<bf16*>(p_out), nh, N, hd, nW, sq, sk,
      sv, so, scale);
  return (int)cudaGetLastError();
}

// blocks of the f32 kernel one SM holds (the wrapper sizes its groups by it)
extern "C" int sei_window_attn_fwd_f32_blocks_per_sm(int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const auto kernel = window_attn_fwd_f32_kernel<2>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FT, F_SMEM) != cudaSuccess)
    return 0;
  return blocks;
}
