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
// bf16 (window_attn_fwd_mma_kernel, K5's attention with and without the p
// save) runs its two products on the tensor cores, as the TPU kernel runs
// them on the MXU (_bdot: bf16 operands, f32 accumulation): mma.sync
// m16n8k16.  Per (window, head) that is 128 mma against 11.5 KB of q, k, v,
// 3.8 KB of output and 8 KB of p: at the bf16 step's T = 36864 81.4 MB,
// 0.0243 ms at 3.35 TB/s, and a few microseconds of mma, so the bytes, and
// how well the kernel keeps them in flight, set its pace:
// - Block.  4 warps own one head and walk the windows g, g + groups, ... of
//   their group; bias[h] stays in registers (32 f32 a thread) for the walk.
//   The wrapper sizes groups from the kernel's own occupancy
//   (sei_window_attn_fwd_bf16_blocks_per_sm): one wave of blocks.  Warp r
//   owns query rows 16r..16r+15.
// - Staging.  q, k and v as bf16 [64][40] (an 80-byte pitch puts the eight
//   rows of one ldmatrix in distinct banks), every pad a real zero (the
//   tensor cores sum over the head dim's pad and the rows past N), by 4-byte
//   cp.async pairs (a head starts at a 60-byte step in the trunk's qkv
//   buffer: nothing wider always fits), one element at a time through
//   registers for an odd hd, stride or pointer (VEC = 1).  A ring of
//   SEI_ATTN_FWD_BF16_STAGES stages: the next windows are copied during this
//   one.  mask[w % nW] goes into registers after S, in 8-byte pairs.
// - S = Q K^T (plain ldmatrix for both), then scale, bias[h], the mask and
//   the max-subtracted f32 softmax in the accumulators' layout (row max and
//   sum by quad butterflies, __shfl_xor_sync 1 and 2); p rounded to bf16 is
//   packed straight from the accumulators into the A fragments of O = P V
//   (two adjacent n8 tiles are one k16 fragment; V by ldmatrix.trans).
//   These are window_attn_bf16.cuh's pieces, which the bf16 backward's
//   recompute form runs too, so this p equals the p it rounds for dV bit
//   for bit.  A masked score's exp (~e^-100) is a subnormal f32, on which
//   the f32 division takes a slow subroutine: the softmax divides it in f64
//   (div_rn, the same quotient bit for bit), which took the masked calls
//   from 2.3x to 1.3x the unmasked ones' time on the H100.
// - The output leaves the accumulators as bf16 pairs into the (B_, N, nh,
//   hd) view the proj GEMM reads (one element where hd, a stride or a
//   pointer is odd); rows >= N and columns >= hd are never written.  p_out
//   (only when given; contiguous, so each (window, head) is one run of N x N)
//   goes through the warp's rows of a shared [64][72] tile and out as
//   16-byte pieces of whole rows (SEI_ATTN_FWD_BF16_PTILE; N a multiple of
//   8), else as bf16 pairs or elements straight from the fragments.
// - Occupancy.  Two stages and the p tile take 39,936 B of shared memory;
//   loading the mask after S keeps 128 registers without a spill, so an SM
//   holds 4 blocks (16 warps; SEI_ATTN_FWD_BF16_MINB = 4): 88 groups x 6
//   heads at the step's T = 36864, 6.5 windows a block.  Against three
//   stages at 3 blocks with the mask loaded during staging (146 registers)
//   the bf16 step's 72 calls took 4.01 ms queued against 4.89
//   (dgrad_tile_sweep.py --attn-fwd-bf16; more warps hide the copies and
//   the masked rows' f64 divisions; the p tile against pair stores: 4.89
//   against 5.02 ms at three stages).
// - No atomics, sums in a fixed order: two launches agree bit for bit.
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

#include <climits>
#include <initializer_list>

#include "window_attn_bf16.cuh"

namespace {

// -- bf16: mma.sync on the tensor cores (see the note at the top) ---------

#ifndef SEI_ATTN_FWD_BF16_STAGES
#define SEI_ATTN_FWD_BF16_STAGES 2
#endif
#ifndef SEI_ATTN_FWD_BF16_MINB
#define SEI_ATTN_FWD_BF16_MINB 4
#endif
#ifndef SEI_ATTN_FWD_BF16_PTILE
#define SEI_ATTN_FWD_BF16_PTILE 1
#endif
#ifndef SEI_ATTN_FWD_BF16_MASK_EARLY
#define SEI_ATTN_FWD_BF16_MASK_EARLY 0
#endif

constexpr int BSTAGES = SEI_ATTN_FWD_BF16_STAGES;
constexpr int BSTAGE = 3 * XT;  // q, k and v of one window
constexpr bool PTILE = SEI_ATTN_FWD_BF16_PTILE != 0;
// mask[w % nW] loaded while the window is staged (its 32 registers live
// across S = Q K^T), or after S (the shipped kernel: 128 registers, no
// spill, 4 blocks per SM)
constexpr bool MASK_EARLY = SEI_ATTN_FWD_BF16_MASK_EARLY != 0;
constexpr int B_SMEM = (BSTAGES * BSTAGE + (PTILE ? TT : 0)) * (int)sizeof(bf16);
static_assert(BSTAGES >= 1 && BSTAGES <= 3, "one to three stages");

// how p leaves the kernel: not at all, one element, bf16 pairs (N even,
// p_out 4-byte aligned), or 16-byte rows through the shared p tile (N a
// multiple of 8, p_out 16-byte aligned; PTILE builds only)
enum PStore { P_NONE = 0, P_ONE = 1, P_PAIRS = 2, P_TILE = 3 };

// q, k and v of window w, head h into a stage ([3][AN][XP] bf16)
template <int VEC>
__device__ __forceinline__ void stage_qkv_bf16(bf16* st, const bf16* q, const bf16* k,
                                               const bf16* v, const Strides& sq, const Strides& sk,
                                               const Strides& sv, long long w, int h, int N,
                                               int hd) {
  stage_rows<VEC>(st, q, sq, w, h, N, hd, threadIdx.x);
  stage_rows<VEC>(st + XT, k, sk, w, h, N, hd, threadIdx.x);
  stage_rows<VEC>(st + 2 * XT, v, sv, w, h, N, hd, threadIdx.x);
}

// the packed k16 fragment a of p (rows r0 + g and r0 + g + 8, columns 16 kk +
// 2 t4 (+ 1) and 8 further on) into the (w, h) matrix pw of p_out: pairs,
// or one element at a time; rows and columns >= N skipped
__device__ __forceinline__ void store_p_frag(bf16* pw, const unsigned (&a)[4], int r0, int g,
                                             int t4, int kk, int N, bool pairs) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int i = r0 + g + 8 * (f & 1), j = 16 * kk + 8 * (f >> 1) + 2 * t4;
    if (i >= N || j >= N) continue;
    bf16* dst = pw + i * N + j;
    if (pairs) {  // N even: a pair is all in or all out
      *reinterpret_cast<unsigned*>(dst) = a[f];
    } else {
      dst[0] = __float2bfloat16_rn(lo_bf16(a[f]));
      if (j + 1 < N) dst[1] = __float2bfloat16_rn(hi_bf16(a[f]));
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(128, SEI_ATTN_FWD_BF16_MINB)
window_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ mask, bf16* __restrict__ out,
                           bf16* __restrict__ p_out, int n_windows, int nh, int N, int hd,
                           int nW, int groups, Strides sq, Strides sk, Strides sv, Strides so,
                           float scale, int pstore) {
  SEI_DYNAMIC_SMEM(bf16, bsmem);  // one name per element type in a source
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's query rows
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* const pt = bsmem + BSTAGES * BSTAGE + r0 * TP;  // the warp's rows of the p tile

  // bias[h] at the lane's accumulator positions (-inf outside the window),
  // for every window of the walk
  float bh[8][4];
  load_at_acc(bias + (long long)h * N * N, N, r0, lane, -INFINITY, bh);

  // a ring of stages: the next BSTAGES - 1 windows of the group are in
  // flight (one copy group each) while this one computes
  int s = 0;  // the stage of this window
#pragma unroll
  for (int j = 0; j + 1 < BSTAGES; ++j) {
    const int wj = grp + j * groups;
    if (wj < n_windows)
      stage_qkv_bf16<VEC>(bsmem + j * BSTAGE, q, k, v, sq, sk, sv, wj, h, N, hd);
    cp_async_commit();
  }
  for (int w = grp; w < n_windows; w += groups) {
    // mask[w % nW]: loaded while the window is staged, or after the
    // scores (MASK_EARLY); added after them either way
    float mk[8][4];
    if (MASK_EARLY && mask)
      load_at_acc(mask + (long long)(w % nW) * N * N, N, r0, lane, 0.f, mk);
    if constexpr (BSTAGES == 1) {
      __syncthreads();  // the last window is done with the stage
      stage_qkv_bf16<VEC>(bsmem, q, k, v, sq, sk, sv, w, h, N, hd);
      cp_async_commit();
    }
    cp_async_wait<(BSTAGES > 1 ? BSTAGES - 2 : 0)>();
    __syncthreads();  // this window staged; the last one done with its stage and the p tile
    if constexpr (BSTAGES > 1) {
      const int wn = w + (BSTAGES - 1) * groups;
      if (wn < n_windows)
        stage_qkv_bf16<VEC>(bsmem + (s + BSTAGES - 1) % BSTAGES * BSTAGE, q, k, v, sq, sk, sv,
                            wn, h, N, hd);
      cp_async_commit();
    }
    const bf16* const st = bsmem + s * BSTAGE;

    // S = Q K^T, then scale, bias[h] (+ mask[w % nW]) and the f32 softmax
    float p[8][4];
    rows_by_rows(st, st + XT, r0, lane, p);
    if (!MASK_EARLY && mask)
      load_at_acc(mask + (long long)(w % nW) * N * N, N, r0, lane, 0.f, mk);
    softmax_acc(p, bh, mk, mask != nullptr, scale);

    // p rounded to bf16 and packed as the A fragments of O = P V (n8 tiles
    // 2 kk and 2 kk + 1 are k-step kk; V by ldmatrix.trans), and saved
    bf16* const pw = p_out + ((long long)w * nh + h) * N * N;  // used only with p_out
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < AN / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      if (PTILE && pstore == P_TILE) {
        bf16* prow = pt + g * TP + 16 * kk + 2 * t4;
        *reinterpret_cast<unsigned*>(prow) = a[0];
        *reinterpret_cast<unsigned*>(prow + 8 * TP) = a[1];
        *reinterpret_cast<unsigned*>(prow + 8) = a[2];
        *reinterpret_cast<unsigned*>(prow + 8 * TP + 8) = a[3];
      } else if (pstore != P_NONE) {
        store_p_frag(pw, a, r0, g, t4, kk, N, pstore == P_PAIRS);
      }
      frags_by_rows(a, st + 2 * XT, kk, lane, acc);
    }
    store_bf16<VEC>(out, so, w, h, r0, lane, acc, 1.f, N, hd);
    if (PTILE && pstore == P_TILE) {
      __syncwarp();  // the warp's 16 rows of p are in its rows of the tile
      // 16 rows x 8 pieces of 16 bytes: a warp store covers 4 rows
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = (lane >> 3) + 4 * it, c = 8 * (lane & 7);
        if (r0 + r < N && c < N)
          *reinterpret_cast<uint4*>(pw + (r0 + r) * N + c) =
              *reinterpret_cast<const uint4*>(pt + r * TP + c);
      }
    }
    s = s + 1 == BSTAGES ? 0 : s + 1;
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

// 8-byte copies and stores where hd, every stride and every pointer allow
// them, else one element
cudaError_t launch_f32(cudaStream_t s, const AttnFwdArgs& a) {
  bool vec2 = a.hd % 2 == 0 && even(a.sq) && even(a.sk) && even(a.sv) && even(a.so);
  for (const void* ptr : {a.q, a.k, a.v, (const void*)a.out})
    vec2 = vec2 && (size_t)ptr % 8 == 0;
  return vec2 ? launch_f32_vec<2>(s, a) : launch_f32_vec<1>(s, a);
}

template <int VEC>
cudaError_t launch_bf16_vec(cudaStream_t s, const AttnFwdArgs& a) {
  const auto kernel = window_attn_fwd_mma_kernel<VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM);
  if (err != cudaSuccess) return err;
  const size_t pa = (size_t)a.p_out;
  PStore ps = P_NONE;
  if (a.p_out)
    ps = PTILE && a.N % 8 == 0 && pa % 16 == 0 ? P_TILE
         : a.N % 2 == 0 && pa % 4 == 0        ? P_PAIRS
                                              : P_ONE;
  SEI_LAUNCH_SMEM(dim3(a.nh, a.groups), 128, B_SMEM, s, kernel)(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.bias, a.mask, static_cast<bf16*>(a.out),
      static_cast<bf16*>(a.p_out), (int)a.n_windows, a.nh, a.N, a.hd, a.nW, a.groups, a.sq,
      a.sk, a.sv, a.so, a.scale, (int)ps);
  return cudaGetLastError();
}

// bf16 pairs by 4-byte copies and stores where hd, every stride and every
// pointer allow them, else one element
cudaError_t launch_bf16(cudaStream_t s, const AttnFwdArgs& a) {
  bool vec2 = a.hd % 2 == 0 && even(a.sq) && even(a.sk) && even(a.sv) && even(a.so);
  for (const void* ptr : {a.q, a.k, a.v, (const void*)a.out})
    vec2 = vec2 && (size_t)ptr % 4 == 0;
  return vec2 ? launch_bf16_vec<2>(s, a) : launch_bf16_vec<1>(s, a);
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
  if (nh > 65535 || groups <= 0 || groups > 65535 || n_windows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const AttnFwdArgs a{q, k, v, bias, mask, out, p_out, n_windows, nh, N,
                      hd, nW, groups, sq, sk, sv, so, scale};
  return (int)(is_bf16 ? launch_bf16(s, a) : launch_f32(s, a));
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

// blocks of the bf16 kernel one SM holds (the wrapper sizes its groups by it)
extern "C" int sei_window_attn_fwd_bf16_blocks_per_sm(int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const auto kernel = window_attn_fwd_mma_kernel<2>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 128, B_SMEM) != cudaSuccess)
    return 0;
  return blocks;
}
