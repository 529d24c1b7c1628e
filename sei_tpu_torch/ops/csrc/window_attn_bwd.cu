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
// bf16 (window_attn_bwd_mma_kernel, K7 with the saved p, and the bf16
// recompute form) runs its products on the tensor cores, as the TPU kernel
// runs them on the MXU (sei_tpu/ops/swin_trunk.py:766-789): mma.sync
// m16n8k16, bf16 operands, f32 accumulators.  Per (window, head) that is
// 256 mma (four 64x64x32 products), a few microseconds over a launch against
// ~121 MB of q, k, v, do, p, dq, dk, dv at the step's T = 36864, so the
// bytes, and how well the kernel keeps them in flight, set its pace:
// - Block.  4 warps (SEI_ATTN_BWD_BF16_WARPS = 8: two such teams, each on
//   its own window, dbias summed between them at the end) own one head and
//   walk the windows of their group.  Warp r owns query rows 16r..16r+15
//   for dP, dS and dQ, and key rows 16r..16r+15 for dV and dK.  dbias lives
//   in dS's accumulator layout (32 f32 per thread) across the walk.
// - Staging.  q, k, v and do as bf16 [64][40] (the head dim zero-padded to
//   32; an 80-byte pitch puts the eight rows of one ldmatrix in distinct
//   banks), p as [64][72], every pad a real zero (0 x NaN is NaN in a sum
//   the tensor cores take over the pad).  Copies are cp.async: q, k, v, do
//   as bf16 pairs (a head starts at a 60-byte step in the trunk's qkv
//   buffer: only 4-byte copies always fit), p in 16-byte pieces when
//   N is a multiple of 8; an odd hd, stride or pointer (VEC = 1), or p at
//   another N, goes through registers.  A ring of three stages
//   (SEI_ATTN_BWD_BF16_STAGES, 1-3): the team's next two windows are
//   copied during this one.
// - Per window, four products per warp:
//   1. dP = dO V^T: both fragments from plain ldmatrix (the head dim is
//      contiguous in dO and V), 8 n-tiles x 2 k-steps.
//   2. P is read (or, recomputed, held) in dP's accumulator layout: lane l
//      has rows l/4 and l/4 + 8, columns 2 (l % 4) + {0, 1} of each n8
//      tile, so rowsum(dP P) is a quad butterfly (__shfl_xor_sync 1, 2).
//   3. dS = P (dP - rowsum) in f32, added into dbias, rounded to bf16 and
//      packed straight into the A fragments of dQ = dS K (two adjacent n8
//      accumulator tiles are one k16 A fragment; K by ldmatrix.trans), and
//      written to a shared [64][72] dS tile.
//   4. After one barrier, dV = P^T dO and dK = dS^T Q, every fragment by
//      ldmatrix.trans (P and dS are stored [i][j], dO and Q [i][d]).
//   The recompute form first runs S = Q K^T the way dP runs, adds bias[h]
//   (+ mask[w % nW]) in that layout, takes the max-subtracted f32 softmax
//   with quad butterflies, keeps the f32 p for dS and writes p rounded to
//   bf16 to the P tile for dV.  The staging, the products, the softmax and
//   the stores are window_attn_bf16.cuh's, which the bf16 forward
//   (window_attn_fwd_mma_kernel) runs too: the p the forward saves is the p
//   this recompute rounds for dV, bit for bit.
// - Stores go out of the accumulators as bf16 pairs (4 bytes; a head's
//   60-byte offset is 4-byte aligned), one element where hd, a stride or a
//   pointer is odd; columns >= hd and rows >= N are never stored.  scale
//   multiplies dq and dk in f32 before their one rounding.
// - Occupancy.  Three stages take 98.3 KB of shared memory, so an SM holds
//   2 blocks (168 registers, no spill; SEI_ATTN_BWD_BF16_MINB = 2).  Two
//   blocks per SM beat three on the step's calls: two stages at 3 blocks
//   ran 3-8% slower, one stage at 4 (128 registers, spills) or 8 warps
//   (two teams) 1-2%, one stage at 5 (96 registers) 55% (two runs of
//   dgrad_tile_sweep.py --attn-bwd-bf16).  The wrapper sizes groups from
//   the kernel's own occupancy (sei_window_attn_bwd_bf16_blocks_per_sm):
//   one wave of blocks.
// - The sums run in a fixed order (no atomics), so two launches agree bit
//   for bit.
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
//   in ascending order of its reduction index.
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

#include "window_attn_bf16.cuh"

namespace {

// -- bf16: mma.sync on the tensor cores (see the note at the top) ---------

#ifndef SEI_ATTN_BWD_BF16_WARPS
#define SEI_ATTN_BWD_BF16_WARPS 4
#endif
#ifndef SEI_ATTN_BWD_BF16_STAGES
#define SEI_ATTN_BWD_BF16_STAGES 3
#endif
#ifndef SEI_ATTN_BWD_BF16_MINB
#define SEI_ATTN_BWD_BF16_MINB 2
#endif

constexpr int BT = 32 * SEI_ATTN_BWD_BF16_WARPS;  // threads per block
constexpr int BSLOTS = SEI_ATTN_BWD_BF16_WARPS / 4;  // windows a block takes at once
constexpr int BSTAGES = SEI_ATTN_BWD_BF16_STAGES;
constexpr int BSTAGE = 4 * XT + TT;         // q, k, v, do and P of one window
constexpr int BSLOT = BSTAGES * BSTAGE + TT;  // a team's stages and its dS tile
constexpr int B_SMEM = BSLOTS * BSLOT * (int)sizeof(bf16);
static_assert(BSLOTS * 4 == SEI_ATTN_BWD_BF16_WARPS && BSLOTS <= 2, "4 or 8 warps");
static_assert(BSTAGES >= 1 && BSTAGES <= 3, "one to three stages");
static_assert(BSTAGE * (int)sizeof(bf16) >= AN * AN * (int)sizeof(float), "dbias exchange");

// q, k, v and do of window w, head h into a stage ([4][AN][XP] bf16), and
// the saved p of (w, h) into its P tile ([AN][TP]); rows >= N, head-dim
// entries >= hd and p's columns >= N zero.  VEC = 2: bf16 pairs by 4-byte
// cp.async; VEC = 1: one element at a time through registers.  p16: p by
// 16-byte cp.async (N a multiple of 8), else through registers.  lt = the
// thread's index in its team of 128.
template <int VEC>
__device__ __forceinline__ void stage_bf16(bf16* st, const bf16* const (&src)[4],
                                           const Strides (&s)[4], const bf16* p_saved,
                                           long long w, int h, int nh, int N, int hd, bool p16,
                                           int lt) {
#pragma unroll
  for (int t = 0; t < 4; ++t) stage_rows<VEC>(st + t * XT, src[t], s[t], w, h, N, hd, lt);
  if (!p_saved) return;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const bf16* pw = p_saved + (w * nh + h) * N * N;
  bf16* ps = st + 4 * XT;
  if (p16) {
    for (int idx = lt; idx < AN * (AN / 8); idx += 128) {
      const int r = idx / (AN / 8);
      const int c = (idx - r * (AN / 8)) * 8;
      const bool ok = r < N && c < N;
      cp_async<16>(ps + r * TP + c, ok ? pw + r * N + c : p_saved, ok);
    }
  } else {
    for (int idx = lt; idx < AN * AN; idx += 128) {
      const int r = idx / AN;
      const int c = idx - r * AN;
      ps[r * TP + c] = r < N && c < N ? pw[r * N + c] : zero;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(BT, SEI_ATTN_BWD_BF16_MINB)
window_attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, const bf16* __restrict__ p_saved,
                            const bf16* __restrict__ dout, bf16* __restrict__ dq,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            float* __restrict__ dbias_part, int n_windows, int nh, int N,
                            int hd, int nW, int groups, Strides sq, Strides sk, Strides sv,
                            Strides sdo, Strides sdq, Strides sdk, Strides sdv, float scale,
                            int p16) {
  SEI_DYNAMIC_SMEM(bf16, bsmem);  // one name per element type in a source
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = tid / 128;  // this thread's team (window slot)
  const int lt = tid % 128;
  const int r0 = 16 * (lt / 32);  // the warp's query rows (dP, dS, dQ) and key rows (dV, dK)
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* const team = bsmem + slot * BSLOT;
  bf16* const dss = team + BSTAGES * BSTAGE;  // dS [i][j], bf16
  const bf16* const src[4] = {q, k, v, dout};
  const Strides ss[4] = {sq, sk, sv, sdo};
  const int step = groups * BSLOTS;  // windows between one team's turns

  // dbias[nt][e]: row r0 + g + 8 (e / 2), column 8 nt + 2 t4 + e % 2
  float dbias[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbias[nt][e] = 0.f;

  // a ring of stages: the windows of the team's next BSTAGES - 1 turns are
  // in flight (one copy group each) while this turn's computes
  int s = 0;  // the stage of this turn's window
#pragma unroll
  for (int k = 0; k + 1 < BSTAGES; ++k) {
    const int wk = grp + slot * groups + k * step;
    if (wk < n_windows)
      stage_bf16<VEC>(team + k * BSTAGE, src, ss, p_saved, wk, h, nh, N, hd, p16, lt);
    cp_async_commit();
  }
  for (int w0 = grp; w0 < n_windows; w0 += step) {
    const int w = w0 + slot * groups;
    const bool active = w < n_windows;  // uniform across the team
    if constexpr (BSTAGES == 1) {
      __syncthreads();  // the last turn is done with the stage and the dS tile
      if (active) stage_bf16<VEC>(team, src, ss, p_saved, w, h, nh, N, hd, p16, lt);
      cp_async_commit();
    }
    cp_async_wait<(BSTAGES > 1 ? BSTAGES - 2 : 0)>();
    __syncthreads();  // this window staged; the last turn done with its stage
    if constexpr (BSTAGES > 1) {
      const int wn = w + (BSTAGES - 1) * step;
      if (wn < n_windows)
        stage_bf16<VEC>(team + (s + BSTAGES - 1) % BSTAGES * BSTAGE, src, ss, p_saved, wn, h,
                        nh, N, hd, p16, lt);
      cp_async_commit();
    }
    bf16* const st = team + s * BSTAGE;
    const bf16* const qs = st;
    const bf16* const ks = st + XT;
    const bf16* const vs = st + 2 * XT;
    const bf16* const dos = st + 3 * XT;
    bf16* const ps = st + 4 * XT;

    if (active) {
      // P in dP's accumulator layout, f32: saved (bf16), or recomputed
      float p[8][4];
      if (p_saved) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const unsigned u =
                *reinterpret_cast<const unsigned*>(ps + (r0 + g + 8 * hf) * TP + 8 * nt + 2 * t4);
            p[nt][2 * hf] = lo_bf16(u);
            p[nt][2 * hf + 1] = hi_bf16(u);
          }
      } else {
        // S = Q K^T; then scale, bias[h] (+ mask[w % nW]) and the softmax
        // of each row over the quad that holds it (the forward's p)
        rows_by_rows(qs, ks, r0, lane, p);
        float bm[8][4], mk[8][4];
        load_at_acc(bias + (long long)h * N * N, N, r0, lane, -INFINITY, bm);
        if (mask) load_at_acc(mask + (long long)(w % nW) * N * N, N, r0, lane, 0.f, mk);
        softmax_acc(p, bm, mk, mask != nullptr, scale);
        // p rounded to bf16, as P.V read it in the forward: dV's operand
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<unsigned*>(ps + (r0 + g + 8 * hf) * TP + 8 * nt + 2 * t4) =
                pack_bf16(p[nt][2 * hf], p[nt][2 * hf + 1]);
      }

      // dP = dO V^T, rowsum(dP P) over each row's quad, dS = P (dP - rowsum)
      float ds[8][4];
      rows_by_rows(dos, vs, r0, lane, ds);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += ds[nt][e] * p[nt][e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 1);
        rs[hf] += __shfl_xor_sync(0xffffffffu, rs[hf], 2);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[nt][e] = p[nt][e] * (ds[nt][e] - rs[e >> 1]);
          dbias[nt][e] += ds[nt][e];
        }

      // dS rounded to bf16: into the dS tile (for dK), and as the A
      // fragments of dQ = dS K (n8 tiles 2 kk and 2 kk + 1 are k-step kk)
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < AN / 16; ++kk) {
        unsigned a[4];
        a[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
        a[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
        a[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        a[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
        bf16* drow = dss + (r0 + g) * TP + 16 * kk + 2 * t4;
        *reinterpret_cast<unsigned*>(drow) = a[0];
        *reinterpret_cast<unsigned*>(drow + 8 * TP) = a[1];
        *reinterpret_cast<unsigned*>(drow + 8) = a[2];
        *reinterpret_cast<unsigned*>(drow + 8 * TP + 8) = a[3];
        frags_by_rows(a, ks, kk, lane, acc);
      }
      store_bf16<VEC>(dq, sdq, w, h, r0, lane, acc, scale, N, hd);
    }
    __syncthreads();  // the P and dS tiles complete

    if (active) {
      // dV = P^T dO and dK = dS^T Q over the window's 64 query rows
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      cols_by_rows(ps, dos, r0, lane, acc);
      store_bf16<VEC>(dv, sdv, w, h, r0, lane, acc, 1.f, N, hd);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      cols_by_rows(dss, qs, r0, lane, acc);
      store_bf16<VEC>(dk, sdk, w, h, r0, lane, acc, scale, N, hd);
    }
    s = s + 1 == BSTAGES ? 0 : s + 1;
  }

  // two teams: the second hands its dbias to the first through shared
  // memory (its own stages, f32 [AN][AN]), which adds it to its own
  if constexpr (BSLOTS == 2) {
    float* red = reinterpret_cast<float*>(bsmem + BSLOT);
    __syncthreads();
    if (slot == 1)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(r0 + g + 8 * (e >> 1)) * AN + 8 * nt + 2 * t4 + (e & 1)] = dbias[nt][e];
    __syncthreads();
    if (slot == 1) return;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dbias[nt][e] += red[(r0 + g + 8 * (e >> 1)) * AN + 8 * nt + 2 * t4 + (e & 1)];
  }
  float* part = dbias_part + ((long long)grp * nh + h) * N * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), j = 8 * nt + 2 * t4 + (e & 1);
      if (i < N && j < N) part[i * N + j] = dbias[nt][e];
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

    // dP = do v^T, then dS = P (dP - rowsum(dP P)) in place, each row sum
    // over columns < 32, then >= 32
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

template <int VEC>
cudaError_t launch_bf16_vec(cudaStream_t s, const AttnBwdArgs& a) {
  const auto kernel = window_attn_bwd_mma_kernel<VEC>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM);
  if (err != cudaSuccess) return err;
  const bool p16 = a.p_saved && a.N % 8 == 0 && (size_t)a.p_saved % 16 == 0;
  SEI_LAUNCH_SMEM(dim3(a.nh, a.groups), BT, B_SMEM, s, kernel)(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.bias, a.mask, static_cast<const bf16*>(a.p_saved),
      static_cast<const bf16*>(a.dout), static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.dbias_part, (int)a.n_windows, a.nh, a.N, a.hd, a.nW, a.groups,
      a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv, a.scale, (int)p16);
  return cudaGetLastError();
}

// bf16 pairs by 4-byte copies and stores where hd, every stride and every
// pointer allow them, else one element
cudaError_t launch_bf16(cudaStream_t s, const AttnBwdArgs& a) {
  if (a.n_windows == 0) return cudaSuccess;
  if (a.n_windows > INT_MAX) return cudaErrorInvalidValue;
  bool vec2 = a.hd % 2 == 0;
  for (const Strides* t : {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv})
    vec2 = vec2 && even(*t);
  for (const void* ptr : {a.q, a.k, a.v, a.dout, (const void*)a.dq, (const void*)a.dk,
                          (const void*)a.dv})
    vec2 = vec2 && (size_t)ptr % 4 == 0;
  return vec2 ? launch_bf16_vec<2>(s, a) : launch_bf16_vec<1>(s, a);
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
  return (int)launch_bf16(s, AttnBwdArgs{q, k, v, bias, mask, p_saved, dout, dq, dk, dv, att,
                                        dbias_part, n_windows, nh, N, hd, nW, groups, sq, sk,
                                        sv, sdo, sdq, sdk, sdv, sat, scale});
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

// blocks of the bf16 kernel one SM holds (the wrapper sizes its groups by it)
extern "C" int sei_window_attn_bwd_bf16_blocks_per_sm(int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const auto kernel = window_attn_bwd_mma_kernel<2>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BT, B_SMEM) != cudaSuccess)
    return 0;
  return blocks;
}
