// gemm_dgrad / gemm_wgrad: the data-grad and weight-grad products of the
// Swin trunk's backward, with f32 accumulation.  Storage type T (float, or
// bf16 for the bf16 training recipe) for the weights and activations; the
// output-gradient operand dy is f32 or T per call (TDY), and is rounded to T
// as it is loaded -- the JAX trunk's casts of dm, dh, the proj gradient and
// dqkv before their products (sei_tpu/ops/swin_trunk.py :663-669, :714,
// :740, :801-803).
//
// Both read their output-gradient operand through one prologue: row m of it
// is  round_T(s[m / rows_per_img] * dy[p(m)]),  with p = row_to_pixel
// (common.cuh) and s the per-image drop-path keep factor (optional).  That
// folds the window partition + roll of the residual gradient (proj
// backward) and the dpm scale of both residual branches into the load, as
// the forward folds them into gemm_bias_epilogue's store.
//
//   gemm_dgrad:  out (M, K) = (s . dy[p]) @ W^T,  W (K, N) in x out,
//                optionally times gp (M, K) in the epilogue: the saved
//                gelu'(h) (mode "full", :666) or the recompute's f32 gelu'(h)
//                (fc2 backward -> d of the fc1 pre-activation); out is f32
//                or T per call (the f32 dh and dz, the T-rounded d(att) :741
//                and da :803).
//   gemm_wgrad:  dW (K, N) = A^T (s . dy[p]),  db (N,) = column sums of
//                (s . dy[p]), of the rounded operand or of the f32 one as the
//                JAX trunk sums it (:664, :668 f32; :792, :802 rounded); the
//                token axis M is split over gridDim.z and each split writes a
//                partial (the caller sums them).
//
// Replace the products of the TPU trunk's backward kernel
// (sei_tpu/ops/swin_trunk.py _block_bwd_image :663-669 (fc2/fc1),
// :740 / :786-803 (proj, qkv), and the per-group partial weight grads of
// _bwd_pallas :1153-1176 summed at :1198-1203), for with_saved=False (K6)
// and with_saved=True (K7).  Bound on the H100: 2*M*K*N flops against
// (M*K + M*N + K*N) elements, ~45-90 flops per byte in f32 at K, N in {180,
// 360, 540} (above the FP32 ridge of 20: operations bound, 67 TFLOP/s); in
// bf16 ~90-180 against the bf16 ridge of 295 (989 TFLOP/s): bytes bound.
// Per SwinBlock of the bf16 step (T = 36864) the four weight grads move
// ~200 MB (0.0597 ms at 3.35 TB/s) and the four data grads 266 MB (0.0794
// ms: f32 dy of fc1 and proj, f32 dh and dz, the bf16 gelu' read by fc2).
//
// f32 runs on the CUDA cores' FP32 FMAs (TF32 stays off), register-blocked
// as the f32 forward GEMM (gemm_bias_epilogue.cu).
// gemm_wgrad_f32_kernel:
// - Tiles.  A block owns a BM x BN tile of dW over (K, N), 96 x 96 of 192
//   threads (180, 360 and 540 pad to 192, 384 and 576), each thread 8 rows
//   x 6 columns of accumulators: per m it reads two float4 of A and a
//   float4 and a float2 of G from shared memory for 48 FMAs (the 64x64
//   kernel this one replaces read 8 floats per 16).  A warp is 4 x 8
//   threads, so each of those reads is one pass.  Tiles with a 60 edge
//   (180, 360 and 540 pad nothing) take 6 x 6 thread tiles
//   (dgrad_tile_sweep.py --wgrad-f32).
// - No transpose.  wgrad reduces over M, the row axis of both operands: a
//   slice of BK rows is [m][k] in A and [m][n] in G as the FMA loop reads
//   them.  A goes to shared memory as it lies, by 16-byte cp.async (a row
//   of 180 floats is 720 B).  G needs the gather and the scale: its rows
//   go through registers as float4, times the row's scale, into shared
//   memory.  Each slice's row pixels (row_to_pixel) and scales are found
//   once per block, by BK threads, into a small shared table two slices
//   ahead, not by every thread that copies the row.
// - Two stages, one barrier per slice: slice s + 1's cp.async and G loads
//   are in flight during slice s's FMAs; G is stored after them.
// - Bias sums: in the blocks of the first K tile, thread n adds column n of
//   each staged G slice after the slice's FMAs, ascending m.
// - Splits.  M is split over gridDim.z, each split a whole number of
//   slices; each writes one dW and one db partial (zeros for a split with
//   no rows), which the caller sums in split order.  sei_gemm_wgrad_f32_splits
//   sizes the split count from the kernel's own occupancy and tile: one
//   wave of blocks on the card's SMs.
// - float4 accesses where K and N are multiples of 4 and A and dy are
//   16-byte aligned (every shape of the step), else one element per access
//   (cp.async of 4 bytes for A).  The tile, the depth and the minimum
//   blocks per SM are build defines (-DSEI_WGRAD_F32_BM, _BN, _BK, _TM,
//   _TN, _MINB).
// - One FMA chain per output over ascending m within its split, so repeats
//   are bit for bit equal; a split count other than the old kernel's moves
//   dW and db in the last bits.
// gemm_dgrad_f32_kernel: register-blocked, as the f32 forward GEMM
// (gemm_bias_epilogue.cu):
// - Tiles.  A block of 2 BM threads owns a BM x BN tile of out over (M, K),
//   96 x 96 (K = 180 and 360 pad to 192 and 384, 6.7%), each thread 8 rows
//   x 6 columns of accumulators.  Per n a thread reads two float4 of G and
//   a float4 and a float2 of W from shared memory for 48 FMAs (the 64x64
//   kernel this one replaces read 8 floats per 16).  A warp is 4 x 8
//   threads, so each of those loads is one pass.
// - Waves.  96 rows, not the forward's 128: at the step's T = 36864 the
//   K = 180 calls (3 of 4) have 768 blocks for 264 slots (2 per SM), 2.91
//   waves, where 128 rows gave 576, 2.18 waves, and the last wave ran 18%
//   full (dgrad_tile_sweep.py --dgrad-f32 chose the tile on the card).
// - Both operands transposed.  dgrad reduces over N, the contiguous axis of
//   both dy and W (K, N), but the FMA loop reads float4 along m and k: both
//   go through registers, read as float4 along n and stored [n][m], [n][k].
//   Copy c of a slice is row c % rows of column group c / rows, so a warp's
//   32 lanes store 32 consecutive floats (one pass), and a thread's row of G
//   is the same in every slice: its pixel (row_to_pixel) and scale are found
//   once, and the scale is applied as the row is stored.  (Copying both by
//   cp.async as they lie, [m][n] and [k][n], and reading float4 along n in
//   the FMA loop frees the 20 staging registers for 3 blocks per SM, but
//   measured no faster over the step's calls: PERF.md.)
// - Staging.  N in 20-deep slices (180, 360 and 540 pad nothing; 30,720 B of
//   static shared memory) through two shared stages with one barrier per
//   slice: slice s + 1 is read into registers before slice s's FMAs and
//   stored into the other stage after them.
// - Epilogue in registers: times gp (read as float4 / float2), then each
//   row's column groups stored as float4 / float2.
// - float4 accesses where K and N are multiples of 4 and every pointer is
//   16-byte aligned (every shape of the step), else one element per access;
//   ragged edges and the M tail zero-filled.  The tile and the depth are
//   build defines (-DSEI_DGRAD_F32_BM, _BN, _BK, _MINB; dgrad_tile_sweep.py
//   --dgrad-f32 sweeps them on the card).
// - One FMA chain per output over the f32 products s * dy, in ascending n
//   from 0, times gp after it (no split over N, no atomics): the sums of the
//   64x64 kernel this one replaces, bit for bit.
//
// bf16 runs on the tensor cores (gemm_wgrad_mma_kernel, gemm_dgrad_mma_kernel):
// - Tiles.  A 128-thread block owns a 64x64 tile of dW over (K, N), or a
//   64x96 tile of out over (M, K); its four warps take 32x32 (32x48) each,
//   as 2 x 4 (2 x 6) mma.sync.m16n8k16 bf16 tiles with f32 accumulators in
//   registers.  The
//   reduction (M for dW, N for out) is walked in slices of 32, staged in
//   shared memory as bf16 at a row pitch of +8 elements (the eight 16-byte
//   rows of one ldmatrix fall in distinct banks).
// - Fragments.  wgrad reduces over M, which is the row of both staged
//   operands (A [m][k], G [m][n]): both fragments come from ldmatrix .trans.
//   dgrad reduces over N, which is contiguous in both (G [m][n], W [k][n],
//   the col-major B fragment as W is stored): both from a plain ldmatrix.
// - Two stages.  Each thread loads its part of slice s+1 of the rounded
//   operand G into registers before the mma of slice s and scales, rounds
//   and stores it into the other shared buffer after: the loads are in
//   flight during the mma.  dgrad's W needs no prologue and goes straight
//   to shared memory by cp.async alongside.  One __syncthreads per slice.
// - The prologue stays fused on the load: the rows a thread stages are the
//   same in every slice, so each row's pixel (row_to_pixel) and scale are
//   computed once per row and thread; the row is scaled, rounded to bf16
//   once, and stored.  dgrad runs it ceil(K / DG_TN) times over each dy
//   element: 2 at K = 180 and 4 at 360 with 96 columns (64: 3 and 6, 10%
//   slower on the card; 192: 1 and 2, but 168 registers spill at 3 blocks
//   per SM, 4% slower; dgrad_tile_sweep.py, PERF.md).
// - Bias sums (wgrad).  Blocks of the first K tile also add each loaded
//   value (the f32 one before rounding, or the rounded one with db_rounded)
//   into per-thread running sums over a fixed set of columns and rows,
//   reduced across the block in a fixed order at the end.
// - dgrad's epilogue.  The f32 tile is staged in the slices' shared memory,
//   then each row goes out in packed accesses, times gp's packs (bf16 or
//   f32) and converted to the output type.
// - Ragged widths.  K and N of 180, 360 or 540 are not multiples of 64, 96
//   or 32: edges are zero-filled in shared memory (6.25% of each of those
//   widths is padding; 6.7% of K in dgrad's 96-column tiles).  M is whole tiles and slices at the step's T.  Rows
//   of 180 or 540 bf16 are 8-byte, not 16-byte, aligned, so global accesses
//   are 4-element packs (8 bytes of bf16, 16 of f32; cp.async of 8 bytes)
//   when K, N and the pointers allow it (VEC = 4, every shape of the step)
//   and element by element otherwise (VEC = 1).
// - The sum order is fixed (no split-K, no atomics): repeats are bit for bit
//   equal, so a captured step repeats the eager one.
// Left for a wgmma/TMA version: 64-row warpgroup tiles fed by TMA into a
// ring of shared buffers with mbarriers, a producer warp, a persistent grid;
// and the rounding prologue, which TMA cannot apply, in a converter warp.

#include <type_traits>

#include "common.cuh"

namespace {

// -- f32 gemm_dgrad on the CUDA cores (see the note at the top) ------------

// The block tile, rows of M x columns of K, and the depth of an N slice;
// -DSEI_DGRAD_F32_BM=... -DSEI_DGRAD_F32_BN=... -DSEI_DGRAD_F32_BK=... build
// another (the tile sweep): BM a multiple of 32 from 64 to 128, BN a
// multiple of 32 from 64, BK a multiple of 4; -DSEI_DGRAD_F32_MINB sets the
// blocks per SM the register budget is cut for
#ifndef SEI_DGRAD_F32_BM
#define SEI_DGRAD_F32_BM 96
#endif
#ifndef SEI_DGRAD_F32_BN
#define SEI_DGRAD_F32_BN 96
#endif
#ifndef SEI_DGRAD_F32_BK
#define SEI_DGRAD_F32_BK 20
#endif
constexpr int DF_BM = SEI_DGRAD_F32_BM;
constexpr int DF_BN = SEI_DGRAD_F32_BN;
constexpr int DF_BK = SEI_DGRAD_F32_BK;
constexpr int DF_THREADS = 2 * DF_BM;           // 16 columns x BM / 8 rows of threads
constexpr int DF_NG4 = DF_BN / 64;              // 4-column groups of a thread, 64 apart
constexpr int DF_NG2 = (DF_BN % 64) / 32;       // and a 2-column group after them
constexpr int DF_TN = 4 * DF_NG4 + 2 * DF_NG2;  // a thread's columns (and 8 rows)
#ifdef SEI_DGRAD_F32_MINB
constexpr int DF_MIN_BLOCKS = SEI_DGRAD_F32_MINB;
#else
constexpr int DF_MIN_BLOCKS = (DF_BN <= 96 ? 512 : 256) / DF_THREADS;
#endif
static_assert(DF_BM % 32 == 0 && DF_BM >= 64 && DF_BM <= 128 && DF_BN % 32 == 0 &&
              DF_BN >= 64 && DF_BK % 4 == 0, "f32 dgrad tile");

// out[m][k] = (sum_n (s(m) dy[p(m)][n]) W[k][n]) gp[m][k]  (M x K, reduction
// over N) in f32; GP = false: no gp factor.  VEC = elements per global
// access: 4 (K, N multiples of 4 and every pointer 16-byte aligned) or 1
template <bool GP, int VEC>
__global__ void __launch_bounds__(DF_THREADS, DF_MIN_BLOCKS)
gemm_dgrad_f32_kernel(const float* __restrict__ dy, const float* __restrict__ Wt,
                      const float* __restrict__ scale, const float* __restrict__ gp,
                      float* __restrict__ out, int M, int N, int K, int rows_per_img,
                      WinMap map) {
  constexpr int BM = DF_BM, BN = DF_BN, BK = DF_BK, TN = DF_TN;
  // copies per staged row of either operand, and per thread and slice
  constexpr int CPR = BK / VEC;
  constexpr int G_N = (CPR * BM + DF_THREADS - 1) / DF_THREADS;
  constexpr int W_N = (CPR * BN + DF_THREADS - 1) / DF_THREADS;
  __shared__ __align__(16) float Gs[2][BK][BM];  // Gs[stage][n][m]
  __shared__ __align__(16) float Ws[2][BK][BN];  // Ws[stage][n][k]

  // a warp is 4 x 8 threads: 4 rows of threads read 4 float4 of Gs and 8
  // columns of threads 8 float4 (or float2) of Ws per n, one pass each
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty*4 .. +3 and BM/2 + ty*4 .. +3
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns tx*4 .. +3 (+ 64 g), then tx*2 .. +1
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;

  // copy c = tid + i * DF_THREADS of a slice is row c % rows of column group
  // c / rows.  G's rows: this thread's is tid % BM in every copy and slice,
  // so its pixel and scale are found once (no row past M: zero-filled)
  const int g_row = tid % BM;
  const float* grow = nullptr;
  float gs = 1.f;
  if (m0 + g_row < M) {
    grow = dy + row_to_pixel(m0 + g_row, map) * N;
    if (scale) gs = scale[(m0 + g_row) / rows_per_img];
  }

  // slice n0 of both operands into registers (zero past M, K and N; with
  // VEC = 4, N is a multiple of 4, so a copy is all in or all out), then
  // into stage st transposed, G times its row's scale
  float rg[G_N][VEC], rw[W_N][VEC];
  auto load = [&](int n0) {
#pragma unroll
    for (int i = 0; i < G_N; ++i) {
      const int q = tid / BM + 2 * i;
      const int gn = n0 + q * VEC;
      const bool ok = q < CPR && grow && gn < N;
      if constexpr (VEC == 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(grow + gn)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        rg[i][0] = v.x, rg[i][1] = v.y, rg[i][2] = v.z, rg[i][3] = v.w;
      } else {
        rg[i][0] = ok ? grow[gn] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < W_N; ++i) {
      const int c = tid + i * DF_THREADS;
      const int q = c / BN;
      const int gk = k0 + c % BN, gn = n0 + q * VEC;
      const bool ok = q < CPR && gk < K && gn < N;
      const float* src = Wt + (long long)gk * N + gn;
      if constexpr (VEC == 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        rw[i][0] = v.x, rw[i][1] = v.y, rw[i][2] = v.z, rw[i][3] = v.w;
      } else {
        rw[i][0] = ok ? *src : 0.f;
      }
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < G_N; ++i) {
      const int q = tid / BM + 2 * i;
      if (q < CPR) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) Gs[st][q * VEC + j][g_row] = gs * rg[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < W_N; ++i) {
      const int c = tid + i * DF_THREADS;
      if (c / BN < CPR) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) Ws[st][(c / BN) * VEC + j][c % BN] = rw[i][j];
      }
    }
  };

  // one FMA chain per output, ascending n from 0 (no split over N, no
  // atomics), so repeats are bit for bit equal
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  auto compute = [&](int st) {
#pragma unroll
    for (int nn = 0; nn < BK; ++nn) {
      float a[8], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&Gs[st][nn][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Gs[st][nn][BM / 2 + ty * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
#pragma unroll
      for (int g = 0; g < DF_NG4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Ws[st][nn][g * 64 + tx * 4]);
        b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
      }
      if (DF_NG2) {
        const float2 v = *reinterpret_cast<const float2*>(&Ws[st][nn][DF_NG4 * 64 + tx * 2]);
        b[TN - 2] = v.x, b[TN - 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  // two stages, one barrier per slice: slice s + 1's loads are in flight
  // while slice s's FMAs run; the barrier after its store frees stage s % 2
  const int slices = (N + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int st = s & 1;
    const bool more = s + 1 < slices;
    if (more) load((s + 1) * BK);
    compute(st);
    if (more) {
      store(st ^ 1);
      __syncthreads();
    }
  }

  // epilogue in registers: times gp, then each row's column groups stored
  // (float4 / float2 with VEC 4: a group is all in or all out, as K % 4 == 0)
  auto col = [&](int j) {
    return j < 4 * DF_NG4 ? (j >> 2) * 64 + tx * 4 + (j & 3) : DF_NG4 * 64 + tx * 2 + (j & 1);
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i >> 2) * (BM / 2) + ty * 4 + (i & 3);
    if (gm >= M) continue;
    const long long orow = (long long)gm * K;
    // the group of Wd columns from the thread's column j0
    auto store_out = [&](int j0, auto wd) {
      constexpr int Wd = decltype(wd)::value;
      const int gk = k0 + col(j0);
      const long long o = orow + gk;
      if constexpr (VEC == 4) {
        if (gk >= K) return;
        Pack<float, Wd> p;
        if (GP) p = load_pack<float, Wd>(gp + o);
#pragma unroll
        for (int q = 0; q < Wd; ++q) p.v[q] = GP ? acc[i][j0 + q] * p.v[q] : acc[i][j0 + q];
        store_pack(out + o, p);
      } else {
#pragma unroll
        for (int q = 0; q < Wd; ++q) {
          if (gk + q < K) out[o + q] = GP ? acc[i][j0 + q] * gp[o + q] : acc[i][j0 + q];
        }
      }
    };
#pragma unroll
    for (int g = 0; g < DF_NG4; ++g) store_out(4 * g, std::integral_constant<int, 4>());
    if (DF_NG2) store_out(TN - 2, std::integral_constant<int, 2>());
  }
}

// -- f32 gemm_wgrad on the CUDA cores (see the note at the top) ------------

// The block tile, rows of K x columns of N, the depth of an M slice and a
// thread's accumulator tile; -DSEI_WGRAD_F32_BM=... _BN, _BK, _TM, _TN build
// another (the tile sweep): TM and TN even, BM a multiple of TM and of 4, BN
// of TN and of 4, whole warps of (BM / TM) x (BN / TN) threads, BK at most
// the thread count; -DSEI_WGRAD_F32_MINB sets the blocks per SM the register
// budget is cut for
#ifndef SEI_WGRAD_F32_BM
#define SEI_WGRAD_F32_BM 96
#endif
#ifndef SEI_WGRAD_F32_BN
#define SEI_WGRAD_F32_BN 96
#endif
#ifndef SEI_WGRAD_F32_BK
#define SEI_WGRAD_F32_BK 28
#endif
#ifndef SEI_WGRAD_F32_TM
#define SEI_WGRAD_F32_TM 8
#endif
#ifndef SEI_WGRAD_F32_TN
#define SEI_WGRAD_F32_TN 6
#endif
constexpr int WF_BM = SEI_WGRAD_F32_BM, WF_BN = SEI_WGRAD_F32_BN, WF_BK = SEI_WGRAD_F32_BK;
constexpr int WF_TM = SEI_WGRAD_F32_TM, WF_TN = SEI_WGRAD_F32_TN;
constexpr int WF_TY = WF_BM / WF_TM;  // rows of threads
constexpr int WF_TX = WF_BN / WF_TN;  // columns of threads
constexpr int WF_THREADS = WF_TY * WF_TX;
#ifdef SEI_WGRAD_F32_MINB
constexpr int WF_MIN_BLOCKS = SEI_WGRAD_F32_MINB;
#else
constexpr int WF_MIN_BLOCKS = 512 / WF_THREADS > 0 ? 512 / WF_THREADS : 1;
#endif
static_assert(WF_TM % 2 == 0 && WF_TN % 2 == 0 && WF_BM % WF_TM == 0 && WF_BN % WF_TN == 0 &&
              WF_BM % 4 == 0 && WF_BN % 4 == 0 && WF_THREADS % 32 == 0 &&
              WF_BK <= WF_THREADS, "f32 wgrad tile");

// Element i of a thread's T rows (or columns) of the tile, the thread
// being t of THREADS_ALONG along that axis: groups of 4 spaced 4 x
// THREADS_ALONG apart, then one group of 2 after them
template <int T, int THREADS_ALONG>
__device__ __forceinline__ int tile_index(int i, int t) {
  constexpr int G4 = T / 4;
  return i < 4 * G4 ? (i >> 2) * 4 * THREADS_ALONG + t * 4 + (i & 3)
                    : G4 * 4 * THREADS_ALONG + t * 2 + (i & 1);
}

// those T values from a staged row: a float4 per group of 4, a float2 for
// the group of 2
template <int T, int THREADS_ALONG>
__device__ __forceinline__ void read_tile(float (&v)[T], const float* row, int t) {
#pragma unroll
  for (int g = 0; g < T / 4; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(row + g * 4 * THREADS_ALONG + t * 4);
    v[4 * g] = x.x, v[4 * g + 1] = x.y, v[4 * g + 2] = x.z, v[4 * g + 3] = x.w;
  }
  if (T % 4) {
    const float2 x = *reinterpret_cast<const float2*>(row + T / 4 * 4 * THREADS_ALONG + t * 2);
    v[T - 2] = x.x, v[T - 1] = x.y;
  }
}

// dW[k][n] = sum_m A[m][k] s(m) dy[p(m)][n] over this split's rows m (split
// z: rows z chunk .. + chunk, chunk a whole number of slices) into partial
// z, in f32; blocks of the first k tile also sum db[n] over the same rows.
// VEC = elements per global access: 4 (K, N multiples of 4, A and dy
// 16-byte aligned) or 1
template <int VEC>
__global__ void __launch_bounds__(WF_THREADS, WF_MIN_BLOCKS)
gemm_wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ dy,
                      const float* __restrict__ scale, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int M, int K, int N, int chunk,
                      int rows_per_img, WinMap map) {
  constexpr int BM = WF_BM, BN = WF_BN, BK = WF_BK, TM = WF_TM, TN = WF_TN;
  constexpr int TY = WF_TY, TX = WF_TX;
  // copies per staged row of A and of G, and per thread and slice
  constexpr int A_CPR = BM / VEC, G_CPR = BN / VEC;
  constexpr int A_N = (BK * A_CPR + WF_THREADS - 1) / WF_THREADS;
  constexpr int G_N = (BK * G_CPR + WF_THREADS - 1) / WF_THREADS;
  __shared__ __align__(16) float As[2][BK][BM];  // As[stage][m][k]
  __shared__ __align__(16) float Gs[2][BK][BN];  // Gs[stage][m][n], scaled
  __shared__ int row_pix[2][BK];                 // a slice's pixels (-1 past the split)
  __shared__ float row_scale[2][BK];             // and scales

  // a warp is 4 x 8 threads where the tile allows it (4 rows of threads
  // read 4 float4 of As and 8 columns 8 float4 of Gs per m, one pass
  // each), else TX consecutive threads per row of threads
  const int tid = threadIdx.x;
  constexpr bool W48 = TY % 4 == 0 && TX % 8 == 0;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = W48 ? warp / (TX / 8) * 4 + (lane >> 3) : tid / TX;
  const int tx = W48 ? warp % (TX / 8) * 8 + (lane & 7) : tid % TX;
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int m_begin = z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int slices = m_end > m_begin ? (m_end - m_begin + BK - 1) / BK : 0;
  const bool with_bias = blockIdx.y == 0;

  // slice s's row table, by the first BK threads: each row's pixel and
  // scale are found once per block, not by every thread that copies the row
  auto rows = [&](int s) {
    if (tid < BK) {
      const int gm = m_begin + s * BK + tid;
      const bool ok = gm < m_end;
      row_pix[s & 1][tid] = ok ? (int)row_to_pixel(gm, map) : -1;
      row_scale[s & 1][tid] = ok && scale ? scale[gm / rows_per_img] : 1.f;
    }
  };
  // slice s: A straight into stage s % 2 by cp.async, G's rows (the
  // gather) into registers; zero past the split, K and N (with VEC = 4, K
  // and N are multiples of 4, so a copy is all in or all out)
  float rg[G_N][VEC], rs[G_N];
  auto load = [&](int s) {
    const int st = s & 1, mb = m_begin + s * BK;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const int c = tid + i * WF_THREADS;
      if (c < BK * A_CPR) {
        const int r = c / A_CPR, q = c % A_CPR;
        const int gm = mb + r, gk = k0 + q * VEC;
        const bool ok = gm < m_end && gk < K;
        cp_async<VEC * (int)sizeof(float)>(&As[st][r][q * VEC],
                                           ok ? A + (long long)gm * K + gk : A, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < G_N; ++i) {
      const int c = tid + i * WF_THREADS;
      const int r = c / G_CPR, q = c % G_CPR;
      const int pix = c < BK * G_CPR ? row_pix[st][r] : -1;
      const int gn = n0 + q * VEC;
      const bool ok = pix >= 0 && gn < N;
      const float* src = dy + (long long)pix * N + gn;
      if constexpr (VEC == 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        rg[i][0] = v.x, rg[i][1] = v.y, rg[i][2] = v.z, rg[i][3] = v.w;
      } else {
        rg[i][0] = ok ? *src : 0.f;
      }
      rs[i] = pix >= 0 ? row_scale[st][r] : 0.f;
    }
  };
  // G times its row's scale into stage st
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < G_N; ++i) {
      const int c = tid + i * WF_THREADS;
      if (c < BK * G_CPR) {
        float* dst = &Gs[st][c / G_CPR][(c % G_CPR) * VEC];
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(rs[i] * rg[i][0], rs[i] * rg[i][1], rs[i] * rg[i][2], rs[i] * rg[i][3]);
        else
          *dst = rs[i] * rg[i][0];
      }
    }
  };

  // one FMA chain per output, ascending m within the split (the caller sums
  // the splits in a fixed order; no atomics)
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  auto compute = [&](int st) {
#pragma unroll
    for (int mm = 0; mm < BK; ++mm) {
      float a[TM], b[TN];
      read_tile<TM, TY>(a, &As[st][mm][0], ty);
      read_tile<TN, TX>(b, &Gs[st][mm][0], tx);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };
  // the bias: thread n of a first-k-tile block sums column n of each
  // staged slice, outside the FMA loop, ascending m
  float bsum = 0.f;

  // two stages, one barrier per slice: slice s + 1's copies and loads are
  // in flight while slice s's FMAs run, its G is stored after them, and the
  // barrier frees stage s % 2 and row table s % 2 (slice s + 2's, written
  // during slice s: its readers, slice s's loads, passed the last barrier)
  if (slices > 0) {
    rows(0);
    if (slices > 1) rows(1);
    __syncthreads();
    load(0);
    cp_async_commit();
    store(0);
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int s = 0; s < slices; ++s) {
    const int st = s & 1;
    const bool more = s + 1 < slices;
    if (more) load(s + 1);
    cp_async_commit();
    if (s + 2 < slices) rows(s + 2);
    compute(st);
    if (with_bias && tid < BN) {
#pragma unroll
      for (int r = 0; r < BK; ++r) bsum += Gs[st][r][tid];
    }
    if (more) store(st ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // partial z (zeros for a split without rows): the thread's rows in float4
  // / float2 groups (with VEC = 4, N % 4 == 0, so a group is all in or all
  // out), else element by element
  float* part = dw_part + (long long)z * K * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gk = k0 + tile_index<TM, TY>(i, ty);
    if (gk >= K) continue;
    float* prow = part + (long long)gk * N;
#pragma unroll
    for (int j = 0; j < TN; j += j < TN / 4 * 4 ? 4 : 2) {
      const int gn = n0 + tile_index<TN, TX>(j, tx);
      const bool four = j < TN / 4 * 4;
      if constexpr (VEC == 4) {
        if (gn >= N) continue;
        if (four)
          *reinterpret_cast<float4*>(prow + gn) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        else
          *reinterpret_cast<float2*>(prow + gn) = make_float2(acc[i][j], acc[i][j + 1]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < (four ? 4 : 2) && gn + q < N) prow[gn + q] = acc[i][j + q];
      }
    }
  }
  if (with_bias && tid < BN && n0 + tid < N) db_part[(long long)z * N + n0 + tid] = bsum;
}

struct DgradArgs {
  const void* dy;
  const void* Wt;
  const float* scale;
  const void* gp;
  void* out;
  int M, N, K, rows_per_img;
  WinMap map;
};

bool aligned(const void* p, size_t bytes) { return (size_t)p % bytes == 0; }

template <bool GP, int VEC>
void launch_dgrad_f32_vec(dim3 grid, cudaStream_t s, const DgradArgs& a) {
  SEI_LAUNCH(grid, DF_THREADS, s, gemm_dgrad_f32_kernel<GP, VEC>)(
      static_cast<const float*>(a.dy), static_cast<const float*>(a.Wt), a.scale,
      static_cast<const float*>(a.gp), static_cast<float*>(a.out), a.M, a.N, a.K,
      a.rows_per_img, a.map);
}

// float4 accesses where K, N and every pointer allow them, else one element
cudaError_t launch_dgrad_f32(cudaStream_t s, const DgradArgs& a) {
  const dim3 grid((a.K + DF_BN - 1) / DF_BN, (a.M + DF_BM - 1) / DF_BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  const bool vec4 = a.K % 4 == 0 && a.N % 4 == 0 && aligned(a.dy, 16) && aligned(a.Wt, 16) &&
                    aligned(a.gp, 16) && aligned(a.out, 16);
  if (a.gp != nullptr)
    vec4 ? launch_dgrad_f32_vec<true, 4>(grid, s, a) : launch_dgrad_f32_vec<true, 1>(grid, s, a);
  else
    vec4 ? launch_dgrad_f32_vec<false, 4>(grid, s, a) : launch_dgrad_f32_vec<false, 1>(grid, s, a);
  return cudaGetLastError();
}

// float4 accesses where K, N and both operands allow them, else one element
void launch_wgrad_f32(cudaStream_t s, const void* A, const void* dy, const float* scale,
                      float* dw_part, float* db_part, int M, int K, int N, int splits,
                      int rows_per_img, WinMap map) {
  const int chunk = ((M + splits - 1) / splits + WF_BK - 1) / WF_BK * WF_BK;
  const dim3 grid((N + WF_BN - 1) / WF_BN, (K + WF_BM - 1) / WF_BM, splits);
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(dy);
  if (K % 4 == 0 && N % 4 == 0 && aligned(A, 16) && aligned(dy, 16))
    SEI_LAUNCH(grid, WF_THREADS, s, gemm_wgrad_f32_kernel<4>)(a, d, scale, dw_part, db_part, M,
                                                               K, N, chunk, rows_per_img, map);
  else
    SEI_LAUNCH(grid, WF_THREADS, s, gemm_wgrad_f32_kernel<1>)(a, d, scale, dw_part, db_part, M,
                                                               K, N, chunk, rows_per_img, map);
}

// -- bf16 gemm_wgrad on the tensor cores (see the note at the top) ---------

// a block's dW tile is WG_TILE x WG_TILE (K x N)
constexpr int WG_TILE = 64;
constexpr int WG_SL = 32;        // token rows (M) per staged slice
constexpr int WG_PITCH = WG_TILE + 8;  // shared row pitch in bf16
constexpr int WG_THREADS = 128;  // 4 warps, 2 x 2 over the tile, 32x32 each

// The tensor-core kernels below are built by nvcc only: a host compiler
// (the f32 kernels' index logic on the CPU, tests/cuda_emulation.py) stops
// here, and the bf16 entry points then refuse
#ifdef __CUDACC__

// dW[k][n] = sum_m A[m][k] round_bf16(s(m) dy[p(m)][n]) over this split's
// rows m; blocks of the first k tile also sum db[n] over the same rows, of
// the rounded operand or of the f32 one (db_rounded).  VEC = elements per
// global access (4, or 1 where K, N or a pointer do not allow 4-element
// packs).
template <typename TDY, int VEC>
__global__ void __launch_bounds__(WG_THREADS, 4)
gemm_wgrad_mma_kernel(const bf16* __restrict__ A, const TDY* __restrict__ dy,
                      const float* __restrict__ scale, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int M, int K, int N, int chunk,
                      int rows_per_img, int db_rounded, WinMap map) {
  constexpr int CPR = WG_TILE / VEC;   // packs per staged row (A and G alike)
  constexpr int RSTEP = WG_THREADS / CPR;  // rows between one thread's packs
  constexpr int NP = WG_SL / RSTEP;       // packs per thread and operand per slice
  static_assert(WG_THREADS % CPR == 0 && WG_SL % RSTEP == 0, "load layout");
  __shared__ __align__(16) bf16 As[2][WG_SL][WG_PITCH];  // As[m][k]
  __shared__ __align__(16) bf16 Gs[2][WG_SL][WG_PITCH];  // Gs[m][n]
  __shared__ float red[RSTEP][WG_TILE];               // bias partial sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wk = (tid >> 5) >> 1;  // this warp's 32 rows (k) of the tile
  const int wn = (tid >> 5) & 1;   // and 32 columns (n)
  const int k0 = blockIdx.y * WG_TILE;
  const int n0 = blockIdx.x * WG_TILE;
  const int z = blockIdx.z;
  const int m_begin = z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bool with_bias = blockIdx.y == 0;

  // loads: this thread's pack is columns lc .. lc+VEC-1 of rows lr + i*RSTEP;
  // with VEC = 4, K and N are multiples of 4, so a pack is valid or padding
  const int lc = (tid % CPR) * VEC;
  const int lr = tid / CPR;
  const bool a_col = k0 + lc < K;
  const bool g_col = n0 + lc < N;

  Pack<bf16, VEC> pa[NP];  // slice s+1 in flight, raw
  Pack<TDY, VEC> pd[NP];
  float ps[NP];            // the row's scale, 0 past the split's end
  float bsum[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) bsum[j] = 0.f;
  float acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  auto load = [&](int mb) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int gm = mb + lr + i * RSTEP;
      const bool ok = gm < m_end;
      pa[i] = ok && a_col ? load_pack<bf16, VEC>(A + (long long)gm * K + k0 + lc)
                          : zero_pack<bf16, VEC>();
      pd[i] = ok && g_col ? load_pack<TDY, VEC>(dy + row_to_pixel(gm, map) * N + n0 + lc)
                          : zero_pack<TDY, VEC>();
      ps[i] = !ok ? 0.f : scale ? scale[gm / rows_per_img] : 1.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int r = lr + i * RSTEP;
      store_pack(&As[buf][r][lc], pa[i]);
      Pack<bf16, VEC> g;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float u = ps[i] * to_f(pd[i].v[j]);
        g.v[j] = from_f<bf16>(u);
        if (with_bias) bsum[j] += db_rounded ? to_f(g.v[j]) : u;
      }
      store_pack(&Gs[buf][r][lc], g);
    }
  };
  // ldmatrix row addresses: lane l serves row l % 8 of matrix l / 8.  A
  // fragment (16 k x 16 m): matrices (k 0-7, m 0-7), (k 8-15, m 0-7),
  // (k 0-7, m 8-15), (k 8-15, m 8-15); B fragments of two n8 tiles (16 m x
  // 8 n each): (m 0-7, n 0-7), (m 8-15, n 0-7), (m 0-7, n 8-15), (m 8-15,
  // n 8-15).
  const int a_m = (lane & 7) + ((lane >> 4) << 3);
  const int a_k = wk * 32 + (((lane >> 3) & 1) << 3);
  const int b_m = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = wn * 32 + ((lane >> 4) << 3);
  auto compute = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < WG_SL; ks += 16) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) ldmatrix_x4_trans(af[t], &As[buf][ks + a_m][a_k + t * 16]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, &Gs[buf][ks + b_m][b_n + p * 16]);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[t][j], af[t], bf[j][0], bf[j][1]);
    }
  };

  const int slices = m_end > m_begin ? (m_end - m_begin + WG_SL - 1) / WG_SL : 0;
  if (slices > 0) {
    load(m_begin);
    store(0);
  }
  __syncthreads();
  for (int sl = 0; sl < slices; ++sl) {
    const bool next = sl + 1 < slices;
    if (next) load(m_begin + (sl + 1) * WG_SL);
    compute(sl & 1);
    if (next) store((sl + 1) & 1);
    __syncthreads();
  }

  // accumulator (t, j): rows k = lane / 4 (+ 8), columns n = 2 (lane % 4) (+ 1)
  float* part = dw_part + (long long)z * K * N;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + wk * 32 + t * 16 + (lane >> 2) + ((e >> 1) << 3);
        const int gn = n0 + wn * 32 + j * 8 + ((lane & 3) << 1) + (e & 1);
        if (gk < K && gn < N) part[(long long)gk * N + gn] = acc[t][j][e];
      }
  if (with_bias) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[lr][lc + j] = bsum[j];
    __syncthreads();
    if (tid < WG_TILE) {
      float b = 0.f;
#pragma unroll
      for (int r = 0; r < RSTEP; ++r) b += red[r][tid];
      if (n0 + tid < N) db_part[(long long)z * N + n0 + tid] = b;
    }
  }
}

// -- bf16 gemm_dgrad on the tensor cores (see the note at the top) ---------

// output columns (K) per block: 96 (K = 180 in 2 tiles, 360 in 4), which
// beat 64 and 192 on the card (dgrad_tile_sweep.py builds the library with
// -DSEI_DGRAD_TN=64 or 192; PERF.md)
#ifndef SEI_DGRAD_TN
#define SEI_DGRAD_TN 96
#endif
constexpr int DG_BM = 64;             // output rows (tokens) per block
constexpr int DG_TN = SEI_DGRAD_TN;
constexpr int DG_SL = 32;             // reduction depth (N) of one staged slice
constexpr int DG_THREADS = 128;       // 4 warps, 2 x 2 over the tile
constexpr int DG_PITCH = DG_SL + 8;   // bf16 row pitch of the staged slices
constexpr int DG_O_PITCH = DG_TN + 4;  // f32 row pitch of the staged output tile
constexpr int DG_G_STAGE = DG_BM * DG_PITCH;
constexpr int DG_W_STAGE = DG_TN * DG_PITCH;
constexpr int DG_RING = 2 * (DG_G_STAGE + DG_W_STAGE) * (int)sizeof(bf16);
constexpr int DG_OUT = DG_BM * DG_O_PITCH * (int)sizeof(float);
constexpr int DG_SMEM = DG_RING > DG_OUT ? DG_RING : DG_OUT;  // dynamic shared bytes
static_assert(DG_TN % 32 == 0, "each warp's columns are whole pairs of n8 tiles");

// out[m][k] = (sum_n round_bf16(s(m) dy[p(m)][n]) W[k][n]) gp[m][k] with f32
// accumulators; TGP = void: no gp factor.  VEC = elements per global access
// (4, or 1 where K, N or a pointer do not allow 4-element packs).
template <typename TDY, typename TOUT, typename TGP, int VEC>
__global__ void __launch_bounds__(DG_THREADS, DG_TN <= 96 ? 4 : 3)
gemm_dgrad_mma_kernel(const TDY* __restrict__ dy, const bf16* __restrict__ Wt,
                      const float* __restrict__ scale, const TGP* __restrict__ gp,
                      TOUT* __restrict__ out, int M, int N, int K, int rows_per_img,
                      WinMap map) {
  // packs per staged row, rows between one thread's G packs, packs per thread
  constexpr int G_CPR = DG_SL / VEC, G_RSTEP = DG_THREADS / G_CPR, G_NP = DG_BM / G_RSTEP;
  constexpr int W_NP = DG_TN * G_CPR / DG_THREADS;
  constexpr int O_CPR = DG_TN / VEC, O_NP = DG_BM * O_CPR / DG_THREADS;
  static_assert(DG_THREADS % G_CPR == 0 && DG_BM % G_RSTEP == 0 &&
                DG_TN * G_CPR % DG_THREADS == 0 && DG_BM * O_CPR % DG_THREADS == 0,
                "load layout");
  constexpr int WJ = DG_TN / 16;  // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Gs = reinterpret_cast<bf16*>(smem);  // [stage][m][n]
  bf16* Ws = Gs + 2 * DG_G_STAGE;            // [stage][k][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 1;  // this warp's 32 rows (m) of the tile
  const int wn = (tid >> 5) & 1;   // and DG_TN / 2 columns (k)
  const int k0 = blockIdx.x * DG_TN;
  const int m0 = blockIdx.y * DG_BM;

  // this thread's G packs: columns gc .. gc+VEC-1 of rows gr + i*G_RSTEP in
  // every slice, so each row's pixel and scale are found once (pixel -1:
  // past M, zero-filled); with VEC = 4, N is a multiple of 4, so a pack is
  // valid or padding
  const int gc = (tid % G_CPR) * VEC;
  const int gr = tid / G_CPR;
  int pix[G_NP];
  float ps[G_NP];
#pragma unroll
  for (int i = 0; i < G_NP; ++i) {
    const int gm = m0 + gr + i * G_RSTEP;
    pix[i] = gm < M ? (int)row_to_pixel(gm, map) : -1;
    ps[i] = gm < M && scale ? scale[gm / rows_per_img] : 1.f;
  }
  Pack<TDY, VEC> pd[G_NP];  // slice s+1 of G in flight, raw

  // slice n0: G into registers; W straight into stage st by cp.async (one
  // element through registers with VEC = 1), zero-filled past K and N
  auto load = [&](int st, int n0) {
    const bool col = n0 + gc < N;
#pragma unroll
    for (int i = 0; i < G_NP; ++i)
      pd[i] = col && pix[i] >= 0 ? load_pack<TDY, VEC>(dy + (long long)pix[i] * N + n0 + gc)
                                 : zero_pack<TDY, VEC>();
    bf16* ws = Ws + st * DG_W_STAGE;
#pragma unroll
    for (int i = 0; i < W_NP; ++i) {
      const int idx = tid + i * DG_THREADS;
      const int r = idx / G_CPR, c = (idx % G_CPR) * VEC;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const bf16* src = ok ? Wt + (long long)gk * N + gn : Wt;
      if constexpr (VEC == 1)
        ws[r * DG_PITCH + c] = ok ? *src : from_f<bf16>(0.f);
      else
        cp_async<VEC * (int)sizeof(bf16)>(ws + r * DG_PITCH + c, src, ok);
    }
  };
  // G's prologue: scale, round to bf16 once, store into stage st
  auto store = [&](int st) {
    bf16* gs = Gs + st * DG_G_STAGE;
#pragma unroll
    for (int i = 0; i < G_NP; ++i) {
      Pack<bf16, VEC> g;
#pragma unroll
      for (int j = 0; j < VEC; ++j) g.v[j] = from_f<bf16>(ps[i] * to_f(pd[i].v[j]));
      store_pack(gs + (gr + i * G_RSTEP) * DG_PITCH + gc, g);
    }
  };

  // ldmatrix row addresses: lane l serves row l % 8 of matrix l / 8.  Both
  // operands are staged with the reduction axis (n) contiguous, so both come
  // from a plain ldmatrix.  A fragment (16 m x 16 n): matrices (m 0-7, n
  // 0-7), (m 8-15, n 0-7), (m 0-7, n 8-15), (m 8-15, n 8-15); B fragments of
  // two n8 tiles, from W's rows k: (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15,
  // n 0-7), (k 8-15, n 8-15), i.e. b0, b1 of the first tile, then of the
  // second.
  const int a_m = wm * 32 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_n = (lane >> 4) << 3;
  const int b_k = wn * (DG_TN / 2) + (lane & 7) + ((lane >> 4) << 3);
  const int b_n = ((lane >> 3) & 1) << 3;
  float acc[2][WJ][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  auto compute = [&](int st) {
    const bf16* gs = Gs + st * DG_G_STAGE;
    const bf16* ws = Ws + st * DG_W_STAGE;
#pragma unroll
    for (int ks = 0; ks < DG_SL; ks += 16) {
      unsigned af[2][4], bfr[WJ][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) ldmatrix_x4(af[t], gs + (a_m + t * 16) * DG_PITCH + ks + a_n);
#pragma unroll
      for (int p = 0; p < WJ / 2; ++p) {
        unsigned r[4];
        ldmatrix_x4(r, ws + (b_k + p * 16) * DG_PITCH + ks + b_n);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < WJ; ++j) mma_bf16_16816(acc[t][j], af[t], bfr[j][0], bfr[j][1]);
    }
  };

  // two stages: slice s+1's loads are in flight during slice s's mma; G is
  // stored after it, and one barrier per slice frees the stage it read
  const int slices = (N + DG_SL - 1) / DG_SL;
  load(0, 0);
  cp_async_commit();
  store(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const bool next = s + 1 < slices;
    if (next) load((s + 1) & 1, (s + 1) * DG_SL);
    cp_async_commit();
    compute(s & 1);
    if (next) store((s + 1) & 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  // the f32 tile goes through shared memory (the ring is free: every warp
  // passed the last barrier), then out in packed rows, times gp's packs
  // accumulator (t, j): rows m = lane / 4 (+ 8), columns k = 2 (lane % 4) (+ 1)
  float* so = reinterpret_cast<float*>(smem);  // [m][k]
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + t * 16 + (lane >> 2) + h * 8;
        const int c = wn * (DG_TN / 2) + j * 8 + ((lane & 3) << 1);
        *reinterpret_cast<float2*>(so + r * DG_O_PITCH + c) =
            make_float2(acc[t][j][2 * h], acc[t][j][2 * h + 1]);
      }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < O_NP; ++i) {
    const int idx = tid + i * DG_THREADS;
    const int r = idx / O_CPR, c = (idx % O_CPR) * VEC;
    const int gm = m0 + r, gk = k0 + c;
    if (gm >= M || gk >= K) continue;
    const long long o = (long long)gm * K + gk;
    const Pack<float, VEC> v = load_pack<float, VEC>(so + r * DG_O_PITCH + c);
    Pack<TOUT, VEC> y;
    if constexpr (std::is_void<TGP>::value) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) y.v[j] = from_f<TOUT>(v.v[j]);
    } else {
      const Pack<TGP, VEC> g = load_pack<TGP, VEC>(gp + o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) y.v[j] = from_f<TOUT>(v.v[j] * to_f(g.v[j]));
    }
    store_pack(out + o, y);
  }
}

template <typename TDY, typename TOUT, typename TGP, int VEC>
cudaError_t launch_dgrad_mma_vec(dim3 grid, cudaStream_t s, const DgradArgs& a) {
  const auto kernel = gemm_dgrad_mma_kernel<TDY, TOUT, TGP, VEC>;
  if (DG_SMEM > 48 * 1024) {  // wide tiles of the sweep only
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DG_SMEM);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, DG_THREADS, DG_SMEM, s>>>(
      static_cast<const TDY*>(a.dy), static_cast<const bf16*>(a.Wt), a.scale,
      static_cast<const TGP*>(a.gp), static_cast<TOUT*>(a.out), a.M, a.N, a.K,
      a.rows_per_img, a.map);
  return cudaSuccess;
}

template <typename TDY, typename TOUT, typename TGP>
cudaError_t launch_dgrad_mma_gp(bool vec4, dim3 grid, cudaStream_t s, const DgradArgs& a) {
  return vec4 ? launch_dgrad_mma_vec<TDY, TOUT, TGP, 4>(grid, s, a)
              : launch_dgrad_mma_vec<TDY, TOUT, TGP, 1>(grid, s, a);
}

template <typename TDY, typename TOUT>
cudaError_t launch_dgrad_mma_out(int gp_bf16, bool vec4, dim3 grid, cudaStream_t s,
                                 const DgradArgs& a) {
  if (a.gp == nullptr) return launch_dgrad_mma_gp<TDY, TOUT, void>(vec4, grid, s, a);
  if (gp_bf16) return launch_dgrad_mma_gp<TDY, TOUT, bf16>(vec4, grid, s, a);
  return launch_dgrad_mma_gp<TDY, TOUT, float>(vec4, grid, s, a);
}

template <typename TDY>
cudaError_t launch_dgrad_mma(int out_bf16, int gp_bf16, bool vec4, dim3 grid, cudaStream_t s,
                             const DgradArgs& a) {
  return out_bf16 ? launch_dgrad_mma_out<TDY, bf16>(gp_bf16, vec4, grid, s, a)
                  : launch_dgrad_mma_out<TDY, float>(gp_bf16, vec4, grid, s, a);
}

template <typename TDY>
void launch_wgrad_mma(bool vec4, dim3 grid, cudaStream_t s, const void* A, const void* dy,
                      const float* scale, float* dw_part, float* db_part, int M, int K,
                      int N, int chunk, int rows_per_img, int db_rounded, WinMap map) {
  const bf16* a = static_cast<const bf16*>(A);
  const TDY* d = static_cast<const TDY*>(dy);
  if (vec4)
    gemm_wgrad_mma_kernel<TDY, 4><<<grid, WG_THREADS, 0, s>>>(
        a, d, scale, dw_part, db_part, M, K, N, chunk, rows_per_img, db_rounded, map);
  else
    gemm_wgrad_mma_kernel<TDY, 1><<<grid, WG_THREADS, 0, s>>>(
        a, d, scale, dw_part, db_part, M, K, N, chunk, rows_per_img, db_rounded, map);
}

#endif  // __CUDACC__

}  // namespace

extern "C" int sei_gemm_dgrad(int device, int is_bf16, const void* dy, int dy_bf16,
                              const void* Wt, const float* scale, const void* gp,
                              int gp_bf16, void* out, int out_bf16, int M, int N,
                              int K, int rows_per_img, int windowed, int H, int W,
                              int ws, int shift, void* stream) {
  if (M < 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (scale != nullptr && rows_per_img <= 0) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && (dy_bf16 || out_bf16 || gp_bf16)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DgradArgs a{dy, Wt, scale, gp, out, M, N, K, rows_per_img,
                    WinMap{windowed, H, W, ws, shift}};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) return (int)launch_dgrad_f32(s, a);
#ifdef __CUDACC__
  const dim3 grid((K + DG_TN - 1) / DG_TN, (M + DG_BM - 1) / DG_BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  // 4-element packs: 8 bytes of bf16, 16 of f32, at every row start
  const auto pack = [](int is_bf) { return 4 * (is_bf ? sizeof(bf16) : sizeof(float)); };
  const bool vec4 = K % 4 == 0 && N % 4 == 0 && aligned(dy, pack(dy_bf16)) &&
                    aligned(Wt, pack(1)) && aligned(gp, pack(gp_bf16)) &&
                    aligned(out, pack(out_bf16));
  err = dy_bf16 ? launch_dgrad_mma<bf16>(out_bf16, gp_bf16, vec4, grid, s, a)
                : launch_dgrad_mma<float>(out_bf16, gp_bf16, vec4, grid, s, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorInvalidValue;
#endif
}

extern "C" int sei_gemm_wgrad(int device, int is_bf16, const void* A, const void* dy,
                              int dy_bf16, const float* scale, float* dw_part,
                              float* db_part, int M, int K, int N, int splits,
                              int rows_per_img, int db_rounded, int windowed, int H,
                              int W, int ws, int shift, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (scale != nullptr && rows_per_img <= 0) return (int)cudaErrorInvalidValue;
  if (dy_bf16 && !is_bf16) return (int)cudaErrorInvalidValue;
  const int tile_k = is_bf16 ? WG_TILE : WF_BM, tile_n = is_bf16 ? WG_TILE : WF_BN;
  if ((K + tile_k - 1) / tile_k > 65535 || (N + tile_n - 1) / tile_n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {  // f32 rounds nothing: db_rounded changes no sum
    launch_wgrad_f32(s, A, dy, scale, dw_part, db_part, M, K, N, splits, rows_per_img, map);
    return (int)cudaGetLastError();
  }
#ifdef __CUDACC__
  // each split takes a whole number of staged slices
  const int chunk = ((M + splits - 1) / splits + WG_SL - 1) / WG_SL * WG_SL;
  const dim3 grid((N + WG_TILE - 1) / WG_TILE, (K + WG_TILE - 1) / WG_TILE, splits);
  // 4-element packs: 8 bytes of bf16 A and dy, 16 of f32 dy, at every row start
  const size_t dy_pack = 4 * (dy_bf16 ? sizeof(bf16) : sizeof(float));
  const bool vec4 = K % 4 == 0 && N % 4 == 0 && (size_t)A % 8 == 0 &&
                    (size_t)dy % dy_pack == 0;
  if (dy_bf16)
    launch_wgrad_mma<bf16>(vec4, grid, s, A, dy, scale, dw_part, db_part, M, K, N, chunk,
                           rows_per_img, db_rounded, map);
  else
    launch_wgrad_mma<float>(vec4, grid, s, A, dy, scale, dw_part, db_part, M, K, N, chunk,
                            rows_per_img, db_rounded, map);
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorInvalidValue;
#endif
}

// How many partials the f32 weight grad of an (M, K) x (M, N) product
// should write: as many splits of M as fill the card's SMs with one wave of
// its blocks (from the kernel's own occupancy and tile), each a whole
// number of slices; 0 on a CUDA error
extern "C" int sei_gemm_wgrad_f32_splits(int device, int M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_wgrad_f32_kernel<4>,
                                                    WF_THREADS, 0) != cudaSuccess)
    return 0;
  const long long tiles = (long long)((K + WF_BM - 1) / WF_BM) * ((N + WF_BN - 1) / WF_BN);
  const long long slices = (M + WF_BK - 1) / WF_BK;
  long long splits = (long long)sms * per_sm / tiles;
  if (splits > slices) splits = slices;
  if (splits > 65535) splits = 65535;
  return splits > 1 ? (int)splits : 1;
}
