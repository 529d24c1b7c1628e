// gemm_bias_epilogue: out = epilogue(A . W + b) with f32 accumulation.
// Storage type T (float, or bf16 for the bf16 training recipe) for A, W, the
// residual and the output; f32 bias, drop-path factors and accumulators.
//
// Replaces the four matrix products the TPU trunk kernel computes inside its
// Pallas body (sei_tpu/ops/swin_trunk.py _fwd_kernel: qkv :448, proj :474,
// fc1 :539, fc2 :544-547) together with what follows each of them there:
//   EPI_NONE       qkv:  out = A.W + b, rounded to T (:448)
//   EPI_GELU       fc1 of the no-grad forward: out = gelu(A.W + b); exact
//                  GELU (erff) for f32, the polynomial _gelu_fast for bf16
//                  (:540-546, _use_fast_gelu :233)
//   EPI_GELU_PAIR  fc1 of the training forward (mode "full", :541-545) and
//                  of the recompute backward (:655-661): out = gelu(h) and
//                  gp = gelu'(h) from one evaluation (common.cuh gelu_pair);
//                  gp is T (the saved tensor) or f32 (the recompute's)
//   EPI_RESIDUAL   proj, fc2: out[p] = res[p] + dpm[img] * y with
//                  y = round_T(A.W + b), the sum in f32 and rounded to T
//                  again: the JAX trunk's double rounding (:474 then :597,
//                  :547 then :600).  p = row_to_pixel(row) folds window
//                  reverse and the +shift roll into the store (:508-510) and
//                  dpm is the per-image drop-path keep factor of the branch.
// Bound on the H100: 2*M*K*N flops against (M*K + K*N + M*N) elements moved,
// ~45-90 flops per byte in f32 at K = 180/360 -- above the FP32 ridge (67
// TFLOP/s over 3.35 TB/s = 20), so operations bound the f32 product; in bf16
// the bound is 989 TFLOP/s on the tensor cores against half the bytes (~90-180
// flops per byte, below the bf16 ridge of 295), so bytes bound it there: the
// bf16 step's five calls per SwinBlock (qkv twice, proj, fc1 with the gelu'
// save, fc2) move 266 MB at T = 36864, 0.0794 ms at 3.35 TB/s.
//
// f32 (gemm_bias_epilogue_kernel) runs on the CUDA cores' FP32 FMAs (TF32
// stays off), bound by them: 0.634 ms per SwinBlock at the eval shape (T =
// 81920), 0.071 ms for the step's fc1 recompute (T = 36864).
// - Tiles.  A block of 2 BM threads owns a BM x BN tile of the output
//   (128 x 96: N = 180, 360, 540 pad to 192, 384, 576, 6.7%; the tile and
//   the slice depth won the sweep of dgrad_tile_sweep.py --fwd-f32, which
//   builds others by -DSEI_FWD_F32_BM / _BN / _BK),
//   each thread 8 rows x 6 columns of accumulators.  Per k a thread reads
//   two float4 of A and a float4 and a float2 of W from shared memory for
//   48 FMAs: 3.4 FMAs per float read, where the earlier 64 x 64 tile of 4 x
//   4 did 2 and the shared-memory pipe held it at about half the FMA rate.
//   A warp is 4 x 8 threads, so each of its shared loads is one pass.
// - Staging.  K in 20-deep slices (180 and 360 pad nothing; 37.5 KB of
//   static shared memory, 2 blocks per SM) through two shared stages with
//   one barrier per slice: slice s + 1's W goes by 16-byte cp.async, and its
//   A into registers, before slice s's FMAs; A is stored transposed ([k][m],
//   pitch BM + 4) after them, so the FMA loop reads float4 along m.
// - Epilogue.  Each row's pixel (row_to_pixel) and drop-path factor are
//   found once per block into shared memory.  Bias, GELU or the pair and the
//   residual in registers; each row's column groups are stored at the row's
//   pixel as float4 / float2, the residual read the same way: a warp's 8
//   column threads cover 128 contiguous bytes of a row.
// - Ragged widths.  float4 accesses where K and N are multiples of 4 and
//   every pointer is 16-byte aligned (every shape of the step and the eval),
//   else one element per access; ragged edges and the M tail zero-filled.
// - One FMA chain per output in ascending k from 0, the bias added after it
//   (no split-K, no atomics): repeats are bit for bit equal, and the sums are
//   those of the 64 x 64 kernel this one replaces.
// Left for later: 3xTF32 (f32 products on the tensor cores with error
// compensation: other numbers, so it needs its own accuracy gate), a
// persistent grid, deeper staging.
//
// bf16 (gemm_bias_epilogue_mma_kernel) runs on the tensor cores:
// - Tiles.  A 128-thread block owns a 64x64 tile of the output over (M, N);
//   its four warps take 32x32 each, as 2 x 4 mma.sync.m16n8k16 bf16 tiles
//   with f32 accumulators in registers.  K is walked in 32-deep slices.
// - Staging.  A slice of A is stored [m][k] (k contiguous: mma's A fragment
//   comes from a plain ldmatrix) and a slice of W [k][n] (its col-major B
//   fragment from ldmatrix .trans), both at a row pitch of +8 bf16 so the
//   eight rows of one ldmatrix fall in distinct banks.  The operands need no
//   prologue, so they go from global to shared memory by cp.async, without
//   registers, into a ring of three slices: two are in flight while the
//   third feeds the mma; one __syncthreads per slice.
// - Ragged widths.  Copies are 16 bytes where K and N are multiples of 8 and
//   every pointer allows it, else 8 bytes where they are multiples of 4 (K
//   and N of 180, 360, 540: every shape of the step), else one element
//   through registers (odd widths, views at odd offsets); ragged K and N
//   edges and the M tail are zero-filled (src-size 0).  K pads to whole
//   slices (180 -> 192, 360 -> 384: 6.25%) and N to whole tiles (180 -> 192,
//   360 -> 384, 540 -> 576: 6.25%); M = T pads nothing at the step.
// - Epilogue.  Bias, GELU or the pair and the rounding in registers; the
//   rounded 64x64 tile (and gp's) is staged in the ring's memory, then each
//   row is written at its output pixel (row_to_pixel once per row) in packed
//   accesses, the residual read the same way.
// - The sum order is fixed (no split-K, no atomics): repeats are bit for bit
//   equal, as the captured step's match with the eager step needs.
// Left for a wgmma/TMA version: 64-row warpgroup tiles fed by TMA into an
// mbarrier ring, a producer warp, a persistent grid whose next tile's loads
// overlap this tile's epilogue, and wider N tiles (one block over all 180 or
// 360 columns would read A once).

#include <type_traits>

#include "common.cuh"

namespace {

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_PAIR = 3 };

// -- f32 on the CUDA cores (see the note at the top) -------------------------

// The f32 block tile, rows of M x columns of N, and the depth of a K slice;
// -DSEI_FWD_F32_BM=... -DSEI_FWD_F32_BN=... -DSEI_FWD_F32_BK=... build
// another (the tile sweep): BM 64 or 128, BN a multiple of 32 from 64, BK a
// multiple of 4
#ifndef SEI_FWD_F32_BM
#define SEI_FWD_F32_BM 128
#endif
#ifndef SEI_FWD_F32_BN
#define SEI_FWD_F32_BN 96
#endif
#ifndef SEI_FWD_F32_BK
#define SEI_FWD_F32_BK 20
#endif
constexpr int F32_BM = SEI_FWD_F32_BM;
constexpr int F32_BN = SEI_FWD_F32_BN;
constexpr int F32_BK = SEI_FWD_F32_BK;
constexpr int F32_THREADS = 2 * F32_BM;        // 16 columns x BM / 8 rows of threads
constexpr int F32_NG4 = F32_BN / 64;           // 4-column groups of a thread, 64 apart
constexpr int F32_NG2 = (F32_BN % 64) / 32;    // and a 2-column group after them
constexpr int F32_TN = 4 * F32_NG4 + 2 * F32_NG2;  // a thread's columns (and 8 rows)
constexpr int F32_AP = F32_BM + 4;             // As row pitch (floats)
static_assert((F32_BM == 64 || F32_BM == 128) && F32_BN % 32 == 0 && F32_BN >= 64 &&
              F32_BK % 4 == 0, "f32 tile");

// VEC = elements per global access: 4 (K, N multiples of 4 and every pointer
// 16-byte aligned) or 1
template <int EPI, int VEC>
__global__ void __launch_bounds__(F32_THREADS, (F32_BN <= 96 ? 512 : 256) / F32_THREADS)
gemm_bias_epilogue_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                          const float* __restrict__ bias, float* __restrict__ out,
                          float* __restrict__ gp, const float* __restrict__ res,
                          const float* __restrict__ dpm, int M, int K, int N,
                          int rows_per_img, WinMap map) {
  constexpr int BM = F32_BM, BN = F32_BN, BK = F32_BK, TN = F32_TN;
  // copies per staged row, per slice, per thread
  constexpr int A_CPR = BK / VEC, A_COPIES = BM * A_CPR;
  constexpr int A_N = (A_COPIES + F32_THREADS - 1) / F32_THREADS;
  constexpr int B_CPR = BN / VEC, B_COPIES = BK * B_CPR;
  constexpr int B_N = (B_COPIES + F32_THREADS - 1) / F32_THREADS;
  __shared__ __align__(16) float As[2][BK][F32_AP];  // As[stage][k][m]
  __shared__ __align__(16) float Bs[2][BK][BN];      // Bs[stage][k][n]
  __shared__ long long opix[BM];                     // each row's output offset
  __shared__ float okeep[BM];                        // and drop-path factor

  // a warp is 4 x 8 threads: 4 rows of threads read 4 float4 of As and 8
  // columns of threads 8 float4 (or float2) of Bs per k, one pass each
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty*4 .. +3 and BM/2 + ty*4 .. +3
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns tx*4 .. +3 (+ 64 g), then tx*2 .. +1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A [m][k] is stored transposed, so it goes through registers: slice s + 1
  // is read into ra before slice s's FMAs and stored after them; W [k][n] is
  // stored as it is, by cp.async into the stage the FMAs do not read
  float ra[A_N][VEC];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const int c = tid + i * F32_THREADS;
      const int gm = m0 + c / A_CPR, gk = k0 + (c % A_CPR) * VEC;
      const bool ok = c < A_COPIES && gm < M && gk < K;  // a copy is all in or all out
      if constexpr (VEC == 4) {
        const float4 v = ok ? *reinterpret_cast<const float4*>(A + (long long)gm * K + gk)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        ra[i][0] = v.x, ra[i][1] = v.y, ra[i][2] = v.z, ra[i][3] = v.w;
      } else {
        ra[i][0] = ok ? A[(long long)gm * K + gk] : 0.f;
      }
    }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const int c = tid + i * F32_THREADS;
      if (c < A_COPIES) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) As[st][(c % A_CPR) * VEC + q][c / A_CPR] = ra[i][q];
      }
    }
  };
  auto load_w = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      const int c = tid + i * F32_THREADS;
      if (c < B_COPIES) {
        const int r = c / B_CPR, cn = (c % B_CPR) * VEC;
        const int gk = k0 + r, gn = n0 + cn;
        const bool ok = gk < K && gn < N;
        cp_async<VEC * 4>(&Bs[st][r][cn], ok ? Wt + (long long)gk * N + gn : Wt, ok);
      }
    }
  };

  // one FMA chain per output, ascending k from 0, the bias added after it:
  // no split-K, no atomics, so repeats are bit for bit equal
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  auto compute = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[st][kk][BM / 2 + ty * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
#pragma unroll
      for (int g = 0; g < F32_NG4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[st][kk][g * 64 + tx * 4]);
        b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
      }
      if (F32_NG2) {
        const float2 v = *reinterpret_cast<const float2*>(&Bs[st][kk][F32_NG4 * 64 + tx * 2]);
        b[TN - 2] = v.x, b[TN - 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  // each row's pixel and keep factor, once per block (the 16 column threads
  // of a row share them); the first barrier below publishes them
  if (tid < BM) {
    const int gm = m0 + tid;
    opix[tid] = gm < M ? row_to_pixel(gm, map) * N : 0;
    if (EPI == EPI_RESIDUAL) okeep[tid] = gm < M ? dpm[gm / rows_per_img] : 0.f;
  }

  // two stages, one barrier per slice: slice s + 1's loads are in flight
  // while slice s's FMAs run; the barrier after them frees stage s % 2
  const int slices = (K + BK - 1) / BK;
  load_a(0);
  load_w(0, 0);
  cp_async_commit();
  store_a(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int st = s & 1;
    const bool more = s + 1 < slices;
    if (more) {
      load_a((s + 1) * BK);
      load_w(st ^ 1, (s + 1) * BK);
      cp_async_commit();
    }
    compute(st);
    if (more) {
      store_a(st ^ 1);
      cp_async_wait<0>();
      __syncthreads();
    }
  }

  // epilogue in registers, then each row's column groups stored at its pixel
  // (float4 / float2 with VEC 4: a group is all in or all out, as N % 4 == 0)
  auto col = [&](int j) {
    return j < 4 * F32_NG4 ? (j >> 2) * 64 + tx * 4 + (j & 3) : F32_NG4 * 64 + tx * 2 + (j & 1);
  };
  float bj[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + col(j);
    bj[j] = gn < N ? bias[gn] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i >> 2) * (BM / 2) + ty * 4 + (i & 3);
    if (m0 + r >= M) continue;
    const long long orow = opix[r];
    const float keep = EPI == EPI_RESIDUAL ? okeep[r] : 0.f;
    float y[TN], d[TN] = {};
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = acc[i][j] + bj[j];
      if (EPI == EPI_GELU || EPI == EPI_GELU_PAIR) {
        float g;
        gelu_pair_exact(v, g, d[j]);
        v = g;
      }
      y[j] = v;
    }
    // the group of Wd columns from the thread's column j0
    auto store = [&](int j0, auto wd) {
      constexpr int Wd = decltype(wd)::value;
      const int gn = n0 + col(j0);
      const long long o = orow + gn;
      if constexpr (VEC == 4) {
        if (gn >= N) return;
        Pack<float, Wd> p;
        if (EPI == EPI_RESIDUAL) p = load_pack<float, Wd>(res + o);
#pragma unroll
        for (int q = 0; q < Wd; ++q)
          p.v[q] = EPI == EPI_RESIDUAL ? p.v[q] + keep * y[j0 + q] : y[j0 + q];
        store_pack(out + o, p);
        if (EPI == EPI_GELU_PAIR) {
#pragma unroll
          for (int q = 0; q < Wd; ++q) p.v[q] = d[j0 + q];
          store_pack(gp + o, p);
        }
      } else {
#pragma unroll
        for (int q = 0; q < Wd; ++q) {
          if (gn + q >= N) continue;
          float v = y[j0 + q];
          if (EPI == EPI_RESIDUAL) v = res[o + q] + keep * v;
          out[o + q] = v;
          if (EPI == EPI_GELU_PAIR) gp[o + q] = d[j0 + q];
        }
      }
    };
#pragma unroll
    for (int g = 0; g < F32_NG4; ++g) store(4 * g, std::integral_constant<int, 4>());
    if (F32_NG2) store(TN - 2, std::integral_constant<int, 2>());
  }
}

// -- bf16 on the tensor cores (see the note at the top) -----------------------

constexpr int BM = 64;  // output tile: rows of M x columns of N
constexpr int BN = 64;
constexpr int MMA_BK = 32;        // reduction depth of one staged slice
constexpr int MMA_STAGES = 3;     // slices in the ring
constexpr int MMA_THREADS = 128;  // 4 warps, 2 x 2 over the tile, 32x32 each
constexpr int A_PITCH = MMA_BK + 8;  // shared row pitches in elements
constexpr int B_PITCH = BN + 8;
constexpr int O_PITCH = BN + 8;
constexpr int A_STAGE = BM * A_PITCH;
constexpr int B_STAGE = MMA_BK * B_PITCH;
constexpr int MMA_SMEM = MMA_STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);
constexpr int O_BYTES = BM * O_PITCH * (int)sizeof(bf16);  // the staged output tile
static_assert(O_BYTES + BM * O_PITCH * (int)sizeof(float) <= MMA_SMEM,
              "the staged output and gp tiles fit in the ring");

// VEC = elements per global access (8, 4, or 1 where K, N or a pointer do
// not allow packs); TGP = gp's element type (EPI_GELU_PAIR only)
template <int EPI, typename TGP, int VEC>
__global__ void __launch_bounds__(MMA_THREADS, 4)
gemm_bias_epilogue_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                              const float* __restrict__ bias, bf16* out, TGP* gp,
                              const bf16* res, const float* __restrict__ dpm, int M, int K,
                              int N, int rows_per_img, WinMap map) {
  // copies per staged row, rows between one thread's copies, copies per thread
  constexpr int A_CPR = MMA_BK / VEC, A_RSTEP = MMA_THREADS / A_CPR, A_N = BM / A_RSTEP;
  constexpr int B_CPR = BN / VEC, B_RSTEP = MMA_THREADS / B_CPR, B_N = MMA_BK / B_RSTEP;
  constexpr int O_CPR = BN / VEC, O_RSTEP = MMA_THREADS / O_CPR, O_N = BM / O_RSTEP;
  static_assert(MMA_THREADS % A_CPR == 0 && BM % A_RSTEP == 0 && MMA_THREADS % B_CPR == 0 &&
                MMA_BK % B_RSTEP == 0, "load layout");
  __shared__ __align__(16) unsigned char smem[MMA_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [stage][m][k]
  bf16* Bs = As + MMA_STAGES * A_STAGE;      // [stage][k][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 1;  // this warp's 32 rows (m) of the tile
  const int wn = (tid >> 5) & 1;   // and 32 columns (n)
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // slice k0 into stage st; with VEC > 1, K and N are multiples of VEC, so
  // a copy is wholly valid or wholly padding
  const int a_c = (tid % A_CPR) * VEC, a_r = tid / A_CPR;
  const int b_c = (tid % B_CPR) * VEC, b_r = tid / B_CPR;
  auto load = [&](int st, int k0) {
    bf16* as = As + st * A_STAGE;
    bf16* bs = Bs + st * B_STAGE;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const int r = a_r + i * A_RSTEP;
      const int gm = m0 + r, gk = k0 + a_c;
      const bool ok = gm < M && gk < K;
      const bf16* src = ok ? A + (long long)gm * K + gk : A;
      if constexpr (VEC == 1)
        as[r * A_PITCH + a_c] = ok ? *src : from_f<bf16>(0.f);
      else
        cp_async<VEC * (int)sizeof(bf16)>(as + r * A_PITCH + a_c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      const int r = b_r + i * B_RSTEP;
      const int gk = k0 + r, gn = n0 + b_c;
      const bool ok = gk < K && gn < N;
      const bf16* src = ok ? Wt + (long long)gk * N + gn : Wt;
      if constexpr (VEC == 1)
        bs[r * B_PITCH + b_c] = ok ? *src : from_f<bf16>(0.f);
      else
        cp_async<VEC * (int)sizeof(bf16)>(bs + r * B_PITCH + b_c, src, ok);
    }
  };

  // ldmatrix row addresses: lane l serves row l % 8 of matrix l / 8.  A
  // fragment (16 m x 16 k): matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
  // (m 0-7, k 8-15), (m 8-15, k 8-15); B fragments of two n8 tiles (16 k x
  // 8 n each): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
  // n 8-15).
  const int a_m = wm * 32 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int a_k = (lane >> 4) << 3;
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = wn * 32 + ((lane >> 4) << 3);
  float acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  auto compute = [&](int st) {
    const bf16* as = As + st * A_STAGE;
    const bf16* bs = Bs + st * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < MMA_BK; ks += 16) {
      unsigned af[2][4], bfr[4][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) ldmatrix_x4(af[t], as + (a_m + t * 16) * A_PITCH + ks + a_k);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (ks + b_k) * B_PITCH + b_n + p * 16);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[t][j], af[t], bfr[j][0], bfr[j][1]);
    }
  };

  // the ring: slice s lives in stage s % MMA_STAGES; at slice s, slices s and
  // s + 1 have been asked for, s + 2 is asked for after the barrier that
  // frees its stage (slice s - 1's), and then s feeds the mma
  const int slices = (K + MMA_BK - 1) / MMA_BK;
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < slices) load(s, s * MMA_BK);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();
    const int next = s + MMA_STAGES - 1;
    if (next < slices) load(next % MMA_STAGES, next * MMA_BK);
    cp_async_commit();
    compute(s % MMA_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now holds the output tile

  // accumulator (t, j): rows m = lane / 4 (+ 8), columns n = 2 (lane % 4) (+ 1)
  bf16* so = reinterpret_cast<bf16*>(smem);          // [m][n], rounded
  TGP* sg = reinterpret_cast<TGP*>(smem + O_BYTES);  // [m][n], gelu'
  const int cq = (lane & 3) << 1;
  float bj[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + wn * 32 + j * 8 + cq + e;
      bj[j][e] = gn < N ? bias[gn] : 0.f;
    }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + t * 16 + (lane >> 2) + h * 8;
        const int c = wn * 32 + j * 8 + cq;
        Pack<bf16, 2> o;
        Pack<TGP, 2> d;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[t][j][2 * h + e] + bj[j][e];
          if (EPI == EPI_GELU || EPI == EPI_GELU_PAIR) {
            float g, dv;
            gelu_pair_fast(v, g, dv);
            d.v[e] = from_f<TGP>(dv);
            v = g;
          }
          o.v[e] = from_f<bf16>(v);
        }
        store_pack(so + r * O_PITCH + c, o);
        if (EPI == EPI_GELU_PAIR) store_pack(sg + r * O_PITCH + c, d);
      }
  __syncthreads();

  // packed stores, each row at its pixel; with VEC > 1, N is a multiple of
  // VEC, so a pack is wholly in or out
  const int oc = (tid % O_CPR) * VEC;
  const int gn = n0 + oc;
  if (gn >= N) return;
  for (int i = 0; i < O_N; ++i) {
    const int r = tid / O_CPR + i * O_RSTEP;
    const int gm = m0 + r;
    if (gm >= M) break;
    const long long o = row_to_pixel(gm, map) * N + gn;
    Pack<bf16, VEC> y = load_pack<bf16, VEC>(so + r * O_PITCH + oc);
    if (EPI == EPI_RESIDUAL) {
      const float keep = dpm[gm / rows_per_img];
      const Pack<bf16, VEC> rv = load_pack<bf16, VEC>(res + o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) y.v[j] = from_f<bf16>(to_f(rv.v[j]) + keep * to_f(y.v[j]));
    }
    store_pack(out + o, y);
    if (EPI == EPI_GELU_PAIR) store_pack(gp + o, load_pack<TGP, VEC>(sg + r * O_PITCH + oc));
  }
}

struct Args {
  const void* A;
  const void* Wt;
  const float* bias;
  void* out;
  void* gp;
  const void* res;
  const float* dpm;
  int M, K, N, rows_per_img;
  WinMap map;
};

bool aligned(const void* p, size_t bytes) { return (size_t)p % bytes == 0; }

template <int EPI, int VEC>
void launch_f32_vec(cudaStream_t s, const Args& a) {
  const dim3 grid((a.N + F32_BN - 1) / F32_BN, (a.M + F32_BM - 1) / F32_BM);
  SEI_LAUNCH(grid, F32_THREADS, s, gemm_bias_epilogue_kernel<EPI, VEC>)(
      static_cast<const float*>(a.A), static_cast<const float*>(a.Wt), a.bias,
      static_cast<float*>(a.out), static_cast<float*>(a.gp), static_cast<const float*>(a.res),
      a.dpm, a.M, a.K, a.N, a.rows_per_img, a.map);
}

// float4 accesses where K, N and every pointer allow them, else one element
template <int EPI>
void launch_f32(cudaStream_t s, const Args& a) {
  if (a.K % 4 == 0 && a.N % 4 == 0 && aligned(a.A, 16) && aligned(a.Wt, 16) &&
      aligned(a.out, 16) && aligned(a.res, 16) && aligned(a.gp, 16))
    launch_f32_vec<EPI, 4>(s, a);
  else
    launch_f32_vec<EPI, 1>(s, a);
}

template <int EPI, typename TGP, int VEC>
void launch_mma_vec(dim3 grid, cudaStream_t s, const Args& a) {
  SEI_LAUNCH(grid, MMA_THREADS, s, gemm_bias_epilogue_mma_kernel<EPI, TGP, VEC>)(
      static_cast<const bf16*>(a.A), static_cast<const bf16*>(a.Wt), a.bias,
      static_cast<bf16*>(a.out), static_cast<TGP*>(a.gp), static_cast<const bf16*>(a.res),
      a.dpm, a.M, a.K, a.N, a.rows_per_img, a.map);
}

template <int EPI, typename TGP>
void launch_mma(int vec, dim3 grid, cudaStream_t s, const Args& a) {
  if (vec == 8)
    launch_mma_vec<EPI, TGP, 8>(grid, s, a);
  else if (vec == 4)
    launch_mma_vec<EPI, TGP, 4>(grid, s, a);
  else
    launch_mma_vec<EPI, TGP, 1>(grid, s, a);
}

// the widest pack (elements) that K, N and every pointer allow: 16 bytes of
// bf16, 8, or one element; gp's packs are as wide in elements (two 16-byte
// accesses for 8 f32)
int pack_width(const Args& a, size_t gp_size) {
  const int widths[2] = {8, 4};
  for (int v : widths) {
    const size_t bytes = v * sizeof(bf16);
    if (a.K % v == 0 && a.N % v == 0 && aligned(a.A, bytes) && aligned(a.Wt, bytes) &&
        aligned(a.out, bytes) && aligned(a.res, bytes) &&
        aligned(a.gp, v * gp_size < 16 ? v * gp_size : 16))
      return v;
  }
  return 1;
}

}  // namespace

extern "C" int sei_gemm_bias_epilogue(int device, int is_bf16, const void* A,
                                      const void* Wt, const float* bias, void* out,
                                      void* gp, int gp_bf16, const void* res,
                                      const float* dpm, int M, int K, int N,
                                      int epilogue, int rows_per_img, int windowed,
                                      int H, int W, int ws, int shift, void* stream) {
  if (M < 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);  // bf16's; f32's rows are F32_BM >= BM
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_RESIDUAL && (res == nullptr || dpm == nullptr || rows_per_img <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_GELU_PAIR && gp == nullptr) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && gp_bf16) return (int)cudaErrorInvalidValue;  // f32 keeps gelu' in f32
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{A, Wt, bias, out, gp, res, dpm, M, K, N, rows_per_img,
               WinMap{windowed, H, W, ws, shift}};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {
    switch (epilogue) {
      case EPI_NONE: launch_f32<EPI_NONE>(s, a); break;
      case EPI_GELU: launch_f32<EPI_GELU>(s, a); break;
      case EPI_RESIDUAL: launch_f32<EPI_RESIDUAL>(s, a); break;
      case EPI_GELU_PAIR: launch_f32<EPI_GELU_PAIR>(s, a); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const int vec = pack_width(a, gp_bf16 ? sizeof(bf16) : sizeof(float));
  switch (epilogue) {
    case EPI_NONE: launch_mma<EPI_NONE, bf16>(vec, grid, s, a); break;
    case EPI_GELU: launch_mma<EPI_GELU, bf16>(vec, grid, s, a); break;
    case EPI_RESIDUAL: launch_mma<EPI_RESIDUAL, bf16>(vec, grid, s, a); break;
    case EPI_GELU_PAIR:
      if (gp_bf16)
        launch_mma<EPI_GELU_PAIR, bf16>(vec, grid, s, a);
      else
        launch_mma<EPI_GELU_PAIR, float>(vec, grid, s, a);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
