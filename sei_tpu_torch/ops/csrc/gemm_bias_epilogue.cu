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
// f32 (gemm_bias_epilogue_kernel): a 64x64 output tile per 256-thread block,
// K staged through shared memory 16 deep (A stored transposed so the inner
// loop reads float4 along M and along N), a 4x4 register tile per thread of
// CUDA-core FMAs, the epilogue applied in registers before the single store.
// TF32 stays off, so f32 stays on the CUDA cores.
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

#include "common.cuh"

namespace {

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_PAIR = 3 };

constexpr int BM = 64;  // output tile: rows of M x columns of N, both kernels
constexpr int BN = 64;

// -- f32 on the CUDA cores ----------------------------------------------------

constexpr int BK = 16;
constexpr int kThreads = 256;

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bias_epilogue_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                          const float* __restrict__ bias, float* out, float* gp,
                          const float* res, const float* __restrict__ dpm,
                          int M, int K, int N, int rows_per_img, WinMap map) {
  __shared__ __align__(16) float As[BK][BM + 4];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];      // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx*4 .. +3
  const int ty = tid >> 4;  // output rows    ty*4 .. +3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  const int a_row = tid >> 2;       // 64 rows x 4 threads, 4 k each
  const int a_k = (tid & 3) * 4;
  const int b_k = tid >> 4;         // 16 k x 16 threads, 4 n each
  const int b_n = (tid & 15) * 4;
  const long long a_m = (long long)m0 + a_row;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      As[a_k + i][a_row] = (a_m < M && gk < K) ? A[a_m * K + gk] : 0.f;
    }
    const int gk = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + b_n + i;
      Bs[b_k][b_n + i] = (gk < K && gn < N) ? Wt[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const long long orow = row_to_pixel(gm, map) * N;
    float keep = 0.f;
    if (EPI == EPI_RESIDUAL) keep = dpm[gm / rows_per_img];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j] + bias[gn];
      if (EPI == EPI_GELU || EPI == EPI_GELU_PAIR) {
        float g, d;
        gelu_pair_exact(v, g, d);
        if (EPI == EPI_GELU_PAIR) gp[orow + gn] = d;
        v = g;
      }
      if (EPI == EPI_RESIDUAL) v = res[orow + gn] + keep * v;
      out[orow + gn] = v;
    }
  }
}

// -- bf16 on the tensor cores (see the note at the top) -----------------------

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

template <int EPI>
void launch_f32(dim3 grid, cudaStream_t s, const Args& a) {
  gemm_bias_epilogue_kernel<EPI><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a.A), static_cast<const float*>(a.Wt), a.bias,
      static_cast<float*>(a.out), static_cast<float*>(a.gp), static_cast<const float*>(a.res),
      a.dpm, a.M, a.K, a.N, a.rows_per_img, a.map);
}

template <int EPI, typename TGP, int VEC>
void launch_mma_vec(dim3 grid, cudaStream_t s, const Args& a) {
  gemm_bias_epilogue_mma_kernel<EPI, TGP, VEC><<<grid, MMA_THREADS, 0, s>>>(
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

bool aligned(const void* p, size_t bytes) { return (size_t)p % bytes == 0; }

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
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
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
      case EPI_NONE: launch_f32<EPI_NONE>(grid, s, a); break;
      case EPI_GELU: launch_f32<EPI_GELU>(grid, s, a); break;
      case EPI_RESIDUAL: launch_f32<EPI_RESIDUAL>(grid, s, a); break;
      case EPI_GELU_PAIR: launch_f32<EPI_GELU_PAIR>(grid, s, a); break;
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
