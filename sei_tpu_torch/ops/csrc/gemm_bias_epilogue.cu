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
// flops per byte, below the bf16 ridge of 295), so bytes bound it there.
// Design of this first version: a 64x64 output tile per 256-thread block, K
// staged through shared memory 16 deep as f32 (A stored transposed so the
// inner loop reads float4 along M and along N), a 4x4 register tile per
// thread of CUDA-core FMAs (the bf16 operands are exact in f32, so the
// products are the JAX dot's), the epilogue applied in registers before the
// single store.  mma/wgmma/TMA come later.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_PAIR = 3 };

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bias_epilogue_kernel(const T* __restrict__ A, const T* __restrict__ Wt,
                          const float* __restrict__ bias, T* out, Buf gp,
                          const T* res, const float* __restrict__ dpm,
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
      As[a_k + i][a_row] = (a_m < M && gk < K) ? to_f(A[a_m * K + gk]) : 0.f;
    }
    const int gk = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + b_n + i;
      Bs[b_k][b_n + i] = (gk < K && gn < N) ? to_f(Wt[(long long)gk * N + gn]) : 0.f;
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
        gelu_pair<T>(v, g, d);
        if (EPI == EPI_GELU_PAIR) gp.st(orow + gn, d);
        v = g;
      }
      if (EPI == EPI_RESIDUAL) v = to_f(res[orow + gn]) + keep * round_as<T>(v);
      out[orow + gn] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(int epilogue, dim3 grid, cudaStream_t s, const void* A, const void* Wt,
           const float* bias, void* out, Buf gp, const void* res, const float* dpm,
           int M, int K, int N, int rows_per_img, WinMap map) {
  const T* a = static_cast<const T*>(A);
  const T* w = static_cast<const T*>(Wt);
  T* o = static_cast<T*>(out);
  const T* r = static_cast<const T*>(res);
  switch (epilogue) {
    case EPI_NONE:
      gemm_bias_epilogue_kernel<T, EPI_NONE><<<grid, kThreads, 0, s>>>(
          a, w, bias, o, gp, r, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_GELU:
      gemm_bias_epilogue_kernel<T, EPI_GELU><<<grid, kThreads, 0, s>>>(
          a, w, bias, o, gp, r, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_RESIDUAL:
      gemm_bias_epilogue_kernel<T, EPI_RESIDUAL><<<grid, kThreads, 0, s>>>(
          a, w, bias, o, gp, r, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_GELU_PAIR:
      gemm_bias_epilogue_kernel<T, EPI_GELU_PAIR><<<grid, kThreads, 0, s>>>(
          a, w, bias, o, gp, r, dpm, M, K, N, rows_per_img, map);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  const Buf g{gp, gp_bf16};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<bf16>(epilogue, grid, s, A, Wt, bias, out, g, res, dpm, M, K, N,
                        rows_per_img, map);
  return launch<float>(epilogue, grid, s, A, Wt, bias, out, g, res, dpm, M, K, N,
                       rows_per_img, map);
}
