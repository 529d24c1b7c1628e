// gemm_bias_epilogue: out = epilogue(A . W + b) in f32 with f32 accumulation.
//
// Replaces the four matrix products the TPU trunk kernel computes inside its
// Pallas body (sei_tpu/ops/swin_trunk.py _fwd_kernel: qkv :448, proj :474,
// fc1 :539, fc2 :544-547) together with what follows each of them there:
//   EPI_NONE      qkv:  out = A.W + b
//   EPI_GELU      fc1:  out = gelu(A.W + b), exact GELU with erff
//   EPI_GELU_PRE  fc1 in the training backward's recompute: as EPI_GELU,
//                 and the pre-activation A.W + b stored beside it in `pre`
//                 (the GELU' factor of the fc2 data-grad reads it)
//   EPI_RESIDUAL  proj, fc2: out[p] = res[p] + dpm[img] * (A.W + b), where
//                 p = row_to_pixel(row) folds window reverse and the +shift
//                 roll into the store (:508-510) and dpm is the per-image
//                 drop-path keep factor of the branch (:597, :600).
// On the H100 the eval is f32 with TF32 off, so the bound is operations on
// the CUDA cores (67 TFLOP/s FP32): 2*M*K*N flops against (M*K + K*N + M*N)
// f32 words moved, i.e. ~45-90 flops per byte at K = 180/360.  Design of
// this first version: a 64x64 output tile per 256-thread block, K staged
// through shared memory 16 deep (A stored transposed so the inner loop reads
// float4 along M and along N), a 4x4 register tile per thread, the epilogue
// applied in registers before the single store.  wgmma/TMA come later.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_GELU_PRE = 3 };

template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_bias_epilogue_kernel(const float* __restrict__ A,
                          const float* __restrict__ Wt,
                          const float* __restrict__ bias, float* out,
                          float* __restrict__ pre, const float* res,
                          const float* __restrict__ dpm,
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
      if (EPI == EPI_GELU_PRE) pre[orow + gn] = v;
      if (EPI == EPI_GELU || EPI == EPI_GELU_PRE) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      if (EPI == EPI_RESIDUAL) v = res[orow + gn] + keep * v;
      out[orow + gn] = v;
    }
  }
}

}  // namespace

extern "C" int sei_gemm_bias_epilogue(int device, const float* A, const float* Wt,
                                      const float* bias, float* out,
                                      float* pre, const float* res,
                                      const float* dpm, int M, int K, int N,
                                      int epilogue,
                                      int rows_per_img, int windowed, int H,
                                      int W, int ws, int shift, void* stream) {
  if (M < 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_RESIDUAL && (res == nullptr || dpm == nullptr || rows_per_img <= 0))
    return (int)cudaErrorInvalidValue;
  if (epilogue == EPI_GELU_PRE && pre == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  cudaStream_t s = (cudaStream_t)stream;
  switch (epilogue) {
    case EPI_NONE:
      gemm_bias_epilogue_kernel<EPI_NONE><<<grid, kThreads, 0, s>>>(
          A, Wt, bias, out, pre, res, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_GELU:
      gemm_bias_epilogue_kernel<EPI_GELU><<<grid, kThreads, 0, s>>>(
          A, Wt, bias, out, pre, res, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_RESIDUAL:
      gemm_bias_epilogue_kernel<EPI_RESIDUAL><<<grid, kThreads, 0, s>>>(
          A, Wt, bias, out, pre, res, dpm, M, K, N, rows_per_img, map);
      break;
    case EPI_GELU_PRE:
      gemm_bias_epilogue_kernel<EPI_GELU_PRE><<<grid, kThreads, 0, s>>>(
          A, Wt, bias, out, pre, res, dpm, M, K, N, rows_per_img, map);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
