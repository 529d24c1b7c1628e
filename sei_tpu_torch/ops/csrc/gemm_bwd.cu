// gemm_dgrad / gemm_wgrad: the data-grad and weight-grad products of the
// Swin trunk's backward, in f32 with f32 accumulation (TF32 off).
//
// Both read their output-gradient operand through one prologue: row m of it
// is  s[m / rows_per_img] * dy[p(m)],  with p = row_to_pixel (common.cuh) and
// s the per-image drop-path keep factor (optional).  That folds the window
// partition + roll of the residual gradient (proj backward) and the dpm
// scale of both residual branches into the load, as the forward folds them
// into gemm_bias_epilogue's store.
//
//   gemm_dgrad:  out (M, K) = (s . dy[p]) @ W^T,  W (K, N) in x out,
//                optionally times gelu'(pre) (M, K) in the epilogue
//                (fc2 backward -> d of the fc1 pre-activation).
//   gemm_wgrad:  dW (K, N) = A^T (s . dy[p]),  db (N,) = column sums of
//                (s . dy[p]); the token axis M is split over gridDim.z and
//                each split writes a partial (the caller sums them).
//
// Replace the products of the TPU trunk's backward kernel
// (sei_tpu/ops/swin_trunk.py _block_bwd_image :663-669 (fc2/fc1),
// :740 / :786-803 (proj, qkv), with _gelu_grad :170 in the fc2 -> fc1 step
// and the per-group partial weight grads of _bwd_pallas :1153-1174 summed
// at :1198-1203).  On the H100 they are bound by FP32 operations on the CUDA
// cores (67 TFLOP/s): 2*M*K*N flops against (M*K + M*N + K*N) f32 words, ~45
// to 90 flops per byte at K, N in {180, 360, 540}.  Design of this first
// version, as gemm_bias_epilogue.cu: 64x64 output tiles per 256-thread block,
// 16-deep reduction slices staged through shared memory, a 4x4 register tile
// per thread; the gather and scale are applied on the load, GELU' in the
// epilogue.  wgmma/TMA come later.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_grad(float x) {
  // d/dx [x Phi(x)] = Phi(x) + x phi(x), exact erf as the forward's GELU
  return 0.5f * (1.f + erff(x * 0.70710678118654752f)) +
         x * expf(-0.5f * x * x) * 0.39894228040143268f;
}

// out[m][k] = sum_n s(m) dy[p(m)][n] W[k][n]  (M x K, reduction over N)
template <bool GELU>
__global__ void __launch_bounds__(kThreads)
gemm_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ Wt,
                  const float* __restrict__ scale, const float* __restrict__ pre,
                  float* __restrict__ out, int M, int N, int K,
                  int rows_per_img, WinMap map) {
  __shared__ __align__(16) float As[BK][BM + 4];  // As[n][m]
  __shared__ __align__(16) float Bs[BK][BN + 4];  // Bs[n][k]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns (k) tx*4 .. +3
  const int ty = tid >> 4;  // output rows    (m) ty*4 .. +3
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;

  const int l_row = tid >> 2;  // 64 rows x 4 threads, 4 reduction entries each
  const int l_n = (tid & 3) * 4;
  const int am = m0 + l_row;
  const float* arow = nullptr;
  float as = 0.f;
  if (am < M) {
    arow = dy + row_to_pixel(am, map) * N;
    as = scale ? scale[am / rows_per_img] : 1.f;
  }
  const int bk = k0 + l_row;
  const float* brow = bk < K ? Wt + (long long)bk * N : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + l_n + i;
      As[l_n + i][l_row] = (arow && gn < N) ? as * arow[gn] : 0.f;
      Bs[l_n + i][l_row] = (brow && gn < N) ? brow[gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < BK; ++nn) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[nn][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[nn][tx * 4]);
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + tx * 4 + j;
      if (gk >= K) continue;
      float o = acc[i][j];
      if (GELU) o *= gelu_grad(pre[(long long)gm * K + gk]);
      out[(long long)gm * K + gk] = o;
    }
  }
}

// dW[k][n] = sum_m A[m][k] s(m) dy[p(m)][n] over this split's rows m;
// blocks of the first k tile also sum db[n] = sum_m s(m) dy[p(m)][n].
__global__ void __launch_bounds__(kThreads)
gemm_wgrad_kernel(const float* __restrict__ A, const float* __restrict__ dy,
                  const float* __restrict__ scale, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int M, int K, int N, int chunk,
                  int rows_per_img, WinMap map) {
  __shared__ __align__(16) float As[BK][BM];  // As[m][k]
  __shared__ __align__(16) float Bs[BK][BN];  // Bs[m][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns (n) tx*4 .. +3
  const int ty = tid >> 4;  // output rows    (k) ty*4 .. +3
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int m_begin = z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bool with_bias = blockIdx.y == 0;

  const int l_m = tid >> 4;        // 16 rows x 16 threads, 4 columns each
  const int l_c = (tid & 15) * 4;

  float acc[4][4];
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int mb = m_begin; mb < m_end; mb += BK) {
    const int gm = mb + l_m;
    const bool ok = gm < m_end;
    const float* arow = ok ? A + (long long)gm * K : nullptr;
    const float* drow = ok ? dy + row_to_pixel(gm, map) * N : nullptr;
    const float s = (ok && scale) ? scale[gm / rows_per_img] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + l_c + i;
      const int gn = n0 + l_c + i;
      As[l_m][l_c + i] = (ok && gk < K) ? arow[gk] : 0.f;
      Bs[l_m][l_c + i] = (ok && gn < N) ? s * drow[gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < BK; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[mm][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[mm][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (with_bias && ty == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += bv[j];
      }
    }
    __syncthreads();
  }

  float* part = dw_part + (long long)z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty * 4 + i;
    if (gk >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) part[(long long)gk * N + gn] = acc[i][j];
    }
  }
  if (with_bias && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) db_part[(long long)z * N + gn] = bsum[j];
    }
  }
}

}  // namespace

extern "C" int sei_gemm_dgrad(int device, const float* dy, const float* Wt,
                              const float* scale, const float* pre, float* out,
                              int M, int N, int K, int rows_per_img,
                              int windowed, int H, int W, int ws, int shift,
                              void* stream) {
  if (M < 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (scale != nullptr && rows_per_img <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (pre != nullptr)
    gemm_dgrad_kernel<true><<<grid, kThreads, 0, s>>>(dy, Wt, scale, pre, out, M,
                                                      N, K, rows_per_img, map);
  else
    gemm_dgrad_kernel<false><<<grid, kThreads, 0, s>>>(dy, Wt, scale, pre, out, M,
                                                       N, K, rows_per_img, map);
  return (int)cudaGetLastError();
}

extern "C" int sei_gemm_wgrad(int device, const float* A, const float* dy,
                              const float* scale, float* dw_part, float* db_part,
                              int M, int K, int N, int splits, int rows_per_img,
                              int windowed, int H, int W, int ws, int shift,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (scale != nullptr && rows_per_img <= 0) return (int)cudaErrorInvalidValue;
  // each split takes a whole number of BK-row slices
  const int chunk = ((M + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  gemm_wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      A, dy, scale, dw_part, db_part, M, K, N, chunk, rows_per_img, map);
  return (int)cudaGetLastError();
}
