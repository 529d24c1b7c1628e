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
// _bwd_pallas :1153-1174 summed at :1198-1203), for with_saved=False (K6)
// and with_saved=True (K7).  Bound on the H100: 2*M*K*N flops against
// (M*K + M*N + K*N) elements, ~45-90 flops per byte in f32 at K, N in {180,
// 360, 540} (above the FP32 ridge of 20: operations bound, 67 TFLOP/s); in
// bf16 ~90-180 against the bf16 ridge of 295 (989 TFLOP/s): bytes bound.
// Design of this first version, as gemm_bias_epilogue.cu: 64x64 output tiles
// per 256-thread block, 16-deep reduction slices staged through shared
// memory as f32, a 4x4 register tile of CUDA-core FMAs per thread; the
// gather, scale and rounding are applied on the load, gp in the epilogue.
// mma/wgmma/TMA come later.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;

// out[m][k] = sum_n round_T(s(m) dy[p(m)][n]) W[k][n]  (M x K, reduction over N)
template <typename T, typename TDY, typename TOUT, bool GP>
__global__ void __launch_bounds__(kThreads)
gemm_dgrad_kernel(const TDY* __restrict__ dy, const T* __restrict__ Wt,
                  const float* __restrict__ scale, Buf gp, TOUT* __restrict__ out, int M,
                  int N, int K, int rows_per_img, WinMap map) {
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
  const TDY* arow = nullptr;
  float as = 0.f;
  if (am < M) {
    arow = dy + row_to_pixel(am, map) * N;
    as = scale ? scale[am / rows_per_img] : 1.f;
  }
  const int bk = k0 + l_row;
  const T* brow = bk < K ? Wt + (long long)bk * N : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + l_n + i;
      As[l_n + i][l_row] = (arow && gn < N) ? round_as<T>(as * to_f(arow[gn])) : 0.f;
      Bs[l_n + i][l_row] = (brow && gn < N) ? to_f(brow[gn]) : 0.f;
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
      const long long idx = (long long)gm * K + gk;
      float o = acc[i][j];
      if (GP) o *= gp.ld(idx);
      out[idx] = from_f<TOUT>(o);
    }
  }
}

// dW[k][n] = sum_m A[m][k] round_T(s(m) dy[p(m)][n]) over this split's rows m;
// blocks of the first k tile also sum db[n] over the same rows, of the
// rounded operand or of the f32 one (db_rounded).
template <typename T, typename TDY>
__global__ void __launch_bounds__(kThreads)
gemm_wgrad_kernel(const T* __restrict__ A, const TDY* __restrict__ dy,
                  const float* __restrict__ scale, float* __restrict__ dw_part,
                  float* __restrict__ db_part, int M, int K, int N, int chunk,
                  int rows_per_img, int db_rounded, WinMap map) {
  __shared__ __align__(16) float As[BK][BM];  // As[m][k]
  __shared__ __align__(16) float Bs[BK][BN];  // Bs[m][n]
  __shared__ __align__(16) float Ds[BK][BN];  // Bs before rounding (bias sums)

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns (n) tx*4 .. +3
  const int ty = tid >> 4;  // output rows    (k) ty*4 .. +3
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int m_begin = z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bool with_bias = blockIdx.y == 0;
  // f32 storage rounds nothing, so the bias sums read Bs
  const bool raw_bias = sizeof(T) != sizeof(float) && !db_rounded;
  const float(*bias_src)[BN] = raw_bias ? Ds : Bs;

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
    const T* arow = ok ? A + (long long)gm * K : nullptr;
    const TDY* drow = ok ? dy + row_to_pixel(gm, map) * N : nullptr;
    const float s = (ok && scale) ? scale[gm / rows_per_img] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + l_c + i;
      const int gn = n0 + l_c + i;
      As[l_m][l_c + i] = (ok && gk < K) ? to_f(arow[gk]) : 0.f;
      const float u = (ok && gn < N) ? s * to_f(drow[gn]) : 0.f;
      Bs[l_m][l_c + i] = round_as<T>(u);
      if (raw_bias && with_bias) Ds[l_m][l_c + i] = u;
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
        for (int j = 0; j < 4; ++j) bsum[j] += bias_src[mm][tx * 4 + j];
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

template <typename T, typename TDY, typename TOUT>
void launch_dgrad(dim3 grid, cudaStream_t s, const void* dy, const void* Wt,
                  const float* scale, Buf gp, void* out, int M, int N, int K,
                  int rows_per_img, WinMap map) {
  const TDY* d = static_cast<const TDY*>(dy);
  const T* w = static_cast<const T*>(Wt);
  TOUT* o = static_cast<TOUT*>(out);
  if (gp.p != nullptr)
    gemm_dgrad_kernel<T, TDY, TOUT, true><<<grid, kThreads, 0, s>>>(d, w, scale, gp, o, M,
                                                                    N, K, rows_per_img, map);
  else
    gemm_dgrad_kernel<T, TDY, TOUT, false><<<grid, kThreads, 0, s>>>(d, w, scale, gp, o, M,
                                                                     N, K, rows_per_img, map);
}

template <typename TDY>
void launch_dgrad_bf16(int out_bf16, dim3 grid, cudaStream_t s, const void* dy,
                       const void* Wt, const float* scale, Buf gp, void* out, int M, int N,
                       int K, int rows_per_img, WinMap map) {
  if (out_bf16)
    launch_dgrad<bf16, TDY, bf16>(grid, s, dy, Wt, scale, gp, out, M, N, K, rows_per_img, map);
  else
    launch_dgrad<bf16, TDY, float>(grid, s, dy, Wt, scale, gp, out, M, N, K, rows_per_img, map);
}

template <typename T, typename TDY>
void launch_wgrad(dim3 grid, cudaStream_t s, const void* A, const void* dy,
                  const float* scale, float* dw_part, float* db_part, int M, int K,
                  int N, int chunk, int rows_per_img, int db_rounded, WinMap map) {
  gemm_wgrad_kernel<T, TDY><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(A), static_cast<const TDY*>(dy), scale, dw_part, db_part,
      M, K, N, chunk, rows_per_img, db_rounded, map);
}

}  // namespace

extern "C" int sei_gemm_dgrad(int device, int is_bf16, const void* dy, int dy_bf16,
                              const void* Wt, const float* scale, const void* gp,
                              int gp_bf16, void* out, int out_bf16, int M, int N,
                              int K, int rows_per_img, int windowed, int H, int W,
                              int ws, int shift, void* stream) {
  if (M < 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (scale != nullptr && rows_per_img <= 0) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && (dy_bf16 || out_bf16)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((K + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  const Buf g{const_cast<void*>(gp), gp_bf16};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    launch_dgrad<float, float, float>(grid, s, dy, Wt, scale, g, out, M, N, K, rows_per_img,
                                      map);
  else if (dy_bf16)
    launch_dgrad_bf16<bf16>(out_bf16, grid, s, dy, Wt, scale, g, out, M, N, K, rows_per_img,
                            map);
  else
    launch_dgrad_bf16<float>(out_bf16, grid, s, dy, Wt, scale, g, out, M, N, K, rows_per_img,
                             map);
  return (int)cudaGetLastError();
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
  // each split takes a whole number of BK-row slices
  const int chunk = ((M + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    launch_wgrad<float, float>(grid, s, A, dy, scale, dw_part, db_part, M, K, N, chunk,
                               rows_per_img, db_rounded, map);
  else if (dy_bf16)
    launch_wgrad<bf16, bf16>(grid, s, A, dy, scale, dw_part, db_part, M, K, N, chunk,
                             rows_per_img, db_rounded, map);
  else
    launch_wgrad<bf16, float>(grid, s, A, dy, scale, dw_part, db_part, M, K, N, chunk,
                              rows_per_img, db_rounded, map);
  return (int)cudaGetLastError();
}
