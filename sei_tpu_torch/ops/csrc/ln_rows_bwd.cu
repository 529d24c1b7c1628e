// ln_rows_bwd: backward of ln_rows (LayerNorm over the channel axis, eps
// 1e-5, f32 statistics) with the window map folded into the load of x and the
// store of dx, and an optional residual gradient added on the store:
//   dx[p(r)] = dres[p(r)] + inv * (g - mean(g) - xhat * mean(g xhat)),
//   g = dz[r] * gamma,  xhat = (x[p(r)] - mu) * inv,
//   dgamma = sum_r dz[r] xhat,  dbeta = sum_r dz[r],
// with p = row_to_pixel (common.cuh): window reverse + unshift on the store,
// the mirror of ln_rows' shift + window partition on the load.
//
// Replaces the LN backward stages of the TPU trunk's backward kernel
// (sei_tpu/ops/swin_trunk.py _ln_bwd :252-257, called from _block_bwd_image
// :672 and :855-857, with the un-window and roll of :851-853 and the
// residual add dx = dx2 + ... of :857 / :711).  On the H100 it is bound by
// bytes: each row reads x, dz and dres once and writes dx once (16 bytes per
// channel), a few flops per byte.  Design: one warp per row, the row in
// registers (C <= 256, 8 values per lane), the statistics recomputed from x
// in f32 exactly as ln_rows computes them; each warp keeps its dgamma/dbeta
// sums in registers over the rows it walks, the block reduces its warps in
// shared memory and writes one (C,) partial per block, which the caller sums
// (no atomics: the same gradient from run to run).

#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;  // C <= 32 * 8 = 256 channels
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ dz, const float* __restrict__ dres,
                   float* __restrict__ dx, float* __restrict__ dgamma_part,
                   float* __restrict__ dbeta_part, long long rows, int C,
                   float eps, WinMap map) {
  __shared__ float sg[kWarpsPerBlock][32 * kMaxPerLane];
  __shared__ float sb[kWarpsPerBlock][32 * kMaxPerLane];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float gacc[kMaxPerLane], bacc[kMaxPerLane], gm[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    gacc[i] = 0.f;
    bacc[i] = 0.f;
    const int c = lane + 32 * i;
    gm[i] = c < C ? gamma[c] : 0.f;
  }

  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + warp; row < rows;
       row += stride) {  // uniform across the warp
    const long long pix = row_to_pixel(row, map) * C;
    const float* xr = x + pix;
    const float* dzr = dz + row * C;
    const float* rr = dres ? dres + pix : nullptr;
    // every load of the row issued up front (x, dz and dres are independent)
    float v[kMaxPerLane], g[kMaxPerLane], dzv[kMaxPerLane], rv[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? xr[c] : 0.f;
      dzv[i] = c < C ? dzr[c] : 0.f;
      rv[i] = (rr && c < C) ? rr[c] : 0.f;
      s += v[i];
    }
    const float mu = warp_sum(s) / (float)C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      const float d = c < C ? v[i] - mu : 0.f;
      ss += d * d;
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)C + eps);
    float sg_ = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      const float d = dzv[i];
      v[i] = c < C ? (v[i] - mu) * inv : 0.f;  // xhat
      g[i] = d * gm[i];
      gacc[i] = fmaf(d, v[i], gacc[i]);
      bacc[i] += d;
      sg_ += g[i];
      sgx = fmaf(g[i], v[i], sgx);
    }
    const float mean_g = warp_sum(sg_) / (float)C;
    const float mean_gx = warp_sum(sgx) / (float)C;
    float* dxr = dx + pix;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < C) dxr[c] = (g[i] - mean_g - v[i] * mean_gx) * inv + rv[i];
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    sg[warp][lane + 32 * i] = gacc[i];
    sb[warp][lane + 32 * i] = bacc[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kWarpsPerBlock * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarpsPerBlock; ++wi) {
      a += sg[wi][c];
      b += sb[wi][c];
    }
    dgamma_part[(long long)blockIdx.x * C + c] = a;
    dbeta_part[(long long)blockIdx.x * C + c] = b;
  }
}

}  // namespace

extern "C" int sei_ln_rows_bwd(int device, const float* x, const float* gamma,
                               const float* dz, const float* dres, float* dx,
                               float* dgamma_part, float* dbeta_part,
                               long long rows, int C, float eps, int blocks,
                               int windowed, int H, int W, int ws, int shift,
                               void* stream) {
  if (C <= 0 || C > 32 * kMaxPerLane || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (rows < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WinMap map{windowed, H, W, ws, shift};
  ln_rows_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      x, gamma, dz, dres, dx, dgamma_part, dbeta_part, rows, C, eps, map);
  return (int)cudaGetLastError();
}
