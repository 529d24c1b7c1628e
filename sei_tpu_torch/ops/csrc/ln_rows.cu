// ln_rows: LayerNorm over the channel axis of a (rows, C) f32 matrix, with
// the cyclic shift and window partition folded into the load.
//
// Replaces the LN1/LN2 stages of the TPU trunk kernel
// (sei_tpu/ops/swin_trunk.py _fwd_kernel -> _ln_fwd, :242-249, and the roll +
// _window_tokens of :263-270, :432-433).  On the H100 it is bound by bytes:
// each row is read once and written once (2 x 4 x C bytes per row, a few
// flops per byte).  Design: one warp per row, the row held in registers
// (C <= 256, 8 values per lane), two-pass mean/variance in f32 with warp
// shuffles, eps 1e-5 as the reference; the window gather is an index
// computation on the load (no separate roll/partition pass over memory).

#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;  // C <= 32 * 8 = 256 channels
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               long long rows, int C, float eps, WinMap map) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* xr = x + row_to_pixel(row, map) * C;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? xr[c] : 0.f;
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
  float* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = (v[i] - mu) * inv * gamma[c] + beta[c];
  }
}

}  // namespace

extern "C" const char* sei_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int sei_ln_rows(int device, const float* x, const float* gamma,
                           const float* beta, float* out, long long rows, int C,
                           float eps, int windowed, int H, int W, int ws,
                           int shift, void* stream) {
  if (C <= 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const WinMap map{windowed, H, W, ws, shift};
  ln_rows_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                   (cudaStream_t)stream>>>(x, gamma, beta, out, rows, C, eps,
                                           map);
  return (int)cudaGetLastError();
}
