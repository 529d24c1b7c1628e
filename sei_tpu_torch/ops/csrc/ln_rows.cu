// ln_rows: LayerNorm over the channel axis of a (rows, C) matrix, with the
// cyclic shift and window partition folded into the load.  Storage type T
// (float or bf16) for x and the output; f32 statistics and f32 gamma/beta.
//
// Replaces the LN1/LN2 stages of the TPU trunk kernel
// (sei_tpu/ops/swin_trunk.py _fwd_kernel -> _ln_fwd, :242-249, and the roll +
// _window_tokens of :263-270, :432-433; in bf16 the output is cast before
// the GEMM that reads it, :429-430 and :537-539).  On the H100 it is bound by
// bytes: each row is read once and written once (2 x sizeof(T) x C bytes per
// row, a few flops per byte; 3.35 TB/s).  Design: one warp per row, the row
// held in registers (C <= 256, 8 values per lane), two-pass mean/variance in
// f32 with warp shuffles, eps 1e-5 as the reference; the window gather is an
// index computation on the load (no separate roll/partition pass over
// memory), and the output is rounded to T once, on the store.

#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;  // C <= 32 * 8 = 256 channels
constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ out,
               long long rows, int C, float eps, WinMap map) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + row_to_pixel(row, map) * C;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(xr[c]) : 0.f;
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
  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = from_f<T>((v[i] - mu) * inv * gamma[c] + beta[c]);
  }
}

}  // namespace

extern "C" const char* sei_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int sei_ln_rows(int device, int is_bf16, const void* x,
                           const float* gamma, const float* beta, void* out,
                           long long rows, int C, float eps, int windowed, int H,
                           int W, int ws, int shift, void* stream) {
  if (C <= 0 || C > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const WinMap map{windowed, H, W, ws, shift};
  SEI_DISPATCH_T(is_bf16,
      ln_rows_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          (cudaStream_t)stream>>>(
          static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), rows, C,
          eps, map));
  return (int)cudaGetLastError();
}
