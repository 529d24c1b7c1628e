// window_attn_fwd: softmax(scale * q k^T + bias[h] (+ mask[w % nW])) v over
// windows of N <= 64 tokens, head dim hd <= 32.  Storage type T (float, or
// bf16 for the bf16 training recipe) for q, k, v, the output and the saved
// probabilities; f32 scores, bias, mask and softmax.
//
// Replaces sei_tpu/ops/attention.py _fwd_kernel (:65-76) and the attention
// section of the TPU trunk kernel (sei_tpu/ops/swin_trunk.py :446-477),
// including the probability save of mode "full" (p_ref, :487-490; K5): the
// softmax is rounded to T (:467) before P.V reads it and before it is saved,
// and the output is rounded to T (:470-473).  At the flagship shapes (N = 64,
// hd = 30) one (window, head) pair is 2 * 2 * 64 * 64 * 30 = 0.49 MFLOP
// against 4 * 64 * 30 elements of q, k, v and output (+ 64 * 64 of p when
// saved): in f32 ~16 flops per byte, near the FP32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20); in bf16 ~32 (~8 with the p save), far below the bf16
// ridge of 295 (989 TFLOP/s), so bytes bound it.  Design: one 128-thread
// block per (window, head); q and v staged in shared memory as f32 padded to
// 32 (+1 column against bank conflicts), each thread keeps one key row in
// registers and writes one column of the 64x64 score tile (bias and mask
// reads coalesced along that column), the f32 max-subtracted softmax is a
// warp per row, and P.V reads P rows as broadcasts.  The scores never leave
// shared memory; p does only when the caller asks for it (p_out, (B_, nh, N,
// N) contiguous, written a row per warp).  Strides are arguments, so the
// trunk feeds it straight from the qkv GEMM output (B_, N, 3, nh, hd) and
// writes the (B_, N, nh, hd) layout the proj GEMM reads.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int AN = 64;        // max tokens per window (ws <= 8)
constexpr int AD = 32;        // max head dim (padded)
constexpr int kThreads = 128;

struct Strides {
  long long w, h, n;  // window, head, token; the head-dim stride is 1
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ mask, T* __restrict__ out,
                       T* __restrict__ p_out, int nh, int N, int hd, int nW,
                       Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  __shared__ float qs[AN][AD + 1];
  __shared__ float vs[AN][AD + 1];
  __shared__ float ps[AN][AN + 1];

  const int tid = threadIdx.x;
  const long long w = blockIdx.x / nh;
  const int h = (int)(blockIdx.x - w * nh);
  const T* qb = q + w * sq.w + h * sq.h;
  const T* kb = k + w * sk.w + h * sk.h;
  const T* vb = v + w * sv.w + h * sv.h;
  T* ob = out + w * so.w + h * so.h;

  for (int idx = tid; idx < AN * AD; idx += kThreads) {
    const int n = idx / AD;
    const int d = idx - n * AD;
    const bool ok = n < N && d < hd;
    qs[n][d] = ok ? to_f(qb[n * sq.n + d]) : 0.f;
    vs[n][d] = ok ? to_f(vb[n * sv.n + d]) : 0.f;
  }
  const int j = tid & (AN - 1);  // this thread's key / score column
  const int half = tid >> 6;     // rows half, half + 2, ...
  float kr[AD];
#pragma unroll
  for (int d = 0; d < AD; ++d) kr[d] = (j < N && d < hd) ? to_f(kb[j * sk.n + d]) : 0.f;
  __syncthreads();

  if (j < N) {
    const float* bcol = bias + (long long)h * N * N + j;
    const float* mcol = mask ? mask + (w % nW) * N * N + j : nullptr;
    for (int i = half; i < N; i += 2) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < AD; ++d) s = fmaf(qs[i][d], kr[d], s);
      s = s * scale + bcol[i * N];
      if (mcol) s += mcol[i * N];
      ps[i][j] = s;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  T* pb = p_out ? p_out + ((w * nh + h) * N) * N : nullptr;
  for (int i = warp; i < N; i += kThreads / 32) {
    const float a = lane < N ? ps[i][lane] : -INFINITY;
    const float b = lane + 32 < N ? ps[i][lane + 32] : -INFINITY;
    const float m = warp_max(fmaxf(a, b));
    const float ea = lane < N ? expf(a - m) : 0.f;
    const float eb = lane + 32 < N ? expf(b - m) : 0.f;
    const float sum = warp_sum(ea + eb);
    const float pa = round_as<T>(ea / sum), pb2 = round_as<T>(eb / sum);
    if (lane < N) ps[i][lane] = pa;
    if (lane + 32 < N) ps[i][lane + 32] = pb2;
    if (pb) {
      if (lane < N) pb[i * N + lane] = from_f<T>(pa);
      if (lane + 32 < N) pb[i * N + lane + 32] = from_f<T>(pb2);
    }
  }
  __syncthreads();

  if (lane < hd) {
    for (int i = warp; i < N; i += kThreads / 32) {
      float acc = 0.f;
      for (int jj = 0; jj < N; ++jj) acc = fmaf(ps[i][jj], vs[jj][lane], acc);
      ob[i * so.n + lane] = from_f<T>(acc);
    }
  }
}

}  // namespace

extern "C" int sei_window_attn_fwd(
    int device, int is_bf16, const void* q, const void* k, const void* v,
    const float* bias, const float* mask, void* out, void* p_out,
    long long n_windows, int nh, int N, int hd, int nW, long long sq_w,
    long long sq_h, long long sq_n, long long sk_w, long long sk_h,
    long long sk_n, long long sv_w, long long sv_h, long long sv_n,
    long long so_w, long long so_h, long long so_n, float scale, void* stream) {
  if (N <= 0 || N > AN || hd <= 0 || hd > AD || nh <= 0)
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && nW <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = n_windows * nh;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SEI_DISPATCH_T(is_bf16,
      window_attn_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          bias, mask, static_cast<T*>(out), static_cast<T*>(p_out), nh, N, hd, nW,
          Strides{sq_w, sq_h, sq_n}, Strides{sk_w, sk_h, sk_n},
          Strides{sv_w, sv_h, sv_n}, Strides{so_w, so_h, so_n}, scale));
  return (int)cudaGetLastError();
}
