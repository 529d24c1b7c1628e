// window_attn_bwd: gradients of o = softmax(scale * q k^T + bias[h]
// (+ mask[w % nW])) v over windows of N <= 64 tokens, head dim hd <= 32, f32.
//
// Replaces sei_tpu/ops/attention.py _bwd_kernel (:117-152, called from
// _bwd_pallas :155) and the attention section of the TPU trunk's backward
// (sei_tpu/ops/swin_trunk.py _block_bwd_image :733-805).  Like the TPU kernel
// it recomputes p from q, k, bias and mask (no saved p), then
//   dv = p^T do,  dp = do v^T,  ds = p (dp - rowsum(dp p)),
//   dq = scale ds k,  dk = scale ds^T q,  dbias = sum over windows of ds.
// At the flagship shapes (N = 64, hd = 30) one (window, head) pair is
// 5 x 2 x 64 x 64 x 30 = 1.2 MFLOP against 7 x 64 x 30 x 4 = 54 KB of q, k, v,
// do, dq, dk and dv: ~23 flops per byte, at the H100's FP32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20), so both the CUDA-core FMAs and the
// bytes bound it.
//
// Design: a 128-thread block per (head, window group) walks the windows
// g, g + groups, ... of its group, so the dbias sum over windows stays in
// registers (thread (j, half) owns column j, rows half, half + 2, ...) and
// each block writes one (N, N) partial; the caller sums the partials (no
// atomics, so the gradient is the same from run to run).  Per window: q, k
// and do staged in shared memory padded to 32 (+1 column against bank
// conflicts), the thread's v row in registers, the 64x64 score tile in
// shared memory, the same max-subtracted f32 softmax as window_attn_fwd (so
// p is bit-identical to the forward's), the rowsum(dp p) reduced with warp
// shuffles, and ds written over p once dv has read it.  Strides are
// arguments: the trunk reads q/k/v/do straight from its qkv and proj
// buffers and writes dq/dk/dv into the (B_, N, 3, nh, hd) buffer the qkv
// weight-grad and data-grad GEMMs read.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int AN = 64;  // max tokens per window (ws <= 8)
constexpr int AD = 32;  // max head dim (padded)
constexpr int kThreads = 128;
constexpr int kRows = AN / 2;  // score rows per thread (half, half + 2, ...)

struct Strides {
  long long w, h, n;  // window, head, token; the head-dim stride is 1
};

__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dbias_part, long long n_windows,
                       int nh, int N, int hd, int nW, int groups, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdq,
                       Strides sdk, Strides sdv, float scale) {
  __shared__ float qs[AN][AD + 1];
  __shared__ float ks[AN][AD + 1];
  __shared__ float dos[AN][AD + 1];
  __shared__ float ps[AN][AN + 1];
  __shared__ float rowdot[2][AN];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int grp = blockIdx.y;
  const int j = tid & (AN - 1);  // this thread's key / score column
  const int half = tid >> 6;     // score rows half, half + 2, ...
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d0 = half * (AD / 2);  // this thread's half of the head dim

  float dbias[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dbias[r] = 0.f;

  for (long long w = grp; w < n_windows; w += groups) {
    const float* qb = q + w * sq.w + h * sq.h;
    const float* kb = k + w * sk.w + h * sk.h;
    const float* vb = v + w * sv.w + h * sv.h;
    const float* db = dout + w * sdo.w + h * sdo.h;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = tid; idx < AN * AD; idx += kThreads) {
      const int n = idx / AD;
      const int d = idx - n * AD;
      const bool ok = n < N && d < hd;
      qs[n][d] = ok ? qb[n * sq.n + d] : 0.f;
      ks[n][d] = ok ? kb[n * sk.n + d] : 0.f;
      dos[n][d] = ok ? db[n * sdo.n + d] : 0.f;
    }
    float vr[AD];
#pragma unroll
    for (int d = 0; d < AD; ++d) vr[d] = (j < N && d < hd) ? vb[j * sv.n + d] : 0.f;
    __syncthreads();

    // scores, exactly as window_attn_fwd computes them
    if (j < N) {
      const float* bcol = bias + (long long)h * N * N + j;
      const float* mcol = mask ? mask + (w % nW) * N * N + j : nullptr;
      for (int i = half; i < N; i += 2) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < AD; ++d) s = fmaf(qs[i][d], ks[j][d], s);
        s = s * scale + bcol[i * N];
        if (mcol) s += mcol[i * N];
        ps[i][j] = s;
      }
    }
    __syncthreads();
    for (int i = warp; i < N; i += kThreads / 32) {
      const float a = lane < N ? ps[i][lane] : -INFINITY;
      const float b = lane + 32 < N ? ps[i][lane + 32] : -INFINITY;
      const float m = warp_max(fmaxf(a, b));
      const float ea = lane < N ? expf(a - m) : 0.f;
      const float eb = lane + 32 < N ? expf(b - m) : 0.f;
      const float sum = warp_sum(ea + eb);
      if (lane < N) ps[i][lane] = ea / sum;
      if (lane + 32 < N) ps[i][lane + 32] = eb / sum;
    }
    __syncthreads();

    // dp = do v^T (registers) and the row sums of dp * p
    float dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      float t = 0.f;
      dp[r] = 0.f;
      if (i < N) {  // uniform across the warp
        if (j < N) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < AD; ++d) acc = fmaf(dos[i][d], vr[d], acc);
          dp[r] = acc;
          t = ps[i][j] * acc;
        }
        t = warp_sum(t);
        if (lane == 0) rowdot[warp & 1][i] = t;
      }
    }

    // dv_j = sum_i p_ij do_i, this thread's half of the head dim
    if (j < N) {
      float acc[AD / 2];
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float p = ps[i][j];
#pragma unroll
        for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = fmaf(p, dos[i][d0 + dd], acc[dd]);
      }
      float* out = dv + w * sdv.w + h * sdv.h + j * sdv.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = acc[dd];
    }
    __syncthreads();  // rowdot complete; every read of p done

    // ds = p (dp - rowsum), over p in shared memory; dbias accumulates
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      if (i < N && j < N) {
        const float ds = ps[i][j] * (dp[r] - (rowdot[0][i] + rowdot[1][i]));
        ps[i][j] = ds;
        dbias[r] += ds;
      }
    }
    __syncthreads();

    // dk_j = scale sum_i ds_ij q_i
    if (j < N) {
      float acc[AD / 2];
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float s = ps[i][j];
#pragma unroll
        for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = fmaf(s, qs[i][d0 + dd], acc[dd]);
      }
      float* out = dk + w * sdk.w + h * sdk.h + j * sdk.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = acc[dd] * scale;
    }
    // dq_i = scale sum_j ds_ij k_j, a warp per row, a lane per head-dim entry
    if (lane < hd) {
      float* out = dq + w * sdq.w + h * sdq.h;
      for (int i = warp; i < N; i += kThreads / 32) {
        float acc = 0.f;
        for (int jj = 0; jj < N; ++jj) acc = fmaf(ps[i][jj], ks[jj][lane], acc);
        out[i * sdq.n + lane] = acc * scale;
      }
    }
  }

  if (j < N) {
    float* part = dbias_part + ((long long)grp * nh + h) * N * N + j;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      if (i < N) part[i * N] = dbias[r];
    }
  }
}

}  // namespace

extern "C" int sei_window_attn_bwd(
    int device, const float* q, const float* k, const float* v,
    const float* bias, const float* mask, const float* dout, float* dq,
    float* dk, float* dv, float* dbias_part, long long n_windows, int nh,
    int N, int hd, int nW, int groups, long long sq_w, long long sq_h,
    long long sq_n, long long sk_w, long long sk_h, long long sk_n,
    long long sv_w, long long sv_h, long long sv_n, long long sdo_w,
    long long sdo_h, long long sdo_n, long long sdq_w, long long sdq_h,
    long long sdq_n, long long sdk_w, long long sdk_h, long long sdk_n,
    long long sdv_w, long long sdv_h, long long sdv_n, float scale,
    void* stream) {
  if (N <= 0 || N > AN || hd <= 0 || hd > AD || nh <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && nW <= 0) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (n_windows < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  window_attn_bwd_kernel<<<dim3(nh, groups), kThreads, 0, (cudaStream_t)stream>>>(
      q, k, v, bias, mask, dout, dq, dk, dv, dbias_part, n_windows, nh, N, hd,
      nW, groups, Strides{sq_w, sq_h, sq_n}, Strides{sk_w, sk_h, sk_n},
      Strides{sv_w, sv_h, sv_n}, Strides{sdo_w, sdo_h, sdo_n},
      Strides{sdq_w, sdq_h, sdq_n}, Strides{sdk_w, sdk_h, sdk_n},
      Strides{sdv_w, sdv_h, sdv_n}, scale);
  return (int)cudaGetLastError();
}
