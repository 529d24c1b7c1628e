// window_attn_bwd: gradients of o = softmax(scale * q k^T + bias[h]
// (+ mask[w % nW])) v over windows of N <= 64 tokens, head dim hd <= 32.
// Storage type T (float, or bf16 for the bf16 training recipe) for q, k, v,
// do, dq, dk, dv and the saved probabilities; f32 scores, softmax, ds and
// dbias.
//
// Replaces sei_tpu/ops/attention.py _bwd_kernel (:117-152, called from
// _bwd_pallas :155) and the attention section of the TPU trunk's backward
// (sei_tpu/ops/swin_trunk.py _block_bwd_image :733-805), in both of its
// forms: p recomputed from q, k, bias and mask (with_saved=False, K6), or p
// read from the forward's save (with_saved=True, :742-757; K7), in which case
// neither q k^T nor the softmax is recomputed.  Then
//   dv = p_T^T do,  dp = do v^T,  ds = p (dp - rowsum(dp p)),
//   dq = scale ds_T k,  dk = scale ds_T^T q,  dbias = sum over windows of ds,
// with p_T = p rounded to T (what P.V read in the forward, :767), ds and
// dbias in f32, ds_T = ds rounded to T (:779) and dq, dk, dv rounded to T
// (:797-800).  At the flagship shapes (N = 64, hd = 30) one (window, head)
// pair is 5 x 2 x 64 x 64 x 30 = 1.2 MFLOP against 7 x 64 x 30 elements of
// q, k, v, do, dq, dk, dv (+ 64 x 64 of p when saved): in f32 ~23 flops per
// byte, at the H100's FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20); in bf16
// ~21 with the p read, far below the bf16 ridge of 295, so bytes bound it.
//
// Design: a 128-thread block per (head, window group) walks the windows
// g, g + groups, ... of its group, so the dbias sum over windows stays in
// registers (thread (j, half) owns column j, rows half, half + 2, ...) and
// each block writes one (N, N) partial; the caller sums the partials (no
// atomics, so the gradient is the same from run to run).  Per window: q, k
// and do staged in shared memory as f32 padded to 32 (+1 column against bank
// conflicts), the thread's v row in registers, the 64x64 probability tile in
// shared memory -- loaded from the save, or recomputed with the same
// max-subtracted f32 softmax as window_attn_fwd (so p is bit-identical to
// the forward's) -- the rowsum(dp p) reduced with warp shuffles, and ds
// written over p once dv has read it.  Strides are arguments: the trunk
// reads q/k/v/do straight from its qkv and proj buffers and writes dq/dk/dv
// into the (B_, N, 3, nh, hd) buffer the qkv weight-grad and data-grad GEMMs
// read.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ bias,
                       const float* __restrict__ mask, const T* __restrict__ p_saved,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
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
    const T* qb = q + w * sq.w + h * sq.h;
    const T* kb = k + w * sk.w + h * sk.h;
    const T* vb = v + w * sv.w + h * sv.h;
    const T* db = dout + w * sdo.w + h * sdo.h;
    __syncthreads();  // the previous window is done with shared memory
    for (int idx = tid; idx < AN * AD; idx += kThreads) {
      const int n = idx / AD;
      const int d = idx - n * AD;
      const bool ok = n < N && d < hd;
      qs[n][d] = ok ? to_f(qb[n * sq.n + d]) : 0.f;
      ks[n][d] = ok ? to_f(kb[n * sk.n + d]) : 0.f;
      dos[n][d] = ok ? to_f(db[n * sdo.n + d]) : 0.f;
    }
    float vr[AD];
#pragma unroll
    for (int d = 0; d < AD; ++d) vr[d] = (j < N && d < hd) ? to_f(vb[j * sv.n + d]) : 0.f;

    if (p_saved) {
      // the forward's probabilities, a row per warp
      const T* pw = p_saved + ((w * nh + h) * N) * N;
      for (int i = warp; i < N; i += kThreads / 32) {
        if (lane < N) ps[i][lane] = to_f(pw[i * N + lane]);
        if (lane + 32 < N) ps[i][lane + 32] = to_f(pw[i * N + lane + 32]);
      }
      __syncthreads();
    } else {
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
    }

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

    // dv_j = sum_i p_T,ij do_i, this thread's half of the head dim
    if (j < N) {
      float acc[AD / 2];
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = 0.f;
      for (int i = 0; i < N; ++i) {
        const float p = round_as<T>(ps[i][j]);
#pragma unroll
        for (int dd = 0; dd < AD / 2; ++dd) acc[dd] = fmaf(p, dos[i][d0 + dd], acc[dd]);
      }
      T* out = dv + w * sdv.w + h * sdv.h + j * sdv.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = from_f<T>(acc[dd]);
    }
    __syncthreads();  // rowdot complete; every read of p done

    // ds = p (dp - rowsum), over p in shared memory; dbias accumulates the
    // f32 ds, dq and dk read it rounded to T
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = half + 2 * r;
      if (i < N && j < N) {
        const float ds = ps[i][j] * (dp[r] - (rowdot[0][i] + rowdot[1][i]));
        ps[i][j] = round_as<T>(ds);
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
      T* out = dk + w * sdk.w + h * sdk.h + j * sdk.n;
#pragma unroll
      for (int dd = 0; dd < AD / 2; ++dd)
        if (d0 + dd < hd) out[d0 + dd] = from_f<T>(acc[dd] * scale);
    }
    // dq_i = scale sum_j ds_ij k_j, a warp per row, a lane per head-dim entry
    if (lane < hd) {
      T* out = dq + w * sdq.w + h * sdq.h;
      for (int i = warp; i < N; i += kThreads / 32) {
        float acc = 0.f;
        for (int jj = 0; jj < N; ++jj) acc = fmaf(ps[i][jj], ks[jj][lane], acc);
        out[i * sdq.n + lane] = from_f<T>(acc * scale);
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
    int device, int is_bf16, const void* q, const void* k, const void* v,
    const float* bias, const float* mask, const void* p_saved, const void* dout,
    void* dq, void* dk, void* dv, float* dbias_part, long long n_windows, int nh,
    int N, int hd, int nW, int groups, long long sq_w, long long sq_h,
    long long sq_n, long long sk_w, long long sk_h, long long sk_n,
    long long sv_w, long long sv_h, long long sv_n, long long sdo_w,
    long long sdo_h, long long sdo_n, long long sdq_w, long long sdq_h,
    long long sdq_n, long long sdk_w, long long sdk_h, long long sdk_n,
    long long sdv_w, long long sdv_h, long long sdv_n, float scale,
    void* stream) {
  if (N <= 0 || N > AN || hd <= 0 || hd > AD || nh <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  if (p_saved == nullptr && bias == nullptr) return (int)cudaErrorInvalidValue;
  if (p_saved == nullptr && mask != nullptr && nW <= 0) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || groups > 65535) return (int)cudaErrorInvalidValue;
  if (n_windows < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SEI_DISPATCH_T(is_bf16,
      window_attn_bwd_kernel<T><<<dim3(nh, groups), kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          bias, mask, static_cast<const T*>(p_saved), static_cast<const T*>(dout),
          static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), dbias_part,
          n_windows, nh, N, hd, nW, groups, Strides{sq_w, sq_h, sq_n},
          Strides{sk_w, sk_h, sk_n}, Strides{sv_w, sv_h, sv_n},
          Strides{sdo_w, sdo_h, sdo_n}, Strides{sdq_w, sdq_h, sdq_n},
          Strides{sdk_w, sdk_h, sdk_n}, Strides{sdv_w, sdv_h, sdv_n}, scale));
  return (int)cudaGetLastError();
}
