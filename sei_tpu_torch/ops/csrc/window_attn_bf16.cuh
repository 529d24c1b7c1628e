// The bf16 window-attention kernels' shared pieces (window_attn_fwd.cu's
// window_attn_fwd_mma_kernel and window_attn_bwd.cu's
// window_attn_bwd_mma_kernel), on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators): the staged window's layout and its copies,
// the two products from staged tiles (rows_by_rows, cols_by_rows), the
// scores' scale, bias, mask and max-subtracted f32 softmax in the
// accumulators' layout (softmax_acc), and the bf16 pair stores.  The
// forward's p and the backward's recompute of it come from the same
// rows_by_rows and softmax_acc, so the p the forward rounds for P.V and
// saves (p_out) equals, bit for bit, the p the backward rounds for dV.
//
// A warp owns 16 rows r0..r0+15 of a 64-row window.  Its accumulators hold
// an n8 tile per index nt: lane l has rows r0 + l/4 (e = 0, 1) and r0 + l/4
// + 8 (e = 2, 3), columns 8 nt + 2 (l % 4) + e % 2.
#pragma once

#include "window_attn_f32.cuh"  // AN, AD (and common.cuh)

namespace {

struct Strides {
  long long w, h, n;  // window, head, token; the head-dim stride is 1
};

constexpr int XP = AD + 8;  // pitch of a staged q, k, v or do (bf16)
constexpr int TP = AN + 8;  // pitch of a P or dS tile (bf16)
constexpr int XT = AN * XP;  // elements of one staged q, k, v or do
constexpr int TT = AN * TP;  // elements of one P or dS tile

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// the rows of window w, head h of one tensor into a staged [AN][XP] tile;
// rows >= N and head-dim entries >= hd zero (the tensor cores sum over the
// pad, and 0 x NaN is NaN).  VEC = 2: bf16 pairs by 4-byte cp.async (a
// head starts at a 60-byte step in the trunk's qkv buffer: only 4-byte
// copies always fit); VEC = 1: one element at a time through registers.
// lt = the thread's index in its team of 128.
template <int VEC>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, const Strides& s,
                                           long long w, int h, int N, int hd, int lt) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  const bf16* base = src + w * s.w + h * s.h;
  constexpr int PR = AD / VEC;  // copies per row
  for (int idx = lt; idx < AN * PR; idx += 128) {
    const int n = idx / PR;
    const int d = (idx - n * PR) * VEC;
    const bool ok = n < N && d < hd;
    if constexpr (VEC == 2)
      cp_async<4>(dst + n * XP + d, ok ? base + n * s.n + d : src, ok);
    else
      dst[n * XP + d] = ok ? base[n * s.n + d] : zero;
  }
}

// acc (16 rows x 64 columns: 8 n8 tiles) = A B^T over 32 head-dim entries:
// A's rows r0.. and all 64 rows of B from staged [AN][XP] tiles (plain
// ldmatrix: the head dim is contiguous in both)
__device__ __forceinline__ void rows_by_rows(const bf16* A, const bf16* B, int r0, int lane,
                                             float (&acc)[8][4]) {
  unsigned a[2][4];
  const bf16* arow = A + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP + (lane >> 4) * 8;
  ldmatrix_x4(a[0], arow);
  ldmatrix_x4(a[1], arow + 16);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned b[4];
    ldmatrix_x4(b, B + (8 * nt + (lane & 7)) * XP + (lane >> 3) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    mma_bf16_16816(acc[nt], a[0], b[0], b[1]);
    mma_bf16_16816(acc[nt], a[1], b[2], b[3]);
  }
}

// acc (16 rows x 32 head-dim entries) += T^T X over the 64 rows of a [AN][TP]
// tile T (its columns r0.. are acc's rows) and a staged [AN][XP] X, every
// fragment by ldmatrix.trans
__device__ __forceinline__ void cols_by_rows(const bf16* T, const bf16* X, int r0, int lane,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < AN / 16; ++kk) {
    unsigned a[4];
    ldmatrix_x4_trans(a, T + (16 * kk + (lane & 7) + (lane >> 4) * 8) * TP + r0 +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned b[4];
      ldmatrix_x4_trans(b, X + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XP + 16 * np +
                               (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x 32 head-dim entries) += A X over 64 rows of a staged
// [AN][XP] X, A given as the four k16 fragments a[kk] (two adjacent n8
// accumulator tiles each, packed by the caller); X by ldmatrix.trans
__device__ __forceinline__ void frags_by_rows(const unsigned (&a)[4], const bf16* X, int kk,
                                              int lane, float (&acc)[4][4]) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    unsigned b[4];
    ldmatrix_x4_trans(b, X + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XP + 16 * np +
                             (lane >> 4) * 8);
    mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
    mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// v = src[i][j] of an (N, N) f32 matrix at the lane's accumulator positions
// (rows r0 + l/4 (+ 8), columns 8 nt + 2 (l % 4) (+ 1)), `fill` where i or
// j >= N; each pair of columns as one 8-byte load where N and the pointer
// allow it
__device__ __forceinline__ void load_at_acc(const float* src, int N, int r0, int lane, float fill,
                                            float (&v)[8][4]) {
  const bool pairs = N % 2 == 0 && (size_t)src % 8 == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = r0 + (lane >> 2) + 8 * hf, j = 8 * nt + 2 * (lane & 3);
      if (pairs) {  // N even: a pair is all in or all out
        const float2 x = i < N && j < N ? *reinterpret_cast<const float2*>(src + i * N + j)
                                        : make_float2(fill, fill);
        v[nt][2 * hf] = x.x;
        v[nt][2 * hf + 1] = x.y;
      } else {
        v[nt][2 * hf] = i < N && j < N ? src[i * N + j] : fill;
        v[nt][2 * hf + 1] = i < N && j + 1 < N ? src[i * N + j + 1] : fill;
      }
    }
}

// ex / sum rounded to f32 (0 for ex = 0), for 0 <= ex <= 1 <= sum <= 64.  A
// masked score's exp (~e^-100) is a subnormal f32, and the f32 division
// sends a subnormal numerator to a slow subroutine, lane by lane.  Below
// 2^-96 the quotient is taken in f64 instead (div_rn_f64)
// and rounded once to f32, which is the f32 quotient bit for bit (53 >= 2
// x 24 + 2 bits: the double rounding is innocuous); the f32 division, which
// may run for every lane, is given 1 there.
__device__ __forceinline__ float div_rn(float ex, float sum) {
  const bool tiny = ex < 0x1p-96f;
  const float q = (tiny ? 1.f : ex) / sum;
  if (ex == 0.f) return 0.f;
  return tiny ? (float)div_rn_f64(ex, sum) : q;
}

// the scores s (rows_by_rows of q and k) into f32 probabilities in place:
// x = s scale + b (+ m when masked), then the max-subtracted softmax of each
// row over the quad that holds it.  b is bias[h] at the lane's positions,
// -inf outside the window, m mask[w % nW] (0 outside): rows and columns >=
// N come out as 0, never NaN.
__device__ __forceinline__ void softmax_acc(float (&p)[8][4], const float (&b)[8][4],
                                            const float (&m)[8][4], bool masked, float scale) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
        float x = p[nt][e] * scale + b[nt][e];
        if (masked) x += m[nt][e];
        p[nt][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
        const float x = p[nt][e];
        const float ex = x == -INFINITY ? 0.f : expf(x - mx);
        p[nt][e] = ex;
        sum += ex;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) p[nt][e] = div_rn(p[nt][e], sum);
  }
}

// rows r0 + l/4 (+ 8) and columns 2 (l % 4) (+ 1) of the four n8 tiles of
// acc, times mul, rounded to bf16 into out[w][h][row][d]; rows >= N and
// columns >= hd skipped
template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* out, const Strides& so, long long w, int h,
                                           int r0, int lane, const float (&acc)[4][4],
                                           float mul, int N, int hd) {
  bf16* base = out + w * so.w + h * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = r0 + (lane >> 2) + 8 * half;
    if (i >= N) continue;
    bf16* row = base + i * so.n;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = 8 * nt + 2 * (lane & 3);
      if (d >= hd) continue;
      const float x = acc[nt][2 * half] * mul, y = acc[nt][2 * half + 1] * mul;
      if constexpr (VEC == 2) {  // hd even: a pair is all in or all out
        *reinterpret_cast<unsigned*>(row + d) = pack_bf16(x, y);
      } else {
        row[d] = __float2bfloat16_rn(x);
        if (d + 1 < hd) row[d + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// one tensor's strides allow bf16 pairs
inline bool even(const Strides& s) { return s.w % 2 == 0 && s.h % 2 == 0 && s.n % 2 == 0; }

}  // namespace
