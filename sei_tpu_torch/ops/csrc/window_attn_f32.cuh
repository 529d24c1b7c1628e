// The f32 window-attention kernels' shared pieces (window_attn_fwd.cu's
// window_attn_fwd_f32_kernel and window_attn_bwd.cu's
// window_attn_bwd_f32_kernel): the staged window's layout, the scores and
// the max-subtracted softmax in 4-column register micro-tiles, and the
// 64 x 32 products from a shared P tile.  Both kernels take their p from
// window_scores and window_softmax, and their att = P v from tile_product,
// so the forward's p and att equal the backward's recomputed ones bit for
// bit.
#pragma once

#include <cmath>

#include "common.cuh"

namespace {

constexpr int AN = 64;       // max tokens per window (ws <= 8)
constexpr int AD = 32;       // max head dim (padded)
constexpr int SP = AD + 4;   // row pitch of a staged q, k, v or do
constexpr int PP = AN + 4;   // row pitch of a P / dS tile

// x, opaque to the optimizer: the window and head offsets (w * stride, h *
// stride) of eight tensors, hoisted out of the window loop or carried
// through it, would hold sixteen registers; recomputed where used, they
// cost two multiplies each
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// p[r][c] = sum over d = 0..31, ascending, of q[i][d] k[j][d] for the
// thread's rows i = ty + FTY r and columns j = tx + 16 c, from the staged q
// and k ([AN][SP], rows >= N and entries >= hd zero)
template <int FTY, int FRA>
__device__ __forceinline__ void window_scores(const float* qs, const float* ks, int ty, int tx,
                                              float (&p)[FRA][4]) {
#pragma unroll
  for (int r = 0; r < FRA; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
#pragma unroll 1  // 64 independent FMAs a step; unrolled, hoisted loads spill
  for (int d = 0; d < AD; d += 4) {
    float4 a[FRA], b[4];
#pragma unroll
    for (int r = 0; r < FRA; ++r)
      a[r] = *reinterpret_cast<const float4*>(qs + (ty + FTY * r) * SP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * SP + d);
#pragma unroll
    for (int r = 0; r < FRA; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = p[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        p[r][c] = fmaf(a[r].w, b[c].w, s);
      }
  }
}

// p = softmax over each row of p * scale + bm, max-subtracted, in f32; bm
// is bias[h] + mask[w % nW] added as one value, -inf outside the window
// (those entries come out 0).  A row's 64 columns sit on 16 lanes of one
// warp (columns tx + 16 c), so the row max and sum are __shfl_xor_sync
// butterflies over those lanes.
template <int FRA>
__device__ __forceinline__ void window_softmax(float (&p)[FRA][4], const float (&bm)[FRA][4],
                                               float scale) {
#pragma unroll
  for (int r = 0; r < FRA; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[r][c] = p[r][c] * scale + bm[r][c];
      m = fmaxf(m, p[r][c]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = p[r][c] == -INFINITY ? 0.f : expf(p[r][c] - m);
    // the bf16 forward kernel's lane l holds columns l and l + 32, and its first
    // butterfly step adds lanes l and l + 16
    float sum = (e[0] + e[2]) + (e[1] + e[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = e[c] == 0.f ? 0.f : e[c] / sum;
  }
}

// the output tile of a 64 x 32 product over P threads: RC rows x CC columns
// each, CX column groups (a warp is 32 / CX row groups by CX)
template <int P>
struct ProdTile {
  static constexpr int CC = P <= 128 ? 4 : 2;
  static constexpr int RC = AN * AD / (P * CC);
  static constexpr int CX = AD / CC;
};

// acc[r][c] = sum over k = 0..63, ascending, of At[k][r0 + r] * B[k][c0 + c]:
// At is a P / dS tile read as [k][row], B a staged tile [k][d]
template <int P>
__device__ __forceinline__ void tile_product(const float* At, const float* Bm, int local,
                                             float (&acc)[ProdTile<P>::RC][ProdTile<P>::CC]) {
  typedef ProdTile<P> TL;
  const float* a_col = At + (local / TL::CX) * TL::RC;
  const float* b_col = Bm + (local % TL::CX) * TL::CC;
#pragma unroll
  for (int r = 0; r < TL::RC; ++r)
#pragma unroll
    for (int c = 0; c < TL::CC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < AN; ++k) {
    float a[TL::RC], b[TL::CC];
#pragma unroll
    for (int r = 0; r < TL::RC; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(a_col + k * PP + r);
      a[r] = t.x;
      a[r + 1] = t.y;
      a[r + 2] = t.z;
      a[r + 3] = t.w;
    }
    if constexpr (TL::CC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(b_col + k * SP);
      b[0] = t.x;
      b[1] = t.y;
      b[2] = t.z;
      b[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(b_col + k * SP);
      b[0] = t.x;
      b[1] = t.y;
    }
#pragma unroll
    for (int r = 0; r < TL::RC; ++r)
#pragma unroll
      for (int c = 0; c < TL::CC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

}  // namespace
