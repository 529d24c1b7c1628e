// Shared device helpers for the Swin trunk kernels (sm_90a, f32).
#pragma once

#include <cuda_runtime.h>

// Row order of a (rows, C) token matrix against the (B, H, W, C) image it
// came from.  windowed == 0: row r is pixel r.  windowed == 1: row r is token
// r of the cyclically shifted image cut into ws x ws windows, windows
// h-major per image, tokens row-major per window -- the order of
// jnp.roll(x, (-shift, -shift), (1, 2)) followed by window partition in
// sei_tpu/ops/swin_trunk.py (_window_tokens).  The same map serves the
// inverse (window reverse, then roll by +shift) on the store side.
struct WinMap {
  int windowed;
  int H, W, ws, shift;
};

__device__ __forceinline__ long long row_to_pixel(long long r, const WinMap& m) {
  if (!m.windowed) return r;
  const int n_tok = m.ws * m.ws;
  const int nww = m.W / m.ws;
  const int nwi = (m.H / m.ws) * nww;
  const long long win = r / n_tok;
  const int t = (int)(r - win * n_tok);
  const long long b = win / nwi;
  const int wi = (int)(win - b * nwi);
  const int wh = wi / nww;
  const int wc = wi - wh * nww;
  const int i = t / m.ws;
  const int j = t - i * m.ws;
  int y = wh * m.ws + i + m.shift;
  if (y >= m.H) y -= m.H;
  int x = wc * m.ws + j + m.shift;
  if (x >= m.W) x -= m.W;
  return (b * m.H + y) * m.W + x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
