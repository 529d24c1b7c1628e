// Shared device helpers for the Swin trunk kernels (sm_90a).
//
// Storage types: every kernel is a template on the storage type T of its
// activations, weights and saves (float, or __nv_bfloat16 for the bf16
// training recipe); arithmetic is f32 throughout, and a value is rounded to
// T exactly where the JAX trunk casts to its compute dtype (round_as<T>).
// Buffers that are f32 in one call and T in another get a template
// parameter of their own (dy, gp and out of the backward GEMMs, dz/dres/dx
// of the LN backward, gelu'(h) of the forward GEMM's epilogue).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T (round to nearest even, as astype / .to(bfloat16))
template <typename T>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<T>(v)); }

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

// (gelu(x), gelu'(x)) in two forms, picked by SEI_FAST_GELU independently
// of the storage type (sei_tpu/ops/swin_trunk.py _use_fast_gelu :233-238;
// unset: the polynomial in bf16, the exact form in f32).  GELU_EXACT: x
// Phi(x) with erff.  GELU_FAST: the JAX trunk's polynomial pair
// (_gelu_pair_fast, :188-230): Chebyshev-fitted odd polynomials on [-4, 4]
// for Phi and x*pdf, saturated outside, evaluated by Horner in f32 with the
// same coefficients.
enum { GELU_EXACT = 0, GELU_FAST = 1 };

__device__ __forceinline__ void gelu_pair_exact(float x, float& g, float& gp) {
  const float phi = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  g = x * phi;
  gp = phi + x * expf(-0.5f * x * x) * 0.39894228040143268f;
}

__device__ __forceinline__ void gelu_pair_fast(float x, float& g, float& gp) {
  const float xc = fminf(fmaxf(x, -4.f), 4.f);
  const float u = xc * xc;
  float a = -3.969025307598051e-12f;  // _C_PHI, highest order first
  a = a * u + 3.7875219898373147e-10f;
  a = a * u + -1.6419572555948384e-08f;
  a = a * u + 4.340088563312956e-07f;
  a = a * u + -7.956239157270749e-06f;
  a = a * u + 0.00010915483414148812f;
  a = a * u + -0.0011709367759583488f;
  a = a * u + 0.009949619744973907f;
  a = a * u + -0.06647417597398475f;
  a = a * u + 0.3989390292359633f;
  float b = -5.154521748137964e-11f;  // _C_XPDF
  b = b * u + 4.764393641533242e-09f;
  b = b * u + -1.9705490399271182e-07f;
  b = b * u + 4.854256860196168e-06f;
  b = b * u + -8.006941709520028e-05f;
  b = b * u + 0.0009400990867306437f;
  b = b * u + -0.008056541327475311f;
  b = b * u + 0.04949916878279405f;
  b = b * u + -0.19922337402921744f;
  b = b * u + 0.3988928463183661f;
  const bool inr = fabsf(x) <= 4.f;
  const float phi = inr ? 0.5f + xc * a : (x > 0.f ? 1.f : 0.f);
  g = x * phi;
  gp = phi + (inr ? xc * b : 0.f);
}

template <int GF>
__device__ __forceinline__ void gelu_pair(float x, float& g, float& gp) {
  static_assert(GF == GELU_EXACT || GF == GELU_FAST, "GELU form");
  if constexpr (GF == GELU_FAST)
    gelu_pair_fast(x, g, gp);
  else
    gelu_pair_exact(x, g, gp);
}

// VEC consecutive elements of T, loaded or stored as one access of VEC *
// sizeof(T) bytes (aligned to that; 32 bytes go as two 16-byte accesses)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC > 16 ? 16 : sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int BYTES> struct RawOf;
template <> struct RawOf<2> { typedef unsigned short type; };
template <> struct RawOf<4> { typedef unsigned type; };
template <> struct RawOf<8> { typedef uint2 type; };
template <> struct RawOf<16> { typedef uint4 type; };
template <> struct RawOf<32> { struct type { uint4 lo, hi; }; };

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  typedef typename RawOf<sizeof(T) * VEC>::type R;
  Pack<T, VEC> out;
  *reinterpret_cast<R*>(&out) = *reinterpret_cast<const R*>(p);
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  typedef typename RawOf<sizeof(T) * VEC>::type R;
  *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(&v);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) out.v[j] = from_f<T>(0.f);
  return out;
}

// The inline-PTX helpers and SEI_LAUNCH below exist only where nvcc
// compiles the source.  Without __CUDACC__ (a kernel's index logic compiled
// for the CPU by a host compiler, tests/test_torch_gemm_f32_emulated.py) a
// stub cuda_runtime.h on the include path supplies host versions of them.
#ifdef __CUDACC__

// cp.async (sm_80 and up): BYTES (4, 8 or 16, aligned to that) from global
// to shared memory without passing through registers; with valid == false
// nothing is read and the destination is zero-filled (src-size 0).  Copies
// are grouped by cp_async_commit; cp_async_wait<n> returns once at most n of
// this thread's groups are still in flight.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :
               : "r"(addr), "l"(gmem), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// Tensor-core building blocks (bf16 in, f32 accumulate; sm_80 and up).
// ldmatrix_x4: four 8x8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and
// receives in r[q] the elements (l / 4, 2 (l % 4) + j), j = 0, 1 (low half
// first), of matrix q.  So a tile stored with the reduction axis contiguous
// in each row comes out as mma's row-major A fragment.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ldmatrix_x4_trans: the same, transposed on the way: lane l receives the
// elements (2 (l % 4) + j, l / 4) of matrix q.  So a tile stored with the
// reduction axis as its row comes out as mma's row-major A fragment or
// col-major B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16x8, f32) += a (16x16 bf16, row-major fragment) b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a / b in f64, rounded to nearest (PTX div.rn.f64); the optimizer folds a
// C++ division of two widened floats, and __ddiv_rn of them, back into the
// f32 division, whose slow path this is for
__device__ __forceinline__ double div_rn_f64(double a, double b) {
  double q;
  asm volatile("div.rn.f64 %0, %1, %2;\n" : "=d"(q) : "d"(a), "d"(b));
  return q;
}

// kernel<<<grid, block, 0, stream>>>(...), written SEI_LAUNCH(grid, block,
// stream, kernel)(...); with `smem` bytes of dynamic shared memory,
// SEI_LAUNCH_SMEM(grid, block, smem, stream, kernel)(...), which the kernel
// names by SEI_DYNAMIC_SMEM(type, name)
#define SEI_LAUNCH(grid, block, stream, ...) __VA_ARGS__<<<grid, block, 0, stream>>>
#define SEI_LAUNCH_SMEM(grid, block, smem, stream, ...) __VA_ARGS__<<<grid, block, smem, stream>>>
#define SEI_DYNAMIC_SMEM(type, name) extern __shared__ __align__(16) type name[]

#endif  // __CUDACC__

// host side: an entry point's storage-type switch
#define SEI_DISPATCH_T(is_bf16, ...) \
  do {                               \
    if (is_bf16) {                   \
      typedef bf16 T;                \
      __VA_ARGS__;                   \
    } else {                         \
      typedef float T;               \
      __VA_ARGS__;                   \
    }                                \
  } while (0)
