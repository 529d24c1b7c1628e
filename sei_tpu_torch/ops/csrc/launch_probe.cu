// Launch-overhead probes: a copy kernel and a trunk skeleton without compute.
// Storage type T (float or bf16), f32 arithmetic, one rounding per stored value.
//
// sei_copy_probe replaces the TPU copy-kernel probes
// (experiments/perf_probe_r3p.py:48 one_copy -> copy_kernel :44, call :50;
// perf_probe_r3q.py:50 one_copy -> copy_kernel :46, call :52;
// perf_probe_r3m.py:98 mk_copy -> copy_kernel :95, call :104): y = x + 1
// (r3m: y = x) over the (8, 48, 48, 180) activation.  Bound by bytes: one
// read and one write of x (13.3 MB in bf16, 26.5 MB in f32 at the probe
// shape: 3.96 / 7.92 us at 3.35 TB/s; x fits the 50 MB L2, so calls repeated
// on one x read it from there and can beat that).  Design: a grid-stride
// loop over the flat tensor with the number of blocks a parameter (1 ...
// 1056), so one launch can run on one SM or on all 132; the TPU's
// sequential grid steps have no counterpart here, the probe asks instead
// what a launch costs against what a block costs.  Each access moves 16
// bytes (8 bf16 or 4 f32 values): the elements before x's first 16-byte
// boundary (the head) and those after its last whole pack (the tail) go one
// at a time on the first threads of the grid, the packs between them by the
// grid-stride loop, each thread loading kUnroll packs (a stride apart, so a
// warp's accesses stay contiguous) before it stores them; 4 beat 1, 2 and 8
// at 1 and 1056 blocks (tools_torch/copy_probe_times.py --unroll).  y must
// lie at x's offset from a 16-byte boundary (the wrapper allocates it so),
// so one head aligns both.

// sei_trunk_skeleton replaces the trunk skeletons
// (experiments/perf_probe_r3r.py:98 mk_a -> kern :120, call :158;
// perf_probe_r3s.py:104 mk -> kern :105, call :136): the TPU trunk kernel's
// whole argument list (x, the 12 per-block weight tensors, rpb, mask, dpm)
// with no compute on the weights.  Variants by flag: the body-less
// y = x + 1 (v_a; v_e is the same with x alone), the xs/xs2 outputs (D, B,
// H, W, C) written as zeros (v_b), and the staged residual body (v_d): per
// block j, xs[j] = x, x2 = rnd(x + 0.5 a), xs2[j] = x2, x = rnd(x2 + 0.25 m),
// y = x after D blocks, with a = m = 1, or (v_g) each image's drop-path
// factors dpm[j, 0, b] and dpm[j, 1, b].  The weights are kernel arguments
// but are never read, as the skeleton's never enter its body.  Bound by
// bytes: x read once, y and (with outputs) 2 D copies of x written (v_d in
// bf16: 93 MB, ~28 us).  Design: one thread per element in a grid-stride
// loop, the D blocks of one element carried in a register, so each stored
// value is written once with unit stride across the warp.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// packs a thread loads before it stores any (-DSEI_COPY_PROBE_UNROLL=... builds
// another: tools_torch/copy_probe_times.py --unroll)
#ifndef SEI_COPY_PROBE_UNROLL
#define SEI_COPY_PROBE_UNROLL 4
#endif
constexpr int kUnroll = SEI_COPY_PROBE_UNROLL;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_probe_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, int head,
                  float add) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per 16-byte access
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long packs = (n - head) / V;
  const long long tail0 = head + packs * V;  // the first element after the last whole pack
  if (tid < head) y[tid] = from_f<T>(to_f(x[tid]) + add);
  if (tid < n - tail0) y[tail0 + tid] = from_f<T>(to_f(x[tail0 + tid]) + add);
  const T* xv = x + head;
  T* yv = y + head;
  auto one = [&](Pack<T, V>& v) {
#pragma unroll
    for (int j = 0; j < V; ++j) v.v[j] = from_f<T>(to_f(v.v[j]) + add);
  };
  // kUnroll packs, stride apart, in flight per thread; then one at a time
  long long p = tid;
  for (; p + (kUnroll - 1) * stride < packs; p += kUnroll * stride) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_pack<T, V>(xv + (p + u * stride) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      one(v[u]);
      store_pack(yv + (p + u * stride) * V, v[u]);
    }
  }
  for (; p < packs; p += stride) {
    Pack<T, V> v = load_pack<T, V>(xv + p * V);
    one(v);
    store_pack(yv + p * V, v);
  }
}

// The arguments the TPU trunk kernel takes besides x: the 12 weight tensors,
// rpb and mask (never read here), and dpm (read by v_g).
struct TrunkArgs {
  const void* weights[12];
  const void* rpb;
  const void* mask;
  const float* dpm;  // (D, 2, B)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
trunk_skeleton_kernel(const T* __restrict__ x, TrunkArgs args, T* __restrict__ y,
                      T* __restrict__ xs, T* __restrict__ xs2, long long n,
                      long long per_image, int depth, int batch, int body,
                      int dpm_reads) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    float v = to_f(x[i]);
    if (!body) {
      y[i] = from_f<T>(v + 1.f);
      if (xs != nullptr) {
        for (int j = 0; j < depth; ++j) {
          xs[j * n + i] = from_f<T>(0.f);
          xs2[j * n + i] = from_f<T>(0.f);
        }
      }
      continue;
    }
    const int b = (int)(i / per_image);
    for (int j = 0; j < depth; ++j) {
      float a = 1.f, m = 1.f;
      if (dpm_reads) {
        a = args.dpm[(j * 2 + 0) * batch + b];
        m = args.dpm[(j * 2 + 1) * batch + b];
      }
      if (xs != nullptr) xs[j * n + i] = from_f<T>(v);
      const float x2 = round_as<T>(v + 0.5f * a);
      if (xs2 != nullptr) xs2[j * n + i] = from_f<T>(x2);
      v = round_as<T>(x2 + 0.25f * m);
    }
    y[i] = from_f<T>(v);
  }
}

}  // namespace

extern "C" int sei_copy_probe(int device, int is_bf16, const void* x, void* y,
                              long long n, int blocks, int add, void* stream) {
  if (n < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const size_t size = is_bf16 ? sizeof(bf16) : sizeof(float);
  const size_t mis = (size_t)x % 16;  // x's offset from a 16-byte boundary, in bytes
  if ((size_t)x % size || (size_t)y % 16 != mis) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long head = mis ? (long long)((16 - mis) / size) : 0;
  SEI_DISPATCH_T(is_bf16,
      SEI_LAUNCH(blocks, kThreads, (cudaStream_t)stream, copy_probe_kernel<T>)(
          static_cast<const T*>(x), static_cast<T*>(y), n, (int)(head < n ? head : n),
          add ? 1.f : 0.f));
  return (int)cudaGetLastError();
}

extern "C" int sei_trunk_skeleton(int device, int is_bf16, const void* x,
                                  const void* ln1_s, const void* ln1_b, const void* qkv_w,
                                  const void* qkv_b, const void* proj_w, const void* proj_b,
                                  const void* ln2_s, const void* ln2_b, const void* fc1_w,
                                  const void* fc1_b, const void* fc2_w, const void* fc2_b,
                                  const void* rpb,
                                  const void* mask, const float* dpm, void* y,
                                  void* xs, void* xs2, long long n, long long per_image,
                                  int depth, int batch, int body, int dpm_reads,
                                  void* stream) {
  if (n < 0 || per_image <= 0 || depth < 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  if ((xs == nullptr) != (xs2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (dpm_reads && (dpm == nullptr || !body)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const TrunkArgs args{{ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b, fc1_w,
                        fc1_b, fc2_w, fc2_b},
                       rpb, mask, dpm};
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 0x7fffffffLL ? want : 0x7fffffffLL);
  SEI_DISPATCH_T(is_bf16,
      SEI_LAUNCH(blocks, kThreads, (cudaStream_t)stream, trunk_skeleton_kernel<T>)(
          static_cast<const T*>(x), args, static_cast<T*>(y), static_cast<T*>(xs),
          static_cast<T*>(xs2), n, per_image, depth, batch, body, dpm_reads));
  return (int)cudaGetLastError();
}
