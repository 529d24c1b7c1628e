// Host-side PNG decode and shorter-side resize for the port's datasets
// (counterpart of csrc/sei_loader.cc in the JAX package).
//
// Python inflates each file's IDAT stream with the standard library's zlib
// (which releases the GIL) and calls these functions through ctypes (which
// releases it too), so a pool of Python threads decodes and resizes images
// in parallel with no imaging library:
//
//   sei_png_unfilter: the five PNG row filters undone, row by row, and the
//     8-bit samples turned into float32 CHW in [0, 1] with the JAX package's
//     channel policy (grey replicated to 3 channels, RGBA's alpha dropped;
//     grey + alpha refused, as the numpy reader refuses it).  Each value is
//     float(sample) / 255.0f, one correctly rounded division, the numpy
//     path's `arr.astype(np.float32) / 255.0` bit for bit.
//   sei_resize_taps: a separable resize by taps, along W and then along H,
//     with the weights handed in (the rows of ops/bicubic.resize_matrix, f32),
//     each output a sum over its contiguous taps in double, rounded to float
//     after each pass; numpy's two f32 matrix products compute the same sums
//     in another order.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (sei_tpu_torch/data/native.py, at
// first use).

#include <cstdint>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// raw: h rows of 1 + w * spp bytes, each led by its filter type (the
// inflated IDAT stream); out: (3, h, w) float32.  Returns 0, or 1 for an
// unknown filter type, 2 for a sample count other than 1, 3 or 4.
int sei_png_unfilter(const uint8_t* raw, int h, int w, int spp, float* out) {
  if (spp != 1 && spp != 3 && spp != 4) return 2;
  const int64_t stride = 1 + static_cast<int64_t>(w) * spp;
  const int64_t row_bytes = static_cast<int64_t>(w) * spp;
  const int64_t plane = static_cast<int64_t>(h) * w;
  std::vector<uint8_t> prev(row_bytes, 0), cur(row_bytes, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * stride;
    const int kind = in[0];
    const uint8_t* f = in + 1;
    for (int64_t i = 0; i < row_bytes; ++i) {
      const int a = i >= spp ? cur[i - spp] : 0;  // left
      const int b = prev[i];                      // up
      const int c = i >= spp ? prev[i - spp] : 0;  // up-left
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return 1;
      }
      cur[i] = static_cast<uint8_t>((f[i] + pred) & 0xFF);
    }
    float* row = out + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = &cur[static_cast<int64_t>(x) * spp];
      for (int ch = 0; ch < 3; ++ch)
        row[ch * plane + x] = static_cast<float>(px[spp == 1 ? 0 : ch]) / 255.0f;
    }
    prev.swap(cur);
  }
  return 0;
}

// src (c, in_h, in_w) -> dst (c, out_h, out_w); output index i of an axis
// reads taps first[i] .. first[i] + count[i] - 1 with weights
// weights[i * max_taps + k]; tmp holds (c, in_h, out_w) floats.
void sei_resize_taps(const float* src, int c, int in_h, int in_w, float* dst, int out_h,
                     int out_w, const int* h_first, const int* h_count, const float* h_weights,
                     int h_max, const int* w_first, const int* w_count,
                     const float* w_weights, int w_max, float* tmp) {
  for (int64_t r = 0; r < static_cast<int64_t>(c) * in_h; ++r) {  // along W
    const float* row = src + r * in_w;
    float* o = tmp + r * out_w;
    for (int x = 0; x < out_w; ++x) {
      const float* wt = w_weights + static_cast<int64_t>(x) * w_max;
      const float* s = row + w_first[x];
      double acc = 0.0;
      for (int k = 0; k < w_count[x]; ++k) acc += static_cast<double>(wt[k]) * s[k];
      o[x] = static_cast<float>(acc);
    }
  }
  std::vector<double> acc(out_w);
  for (int ch = 0; ch < c; ++ch) {  // along H
    const float* t = tmp + static_cast<int64_t>(ch) * in_h * out_w;
    for (int y = 0; y < out_h; ++y) {
      const float* wt = h_weights + static_cast<int64_t>(y) * h_max;
      for (int x = 0; x < out_w; ++x) acc[x] = 0.0;
      for (int k = 0; k < h_count[y]; ++k) {
        const float* s = t + static_cast<int64_t>(h_first[y] + k) * out_w;
        const double wk = wt[k];
        for (int x = 0; x < out_w; ++x) acc[x] += wk * s[x];
      }
      float* o = dst + (static_cast<int64_t>(ch) * out_h + y) * out_w;
      for (int x = 0; x < out_w; ++x) o[x] = static_cast<float>(acc[x]);
    }
  }
}

}  // extern "C"
