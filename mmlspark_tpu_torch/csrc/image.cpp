// Host image transforms of the PyTorch port: the port's copy of the
// resize and unroll functions of mmlspark_tpu/native/src/mml_native.cpp
// (mml_resize_bilinear_u8, mml_unroll_chw), with the same results bit for
// bit. uint8 HWC buffers in; no library beyond the C++ standard one.
// Built by the host compiler at first use; see mmlspark_tpu_torch/_build.py
// and io/native_image.py, which binds it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" {

// Separable antialiased triangle-kernel resize, matching
// jax.image.resize(method="bilinear", antialias=True): the JAX package's
// uint8 host resize, which this port's ops/image_ops.resize_host keeps
// for uint8 images so that both packages give the same pixels.
int mml_resize_bilinear_u8(const uint8_t* src, int h, int w, int c,
                           uint8_t* dst, int oh, int ow) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || c <= 0) return -1;
  const long n_in = static_cast<long>(h) * w * c;
  double* f64 = static_cast<double*>(std::malloc(sizeof(double) * n_in));
  double* mid = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<long>(oh) * w * c));
  double* out = static_cast<double*>(
      std::malloc(sizeof(double) * static_cast<long>(oh) * ow * c));
  if (!f64 || !mid || !out) {
    std::free(f64);
    std::free(mid);
    std::free(out);
    return -2;
  }
  for (long i = 0; i < n_in; ++i) f64[i] = src[i];

  // pass 1: H -> OH. Treat src as [h][w*c]; vertical stride = w*c.
  {
    const double scale = static_cast<double>(h) / oh;
    const double s = std::max(scale, 1.0);
    const long row = static_cast<long>(w) * c;
    for (int y = 0; y < oh; ++y) {
      const double center = (y + 0.5) * scale - 0.5;
      const int lo = static_cast<int>(std::ceil(center - s));
      const int hi = static_cast<int>(std::floor(center + s));
      // jax.image.resize drops out-of-range taps and renormalizes
      // over the in-range weight sum (no edge clamping)
      double wsum = 0.0;
      std::vector<double> wgt(hi - lo + 1);
      for (size_t j = 0; j < wgt.size(); ++j) {
        const int idx = lo + static_cast<int>(j);
        const double t = std::abs((idx - center) / s);
        wgt[j] = (idx >= 0 && idx < h && t < 1.0) ? 1.0 - t : 0.0;
        wsum += wgt[j];
      }
      for (long x = 0; x < row; ++x) {
        double acc = 0.0;
        for (size_t j = 0; j < wgt.size(); ++j) {
          if (wgt[j] == 0.0) continue;
          const int idx = lo + static_cast<int>(j);
          acc += wgt[j] * f64[static_cast<long>(idx) * row + x];
        }
        mid[static_cast<long>(y) * row + x] = acc / wsum;
      }
    }
  }
  // pass 2: W -> OW. mid is [oh][w][c].
  {
    const double scale = static_cast<double>(w) / ow;
    const double s = std::max(scale, 1.0);
    for (int x = 0; x < ow; ++x) {
      const double center = (x + 0.5) * scale - 0.5;
      const int lo = static_cast<int>(std::ceil(center - s));
      const int hi = static_cast<int>(std::floor(center + s));
      double wsum = 0.0;
      std::vector<double> wgt(hi - lo + 1);
      for (size_t j = 0; j < wgt.size(); ++j) {
        const int idx = lo + static_cast<int>(j);
        const double t = std::abs((idx - center) / s);
        wgt[j] = (idx >= 0 && idx < w && t < 1.0) ? 1.0 - t : 0.0;
        wsum += wgt[j];
      }
      for (int y = 0; y < oh; ++y) {
        for (int ch = 0; ch < c; ++ch) {
          double acc = 0.0;
          for (size_t j = 0; j < wgt.size(); ++j) {
            if (wgt[j] == 0.0) continue;
            const int idx = lo + static_cast<int>(j);
            acc += wgt[j] *
                   mid[(static_cast<long>(y) * w + idx) * c + ch];
          }
          out[(static_cast<long>(y) * ow + x) * c + ch] = acc / wsum;
        }
      }
    }
  }
  const long n_out = static_cast<long>(oh) * ow * c;
  for (long i = 0; i < n_out; ++i) {
    dst[i] = static_cast<uint8_t>(
        std::lround(std::min(255.0, std::max(0.0, out[i]))));
  }
  std::free(f64);
  std::free(mid);
  std::free(out);
  return 0;
}

// HWC uint8 -> CHW float64 unroll (UnrollImage's host path; the order of
// ops/image_ops.unroll_host's transpose(2, 0, 1).ravel())
int mml_unroll_chw(const uint8_t* src, int h, int w, int c, double* dst) {
  size_t i = 0;
  for (int ch = 0; ch < c; ++ch)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        dst[i++] = src[(static_cast<size_t>(y) * w + x) * c + ch];
  return 0;
}

}  // extern "C"
