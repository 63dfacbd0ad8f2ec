// Host binning of the GBDT engine: per-feature searchsorted of raw
// features against each feature's ascending bin boundaries, on every
// core through OpenMP. The port's copy of the three binning functions of
// mmlspark_tpu/native/src/mml_native.cpp (mml_apply_bins,
// mml_apply_bins_t_u8_range, mml_apply_bins_t_u8), with the same results
// bit for bit: a value v lands in bin lower_bound(bounds_f, v), the count
// of boundaries strictly below v (numpy's searchsorted side='left'), and
// NaN lands in bin 0. float32 input widens to double before the compare,
// which is exact, so f32 and f64 input bin alike.
//
// bounds is the concatenation of every feature's boundaries and
// offsets[f]..offsets[f+1] delimit feature f's. Built by the host
// compiler (g++ -O3 -fopenmp) at first use; see mmlspark_tpu_torch/_build.py.
//
// Beyond the reference: the features-major kernel also splits its row
// tiles over the OpenMP threads (each (feature, row) cell is written by
// one thread, so the result does not depend on the thread count).

#include <omp.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

// std::lower_bound(lo, lo + n, v) - lo, the count of boundaries strictly
// below v, without data-dependent branches: each step halves the range
// by adding the compare's 0 / 1 times the half, so the unpredictable
// compares cost no mispredicted branch (most of a branchy search's time
// here). The steps depend on n alone.
inline long bin_of(const double* lo, long n, double v) {
  long base = 0;
  while (n > 1) {
    const long half = n / 2;
    base += static_cast<long>(lo[base + half - 1] < v) * half;
    n -= half;
  }
  return base + static_cast<long>(n == 1 && lo[base] < v);
}

}  // namespace

extern "C" {

// OpenMP threads a parallel region of this library runs on.
int mml_bins_threads() { return omp_get_max_threads(); }

// row-major (n, f) float64 features -> row-major (n, f) int32 bins.
int mml_apply_bins(const double* X, long n, int f, const double* bounds,
                   const long* offsets, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    for (int j = 0; j < f; ++j) {
      const double v = X[i * f + j];
      const double* lo = bounds + offsets[j];
      const long nb = offsets[j + 1] - offsets[j];
      out[i * f + j] =
          std::isnan(v) ? 0 : static_cast<int32_t>(bin_of(lo, nb, v));
    }
  }
  return 0;
}

// fused bin + transpose + narrow of the columns [j0, j1) of row-major
// (n, f) features (float32 when x_is_f32, else float64) into the
// FEATURES-MAJOR (j1 - j0, n) uint8 block the engine ships to the card.
// Every feature must have at most 256 bins (the caller checks). Rows go
// in tiles of 8192 so the strided reads stay in cache while each
// feature's writes run contiguous.
int mml_apply_bins_t_u8_range(const void* Xv, int x_is_f32, long n,
                              int f, int j0, int j1,
                              const double* bounds, const long* offsets,
                              uint8_t* out) {
  if (j0 < 0 || j1 > f || j0 >= j1) return 1;
  const float* Xf = static_cast<const float*>(Xv);
  const double* Xd = static_cast<const double*>(Xv);
  const long TILE = 8192;
  const long n_tiles = (n + TILE - 1) / TILE;
#pragma omp parallel for schedule(static)
  for (long t = 0; t < n_tiles; ++t) {
    const long t0 = t * TILE;
    const long t1 = std::min(n, t0 + TILE);
    for (int j = j0; j < j1; ++j) {
      const double* lo = bounds + offsets[j];
      const long nb = offsets[j + 1] - offsets[j];
      uint8_t* orow = out + static_cast<long>(j - j0) * n;
      for (long i = t0; i < t1; ++i) {
        const double v = x_is_f32 ? static_cast<double>(Xf[i * f + j])
                                  : Xd[i * f + j];
        orow[i] = std::isnan(v) ? 0 : static_cast<uint8_t>(bin_of(lo, nb, v));
      }
    }
  }
  return 0;
}

int mml_apply_bins_t_u8(const void* Xv, int x_is_f32, long n, int f,
                        const double* bounds, const long* offsets,
                        uint8_t* out) {
  return mml_apply_bins_t_u8_range(Xv, x_is_f32, n, f, 0, f, bounds,
                                   offsets, out);
}

}  // extern "C"
