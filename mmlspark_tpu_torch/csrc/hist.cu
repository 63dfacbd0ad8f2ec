// GBDT histogram kernel for Hopper (sm_90a).
//
// Replaces BOTH TPU kernels of mmlspark_tpu/gbdt/pallas_hist.py:
//   _hist_kernel_nibble  (single-leaf, padded B >= 128: hi/lo digit one-hot
//                         matmul on the MXU)
//   _hist_kernel         (multi-leaf / B < 128: leaf one-hot x bin one-hot)
// Those two exist only because of the TPU's VMEM budget, its matrix unit
// and Mosaic's (8, 128) tiling rules. On Hopper one kernel covers the
// whole (3, L, F, B) contract:
//
//   out[s, l, f, b] = sum over rows i with leaf[i] == l and bins[f, i] == b
//                     of stat_s(i),   stat = (grad*w, hess*w, count*w | w)
//
// Design (simple and right first; no attempt yet at the bound below):
//   * grid (feature tile, row chunk); one WARP per feature of the tile, so
//     each warp owns its feature's (3, L, B) slice of the block's shared
//     histogram exclusively — no shared-memory conflicts between warps.
//   * a warp walks its chunk 32 rows at a time; lanes whose (leaf, bin)
//     keys match are grouped with __match_any_sync and every lane sums its
//     group's stats in ascending lane order (32 uniform shuffles), then the
//     group's lowest lane adds the sum into shared memory. No floating
//     point atomics anywhere: the f32 result is bitwise reproducible from
//     run to run, as the JAX engine's forests are.
//   * each block writes its partial (3, L, f_tile, B) histogram into a
//     scratch buffer (n_chunks, 3, L, F, B); hist_reduce sums the chunks in
//     a fixed order (chunk 0, 1, 2, ...).
//   * integer stats (int8 / int16, the quantized-training wire) are
//     multiplied in the narrow type exactly as the JAX scatter path does
//     (grad * weight in int8 wraps the same way) and accumulate in int32,
//     which is exact in any order.
//   * rows with weight 0 contribute nothing and are skipped (the contract
//     of the TPU kernels: padding / masked rows add zero).
//
// Bound on the H100 SXM (3.35 TB/s): the kernel must read the bins once,
// 4*F*N bytes, plus the stats, 12*N bytes in f32. At F = 28, N = 1e6 that is
// ~124 MB, about 37 us per histogram; the tree grower launches it once per
// split, L = 63 launches per tree at num_leaves = 63, so ~2.3 ms per tree
// at the floor. (A row of weight 0 needs only its weight read, and this
// kernel reads nothing else of it, so a masked child's histogram has a
// lower floor.) Arithmetic is ~3 adds per (row, feature), far below the
// card's rate: the kernel is bound by bytes. This first design spends
// ~100 warp instructions per 32 (row, feature) cells on the shuffle sum
// and re-reads the stats once per feature of the tile (from L1/L2), so it
// is well above that floor; making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// product in the stats' own type, as the JAX scatter path computes it:
// (S)(a * b) — exact for f32, wrapping like numpy for int8 / int16
template <typename S, typename A>
__device__ __forceinline__ A narrow_mul(S a, S b) {
  return static_cast<A>(static_cast<S>(a * b));
}

template <typename S, typename A>
__global__ void hist_partial(const int32_t* __restrict__ bins,
                             const S* __restrict__ grad,
                             const S* __restrict__ hess,
                             const S* __restrict__ weight,
                             const S* __restrict__ count,   // may be null
                             const int32_t* __restrict__ leaf,  // null: L == 1
                             A* __restrict__ partial,
                             int F, long long N, int L, int B, int f_tile,
                             long long rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);  // (f_tile, 3, L, B)
  const int LB = L * B;
  const int per_feat = 3 * LB;
  for (int i = threadIdx.x; i < f_tile * per_feat; i += blockDim.x)
    sh[i] = A(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * f_tile + warp;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(N, r0 + rows_per_chunk);

  if (f < F) {  // warp-uniform
    A* hf = sh + warp * per_feat;
    const int32_t* brow = bins + static_cast<long long>(f) * N;
    for (long long base = r0; base < r1; base += 32) {
      const long long i = base + lane;
      int key = -1;
      A g = A(0), h = A(0), c = A(0);
      if (i < r1) {
        const S w = weight[i];
        if (w != S(0)) {
          const int b = brow[i];
          const int l = leaf ? leaf[i] : 0;
          if (b >= 0 && b < B && l >= 0 && l < L) {
            key = l * B + b;
            g = narrow_mul<S, A>(grad[i], w);
            h = narrow_mul<S, A>(hess[i], w);
            c = count ? narrow_mul<S, A>(count[i], w) : static_cast<A>(w);
          }
        }
      }
      if (__ballot_sync(kFull, key >= 0) == 0u) continue;
      const unsigned peers = __match_any_sync(kFull, key);
      A sg = A(0), sh_ = A(0), sc = A(0);
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const A xg = __shfl_sync(kFull, g, j);
        const A xh = __shfl_sync(kFull, h, j);
        const A xc = __shfl_sync(kFull, c, j);
        if ((peers >> j) & 1u) {
          sg += xg;
          sh_ += xh;
          sc += xc;
        }
      }
      if (key >= 0 && lane == __ffs(peers) - 1) {
        hf[key] += sg;
        hf[LB + key] += sh_;
        hf[2 * LB + key] += sc;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // partial layout (n_chunks, 3, L, F, B)
  A* dst = partial + static_cast<long long>(blockIdx.y) * 3LL * LB * F;
  for (int idx = threadIdx.x; idx < f_tile * per_feat; idx += blockDim.x) {
    const int fl = idx / per_feat;
    const int rem = idx - fl * per_feat;
    const int s = rem / LB;
    const int rem2 = rem - s * LB;
    const int l = rem2 / B;
    const int b = rem2 - l * B;
    const int fg = blockIdx.x * f_tile + fl;
    if (fg < F)
      dst[((static_cast<long long>(s) * L + l) * F + fg) * B + b] = sh[idx];
  }
}

template <typename A>
__global__ void hist_reduce(const A* __restrict__ partial, A* __restrict__ out,
                            long long total, int n_chunks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  A acc = partial[i];
  for (int c = 1; c < n_chunks; ++c)
    acc += partial[static_cast<long long>(c) * total + i];
  out[i] = acc;
}

template <typename S, typename A>
int launch(const int32_t* bins, const S* grad, const S* hess, const S* weight,
           const S* count, const int32_t* leaf, A* out, A* scratch, int F,
           long long N, int L, int B, int f_tile, long long rows_per_chunk,
           int n_chunks, int smem_bytes, cudaStream_t stream) {
  cudaError_t err;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(hist_partial<S, A>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((F + f_tile - 1) / f_tile, n_chunks);
  A* partial = n_chunks == 1 ? out : scratch;
  hist_partial<S, A><<<grid, f_tile * 32, smem_bytes, stream>>>(
      bins, grad, hess, weight, count, leaf, partial, F, N, L, B, f_tile,
      rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const long long total = 3LL * L * F * B;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hist_reduce<A><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      scratch, out, total, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). Every function returns the
// cudaError_t of its launches (0 on success). Pointers are device
// pointers; `count` may be null (count channel = weight) and `leaf` may be
// null (L == 1). `scratch` holds n_chunks * 3 * L * F * B accumulators and
// is unused when n_chunks == 1.
extern "C" {

int mml_hist_f32(const int32_t* bins, const float* grad, const float* hess,
                 const float* weight, const float* count,
                 const int32_t* leaf, float* out, float* scratch, int F,
                 long long N, int L, int B, int f_tile,
                 long long rows_per_chunk, int n_chunks, int smem_bytes,
                 void* stream) {
  return launch<float, float>(bins, grad, hess, weight, count, leaf, out,
                              scratch, F, N, L, B, f_tile, rows_per_chunk,
                              n_chunks, smem_bytes,
                              static_cast<cudaStream_t>(stream));
}

int mml_hist_i16(const int32_t* bins, const int16_t* grad,
                 const int16_t* hess, const int16_t* weight,
                 const int16_t* count, const int32_t* leaf, int32_t* out,
                 int32_t* scratch, int F, long long N, int L, int B,
                 int f_tile, long long rows_per_chunk, int n_chunks,
                 int smem_bytes, void* stream) {
  return launch<int16_t, int32_t>(bins, grad, hess, weight, count, leaf, out,
                                  scratch, F, N, L, B, f_tile,
                                  rows_per_chunk, n_chunks, smem_bytes,
                                  static_cast<cudaStream_t>(stream));
}

int mml_hist_i8(const int32_t* bins, const int8_t* grad, const int8_t* hess,
                const int8_t* weight, const int8_t* count,
                const int32_t* leaf, int32_t* out, int32_t* scratch, int F,
                long long N, int L, int B, int f_tile,
                long long rows_per_chunk, int n_chunks, int smem_bytes,
                void* stream) {
  return launch<int8_t, int32_t>(bins, grad, hess, weight, count, leaf, out,
                                 scratch, F, N, L, B, f_tile, rows_per_chunk,
                                 n_chunks, smem_bytes,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
