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
// What bounds it: bytes. A row of weight 0 adds nothing, so the least
// traffic is every row's weight once, and the bins, stats and leaf id
// only in the 32-byte sectors that hold a row of nonzero weight, plus the
// output. At F = 28, N = 1e6 that is ~124 MB for the tree's root (all
// rows active, ~37 us at 3.35 TB/s) and ~46 MB for a right child holding
// 5 % of the rows (~14 us). The tree grower builds one root and one
// masked child per split, and the children hold a few percent of the rows
// each, so a launch has to cost its active rows, not its rows.
//
// Design:
//   * grid (feature tile, row chunk). The chunk count is fixed by the row
//     count alone (hist_kernels.TARGET_BLOCKS), never by the card's SM
//     count, so the f32 summation order is the same on every card. At the
//     main path's shape one block holds all F features (F * 3 * B floats
//     of shared memory, 86 KB at 28 x 256), so each chunk's weights and
//     stats are read once, not once per feature tile.
//   * compaction: all threads of the block walk the chunk in pieces of
//     4 rows a thread, read each row's weight once and append the rows of
//     nonzero weight, in ascending row order (a warp scan of the per-
//     thread counts, then a block scan of the warp totals), to a list in
//     shared memory: the row's offset in the chunk and the products
//     grad*w, hess*w, count*w (or w) formed in the stats' own type, as
//     the JAX scatter path forms them. Stats are read for active rows only.
//     Each thread loads the next piece's weights into registers before
//     the list is consumed, so their latency hides behind the adds; a
//     cp.async ring in shared memory would not fit beside the histogram,
//     the peer masks and the list (229 KB at the main path's shape, one
//     block of 28 warps per SM).
//   * consumption: once the list holds two pieces (or the chunk ends), the
//     block's warps walk it, one warp owning each feature's (3, L, B)
//     slice of the shared histogram. A warp gathers bins[f, row] for the
//     next 4 groups of 32 list entries while it adds the current 4
//     (coalesced at the root, only the needed sectors at a child):
//       - f32: the lanes sharing a (leaf, bin) key find each other
//         through a per-warp mask per key in shared memory: each lane ORs
//         its bit into its key's mask with an integer atomic, and reads the
//         mask back (__match_any_sync gives the same masks at a far
//         higher cost per group on Hopper). The lowest lane
//         of each group of fewer than kTreeMin lanes fetches its peers'
//         values in ascending lane order (one round of three shuffles per
//         extra peer, as many rounds as the largest such group) and adds
//         the sum into shared memory. A group of kTreeMin or more (a
//         skewed feature: a constant column, a binary one, one bin holding
//         most rows) is summed by a fixed xor tree of 5 shuffles per stat;
//         once a feature has shown such a group, the warp probes the
//         lowest lanes' keys first (up to two groups), so those lanes
//         skip the atomics, which would serialise on one address. Every
//         cell is thus summed in an order fixed by the data alone: no
//         float atomics, and repeats are bitwise equal.
//       - int8 / int16 stats (the quantized-training wire) add into int32,
//         exact in any order: shared-memory atomicAdd, no grouping.
//   * each block writes its (3, L, f_tile, B) partial; hist_reduce sums
//     the chunks in chunk order (0, 1, 2, ...). With one chunk the block
//     writes the output itself.
//
// Not the tensor cores: the TPU kernels are one-hot products because the
// MXU was the TPU's fast path. Here a one-hot product would spend B or more
// multiply-adds per useful add, and an mma's f32 accumulation truncates
// (the drift the f32 flash_dkv had to be redesigned for).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// rows each thread stages per piece: hist_kernels.ROWS_PER_THREAD
constexpr int kRowsPerThread = 4;
constexpr int kPrefetch = 4;   // groups of 32 bins a warp keeps in flight
constexpr int kTreeMin = 7;    // a key group this large sums by a tree
constexpr int kMaxThreads = 1024;

// product in the stats' own type, as the JAX scatter path computes it:
// (S)(a * b) — exact for f32, wrapping like numpy for int8 / int16
template <typename S, typename A>
__device__ __forceinline__ A narrow_mul(S a, S b) {
  return static_cast<A>(static_cast<S>(a * b));
}

// f32: the lanes in `in` (all of one key k, `src` the lowest) summed by a
// fixed xor tree, every other lane adding zero; src adds the sum to hf
__device__ __forceinline__ void tree_add(float* hf, int LB, int k, bool in,
                                         float g, float h, float c,
                                         int src, int lane) {
  float sg = in ? g : 0.f, sh = in ? h : 0.f, sc = in ? c : 0.f;
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    sg += __shfl_xor_sync(kFull, sg, d);
    sh += __shfl_xor_sync(kFull, sh, d);
    sc += __shfl_xor_sync(kFull, sc, d);
  }
  if (lane == src) {
    hf[k] += sg;
    hf[LB + k] += sh;
    hf[2 * LB + k] += sc;
  }
}

// f32: add one group of 32 (key, g, h, c) lanes into the warp's own
// histogram slice hf (planes of LB floats); key < 0 marks an empty lane.
// pm: the warp's LB peer masks, all zero between calls. skewed: the
// warp's guess that this feature has a key held by many lanes, from the
// groups before. The order of every addition is fixed by the keys of this
// group and of the feature's groups before it alone.
__device__ __forceinline__ void add_group(float* hf, unsigned* pm, int LB,
                                          int key, float g, float h,
                                          float c, int lane, bool& skewed) {
  unsigned todo = __ballot_sync(kFull, key >= 0);
  if (todo == 0u) return;
  if (skewed) {
    // a skewed feature (constant, binary, one bin holding most rows):
    // probe the lowest lane's key first, and after a hit the next one; a
    // key held by kTreeMin lanes or more is summed by one xor tree,
    // without the shared-memory atomics below, which its lanes would
    // serialise on
    for (int p = 0; p < 2; ++p) {
      const int src = __ffs(todo) - 1;
      const int k = __shfl_sync(kFull, key, src);
      const unsigned grp = __ballot_sync(kFull, key == k);
      const bool hit = __popc(grp) >= kTreeMin;
      if (p == 0) skewed = hit;
      if (!hit) break;
      tree_add(hf, LB, k, key == k, g, h, c, src, lane);
      todo &= ~grp;
      if (todo == 0u) {
        __syncwarp();
        return;
      }
    }
  }
  // the lanes sharing each key (what __match_any_sync gives, at a
  // fraction of its cost): every lane ORs its bit into its key's mask
  const bool mine = (todo >> lane) & 1u;
  if (mine) atomicOr(pm + key, 1u << lane);
  __syncwarp();
  const unsigned peers = mine ? pm[key] : 0u;
  __syncwarp();
  const int cnt = __popc(peers);
  const unsigned below = (1u << lane) - 1u;
  const bool lead = mine && (peers & below) == 0u;
  if (lead) pm[key] = 0u;  // ordered before the next call by __syncwarp
  // large groups the probe missed: one xor tree each
  unsigned big = __ballot_sync(kFull, mine && cnt >= kTreeMin);
  skewed = skewed || big != 0u;
  while (big) {
    const int src = __ffs(big) - 1;   // the lowest lane of its group
    const int k = __shfl_sync(kFull, key, src);
    tree_add(hf, LB, k, key == k, g, h, c, src, lane);
    big &= ~__ballot_sync(kFull, key == k);
  }
  // small groups: each leader pulls its peers' values in ascending lane
  // (= row) order, one round per extra peer
  unsigned rest = (lead && cnt < kTreeMin) ? (peers & ~(1u << lane)) : 0u;
  const unsigned rounds = __reduce_max_sync(kFull, __popc(rest));
  float sg = g, sh = h, sc = c;
  for (unsigned r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float xg = __shfl_sync(kFull, g, src);
    const float xh = __shfl_sync(kFull, h, src);
    const float xc = __shfl_sync(kFull, c, src);
    if (rest) {
      sg += xg;
      sh += xh;
      sc += xc;
      rest &= rest - 1u;
    }
  }
  if (lead && cnt < kTreeMin) {
    hf[key] += sg;
    hf[LB + key] += sh;
    hf[2 * LB + key] += sc;
  }
  __syncwarp();
}

// int32 accumulators (integer stats): exact in any order
__device__ __forceinline__ void add_group(int32_t* hf, unsigned*, int LB,
                                          int key,
                                          int32_t g, int32_t h,
                                          int32_t c, int, bool&) {
  if (key >= 0) {
    atomicAdd(hf + key, g);
    atomicAdd(hf + LB + key, h);
    atomicAdd(hf + 2 * LB + key, c);
  }
}

// shared memory: hist (f_tile, 3, L, B) | peer masks (n_warps, L * B) |
// row offsets [cap] | g, h, c [cap each] | leaf * B [cap, only when
// L > 1] | warp totals [32]
template <typename S, typename A>
__global__ void __launch_bounds__(kMaxThreads, 1)
hist_partial(const int32_t* __restrict__ bins, const S* __restrict__ grad,
             const S* __restrict__ hess, const S* __restrict__ weight,
             const S* __restrict__ count,      // may be null
             const int32_t* __restrict__ leaf,  // null: L == 1
             A* __restrict__ partial, int F, long long N, int L, int B,
             int f_tile, long long rows_per_chunk, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = L * B;
  const int per_feat = 3 * LB;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  A* hist = reinterpret_cast<A*>(smem_raw);
  unsigned* masks = reinterpret_cast<unsigned*>(hist + f_tile * per_feat);
  int* e_row = reinterpret_cast<int*>(masks + nwarps * LB);
  A* e_g = reinterpret_cast<A*>(e_row + cap);
  A* e_h = e_g + cap;
  A* e_c = e_h + cap;
  int* e_leaf = reinterpret_cast<int*>(e_c + cap);
  int* scan = e_leaf + (leaf ? cap : 0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * f_tile;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(N, r0 + rows_per_chunk);
  const int piece = nthr * kRowsPerThread;

  for (int i = threadIdx.x; i < f_tile * per_feat; i += nthr) hist[i] = A(0);
  for (int i = threadIdx.x; i < nwarps * LB; i += nthr) masks[i] = 0u;
  unsigned* pm = masks + warp * LB;

  int n_list = 0;  // entries in the list; the same in every thread
  for (long long p0 = r0; p0 < r1; p0 += piece) {
    // ---- compaction of one piece: the rows of nonzero weight ---------
    const long long rb = p0 + static_cast<long long>(threadIdx.x) *
                                  kRowsPerThread;
    S w[kRowsPerThread];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      w[k] = rb + k < r1 ? weight[rb + k] : S(0);
      mine += w[k] != S(0);
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();  // also orders the zeroed hist / the last consume
    if (warp == 0) {
      int v = lane < nwarps ? scan[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += y;
      }
      if (lane < nwarps) scan[lane] = v;
    }
    __syncthreads();
    int pos = n_list + (warp ? scan[warp - 1] : 0) + incl - mine;
    n_list += scan[nwarps - 1];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (w[k] != S(0)) {
        const long long r = rb + k;
        e_row[pos] = static_cast<int>(r - r0);
        e_g[pos] = narrow_mul<S, A>(grad[r], w[k]);
        e_h[pos] = narrow_mul<S, A>(hess[r], w[k]);
        e_c[pos] = count ? narrow_mul<S, A>(count[r], w[k])
                         : static_cast<A>(w[k]);
        if (leaf) {
          const int l = leaf[r];
          e_leaf[pos] = (l >= 0 && l < L) ? l * B : -1;
        }
        ++pos;
      }
    }
    __syncthreads();  // the list is complete; scan[] may be reused
    if (n_list == 0 || (p0 + piece < r1 && n_list + piece <= cap))
      continue;

    // ---- consumption: each warp adds the list into its features ------
    for (int fk = warp; fk < f_tile && f0 + fk < F; fk += nwarps) {
      A* hf = hist + fk * per_feat;
      const int32_t* brow = bins + static_cast<long long>(f0 + fk) * N + r0;
      bool skewed = false;
      // bins of the next kPrefetch groups are loaded while the current
      // ones are added
      int b[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int e = u * 32 + lane;
        b[u] = e < n_list ? __ldg(brow + e_row[e]) : -1;
      }
      for (int e0 = 0; e0 < n_list; e0 += 32 * kPrefetch) {
        int bn[kPrefetch];
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int e = e0 + (kPrefetch + u) * 32 + lane;
          bn[u] = e < n_list ? __ldg(brow + e_row[e]) : -1;
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          if (e0 + u * 32 >= n_list) break;  // warp-uniform
          const int e = e0 + u * 32 + lane;
          int key = -1;
          A g = A(0), h = A(0), c = A(0);
          if (e < n_list && b[u] >= 0 && b[u] < B) {
            const int lb = leaf ? e_leaf[e] : 0;
            if (lb >= 0) {
              key = lb + b[u];
              g = e_g[e];
              h = e_h[e];
              c = e_c[e];
            }
          }
          add_group(hf, pm, LB, key, g, h, c, lane, skewed);
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) b[u] = bn[u];
      }
    }
    n_list = 0;
    // the next piece's first __syncthreads orders this consume before the
    // list is overwritten
  }
  __syncthreads();

  // partial layout (n_chunks, 3, L, F, B)
  A* dst = partial + static_cast<long long>(blockIdx.y) * 3LL * LB * F;
  for (int idx = threadIdx.x; idx < f_tile * per_feat; idx += nthr) {
    const int fl = idx / per_feat;
    const int rem = idx - fl * per_feat;
    const int s = rem / LB;
    const int rem2 = rem - s * LB;
    const int l = rem2 / B;
    const int b = rem2 - l * B;
    const int fg = f0 + fl;
    if (fg < F)
      dst[((static_cast<long long>(s) * L + l) * F + fg) * B + b] = hist[idx];
  }
}

// out[i] = sum of the chunks' partials in chunk order 0, 1, 2, ...; eight
// loads in flight a thread
template <typename A>
__global__ void hist_reduce(const A* __restrict__ partial, A* __restrict__ out,
                            long long total, int n_chunks) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  A acc = partial[i];
  int c = 1;
  for (; c + 8 <= n_chunks; c += 8) {
    A v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = partial[static_cast<long long>(c + j) * total + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; c < n_chunks; ++c)
    acc += partial[static_cast<long long>(c) * total + i];
  out[i] = acc;
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per
// device
template <typename S, typename A>
cudaError_t opt_in(int smem_bytes) {
  constexpr int kMaxDevices = 64;
  static int granted[kMaxDevices] = {};
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev] >= smem_bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(hist_partial<S, A>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = smem_bytes;
  return err;
}

template <typename S, typename A>
int launch(const int32_t* bins, const S* grad, const S* hess, const S* weight,
           const S* count, const int32_t* leaf, A* out, A* scratch, int F,
           long long N, int L, int B, int f_tile, int n_warps,
           long long rows_per_chunk, int n_chunks, int cap, int smem_bytes,
           cudaStream_t stream) {
  if (n_warps < 1 || n_warps * 32 > kMaxThreads ||
      cap < n_warps * 32 * kRowsPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<S, A>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + f_tile - 1) / f_tile, n_chunks);
  A* partial = n_chunks == 1 ? out : scratch;
  hist_partial<S, A><<<grid, n_warps * 32, smem_bytes, stream>>>(
      bins, grad, hess, weight, count, leaf, partial, F, N, L, B, f_tile,
      rows_per_chunk, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const long long total = 3LL * L * F * B;
  const int threads = 128;
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
// is unused when n_chunks == 1. The geometry (f_tile, n_warps,
// rows_per_chunk, n_chunks, cap, smem_bytes) is hist_kernels.launch_plan's.
extern "C" {

int mml_hist_f32(const int32_t* bins, const float* grad, const float* hess,
                 const float* weight, const float* count,
                 const int32_t* leaf, float* out, float* scratch, int F,
                 long long N, int L, int B, int f_tile, int n_warps,
                 long long rows_per_chunk, int n_chunks, int cap,
                 int smem_bytes, void* stream) {
  return launch<float, float>(bins, grad, hess, weight, count, leaf, out,
                              scratch, F, N, L, B, f_tile, n_warps,
                              rows_per_chunk, n_chunks, cap, smem_bytes,
                              static_cast<cudaStream_t>(stream));
}

int mml_hist_i16(const int32_t* bins, const int16_t* grad,
                 const int16_t* hess, const int16_t* weight,
                 const int16_t* count, const int32_t* leaf, int32_t* out,
                 int32_t* scratch, int F, long long N, int L, int B,
                 int f_tile, int n_warps, long long rows_per_chunk,
                 int n_chunks, int cap, int smem_bytes, void* stream) {
  return launch<int16_t, int32_t>(bins, grad, hess, weight, count, leaf, out,
                                  scratch, F, N, L, B, f_tile, n_warps,
                                  rows_per_chunk, n_chunks, cap, smem_bytes,
                                  static_cast<cudaStream_t>(stream));
}

int mml_hist_i8(const int32_t* bins, const int8_t* grad, const int8_t* hess,
                const int8_t* weight, const int8_t* count,
                const int32_t* leaf, int32_t* out, int32_t* scratch, int F,
                long long N, int L, int B, int f_tile, int n_warps,
                long long rows_per_chunk, int n_chunks, int cap,
                int smem_bytes, void* stream) {
  return launch<int8_t, int32_t>(bins, grad, hess, weight, count, leaf, out,
                                 scratch, F, N, L, B, f_tile, n_warps,
                                 rows_per_chunk, n_chunks, cap, smem_bytes,
                                 static_cast<cudaStream_t>(stream));
}

// Blocks of the f32 kernel that fit one SM at a plan's (n_warps,
// smem_bytes): out[0]. Returns the cudaError_t.
int mml_hist_occupancy(int n_warps, int smem_bytes, int* out) {
  cudaError_t err = opt_in<float, float>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, hist_partial<float, float>, n_warps * 32, smem_bytes));
}

}  // extern "C"
