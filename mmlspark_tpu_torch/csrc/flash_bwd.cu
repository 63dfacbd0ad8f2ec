// Flash-attention backward for Hopper (sm_90a): two kernels per type.
//
//   flash_dq  replaces mmlspark_tpu/ops/flash_attention.py::_dq_kernel
//   flash_dkv replaces mmlspark_tpu/ops/flash_attention.py::_dkv_kernel
//
// (both pallas_calls of _flash_backward). Same function as there, with the
// probabilities recomputed from the forward's per-row log-sum-exp:
//
//   S = Q K^T * scale,  P = valid ? exp(S - LSE) : 0,  dP = dO V^T,
//   dS = P o (dP - delta) * scale,   delta_i = rowsum(dO_i o O_i),
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO,
//
// where key j is valid for query i when i < Lq, j < Lk and, in causal mode,
// i + q_off >= j + k_off. delta is computed outside the kernels (as the JAX
// package computes it in XLA outside Pallas); a fully masked row has
// LSE = -1e30 and no valid key, so its P is 0 and exp never sees +huge.
//
// What the TPU design was for, and what this one does instead:
//   * The TPU grid runs in order and carries dq_scr across the KV grid axis
//     and dk_scr / dv_scr across the Q grid axis in VMEM. Here blocks run in
//     parallel: a flash_dq block owns one (batch*head, Q tile) and loops
//     over KV tiles; a flash_dkv block owns one (batch*head, key tile) and
//     loops over Q tiles. No block writes another's rows: no atomics, so
//     two launches are bitwise equal.
//   * Causal skipping as _fully_masked does it: flash_dq stops before the
//     first KV tile above the diagonal; flash_dkv starts at the first Q tile
//     whose last row reaches the key tile's first key. Within a block, a
//     warp skips the tiles its own 16 rows (or keys) see fully masked.
//   * No padding: the TPU's padded Q rows carry dO = 0 and delta = 0 and
//     cancel out. Here the kernels read q / k / v / dO in place through
//     their (batch, sequence, head) strides (q / k / v are views of one
//     (B, L, 3*dim) projection), stage ragged tails as zeros and mask query
//     rows >= Lq and keys >= Lk themselves. dq / dk / dv are written as
//     fresh contiguous (B, L, H, D) tensors in the inputs' type.
//   * Every product accumulates in f32; bf16 is rounded once, at the store.
//   * Only tiles that the diagonal or a ragged edge crosses pay for the
//     per-element mask.
//
// All four kernels run on the tensor cores with mma.sync, one warp per 16
// rows of the M dimension (query rows for dq, keys for dK / dV), the
// product's result in f32 C fragments that feed the next product from
// registers as its A operand. Each type has one route: no SIMT body.
//
//   flash_dq_tf32x3<DP, NSPLIT>, float32, 3xTF32 (mma_tf32.cuh: each f32
//     operand split into big + small TF32 halves, three m16n8k8 products
//     into one f32 accumulator, which keeps the f32 contract that one TF32
//     rounding breaks). A block owns 128 query rows (8 warps; 64 rows with
//     NSPLIT = 2 above D = 128), heaviest causal tiles first, and loops
//     over 32-key KV tiles (16 at D = 256) that come through a two-stage
//     cp.async ring shared by the block's 8 warps. Q and dO are staged
//     once and their A fragments re-read with 16-byte loads per tile
//     (holding them would take 128 registers a thread at D = 128). Per KV
//     tile, in registers: S = Q K^T and dP = dO V^T in 3xTF32 with K and
//     V's (key, d) rows as the B operand (16-byte loads, two k8 steps a
//     load, k relabelled as in the f32 forward); P and dS on the f32
//     fragments; dQ += dS K with dS's C fragment as the A operand (a0..a3
//     = c0 c2 c1 c3, logical k t <-> key 2t, t+4 <-> 2t+1) and K's rows 2t
//     and 2t+1 in 8-byte loads (two output tiles a load). K feeds B
//     fragments both ways, so the tiles are swizzled (mma_tf32.cuh), not
//     padded. dQ accumulates in registers (64 floats a thread at
//     D = 128); above D = 128 two warps split a row group's output
//     columns and both compute S and dP. Shared memory: 192 KB at
//     D = 128 and D = 256 (one block, 8 warps, per SM).
//
//   flash_dkv_tf32x3<DP>, float32, 3xTF32, in the transposed orientation.
//     A block owns 64 keys: 4 groups of 16 keys as the M rows, each
//     shared by a pair of warps that split its output columns, so a
//     thread holds 64 floats of dK and dV at D = 128, not 128. The block
//     loops over 32-query Q tiles (16 at D = 256) from the first causal
//     one; K and V are staged once, Q, dO and the tile's LSE and delta
//     come through a two-stage cp.async ring. Per 16-query slice, one warp
//     of the pair computes S^T = K Q^T and P^T, the other dP^T = V dO^T,
//     both in 3xTF32 (no product is computed twice); they trade the two
//     f32 fragments through shared memory under a 64-thread named
//     barrier, and each forms dS^T and adds its half of the columns of
//     dV += P^T dO and dK += dS^T Q, with P^T and dS^T as A fragments
//     straight from registers and dO's / Q's rows 2t, 2t+1 in 8-byte
//     loads. The registers this frees let those long sums be flushed to
//     round-to-nearest f32 adds (mma_xb_3xtf32): accumulated inside the
//     tensor cores, which truncate, they drift with the number of
//     queries. Shared memory: 144 KB at D = 128, 208 KB at D = 256 (one
//     block, 8 warps, per SM).
//
//   flash_dkv_bf16<DP, NSPLIT>, bfloat16 (mma_bf16.cuh), in the transposed
//     orientation. A block owns 64 keys, 4 warps x 16 keys as the M rows,
//     and loops over 64-row Q tiles from the first causal one. K and V of
//     the block are staged once; Q, dO and the tile's LSE and delta go
//     through a two-stage cp.async ring (tile t+1's loads issued before
//     tile t is computed). Per half of a Q tile (32 queries, so that
//     nothing spills at D = 128), all in registers: S^T = K Q^T and
//     dP^T = V dO^T by mma.sync with Q and dO's (q, d) rows as the .col B
//     operand (ldmatrix; K and V re-read from shared memory with ldmatrix
//     rather than held); P^T and dS^T on the f32 fragments; dV += P^T dO
//     and dK += dS^T Q with P^T and dS^T as A fragments straight from
//     registers, split into hi + lo bf16 halves so the products keep them
//     in f32 as the TPU kernel does, and dO and Q through ldmatrix.trans.
//     dK and dV accumulate in registers (128 floats a thread at D = 128).
//     Heads above D = 128 (DP 160, 256) run the same kernel with 8 warps:
//     each 16-key group's output columns are split between two warps,
//     which both compute S^T and dP^T. Shared memory: K, V and 2 x (Q, dO)
//     as bf16 rows of DP + 8, 103 KB at D = 128 (two blocks per SM),
//     198 KB at D = 256.
//
//   flash_dq_bf16<DP, NSPLIT>, bfloat16, in the forward's orientation. A
//     block owns one (batch*head, 64-row Q tile), 4 warps x 16 query rows,
//     heaviest causal tiles first, and loops over 32-key KV tiles; a thread
//     keeps the LSE and delta of its two rows (g, g + 8) in registers. Q
//     and dO are staged once; K and V go through a two-stage cp.async ring.
//     Per KV tile, all in registers: S = Q K^T and dP = dO V^T by mma.sync
//     with Q and dO as row A operands (ldmatrix, re-read per tile rather
//     than held, so that nothing spills at D = 128) and K and V's (key, d)
//     rows as the .col B operand; P and dS on the f32 fragments;
//     dQ += dS K with dS as the A fragment straight from registers, split
//     hi + lo so that the product keeps dS in f32 as the TPU kernel does
//     (4 products where a plain bf16 kernel does 3), and K through
//     ldmatrix.trans. dQ accumulates in registers (64 floats a thread at
//     D = 128); heads above D = 128 (DP 160, 256) split each warp-row
//     group's output columns between two warps (NSPLIT = 2), which both
//     compute S and dP. Shared memory: Q, dO and 2 x (K, V) as bf16 rows
//     of DP + 8, 68 KB at D = 128 (three blocks per SM), 132 KB at
//     D = 256.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: flash_dq does 6*D flops per unmasked (query, key) pair
// (51.6 GFLOP), flash_dkv 8*D (68.8 GFLOP). Under the f32 contract the
// least time is 3xTF32 on the tensor cores (495 / 3 TFLOP/s of useful
// work): 0.31 ms and 0.42 ms, far above the ~0.1 ms needed to move their
// inputs and outputs once at 3.35 TB/s: bound by operations. In bf16 on
// the tensor cores (989 TFLOP/s) flash_dq needs 0.052 ms and flash_dkv
// 0.070 ms for their operations, above the bytes' 0.05-0.06 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int BQ = 64;               // query rows per Q tile (bf16 kernels)
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's opt-in maximum

struct Args {
  int H, Lq, Lk, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, gsb, gsl, gsh;
  float scale;
  int causal, q_off, k_off;
};

__device__ __forceinline__ bool is_valid(const Args& a, int qpos, int kpos) {
  return qpos < a.Lq && kpos < a.Lk &&
         (!a.causal || qpos + a.q_off >= kpos + a.k_off);
}

// ----------------------------------------------- float32, 3xTF32 (mma)
constexpr int NT32 = 256;  // threads of an f32 block: 8 warps
constexpr int BKV32 = 64;  // keys of a flash_dkv_tf32x3 block

// Rows of a ring tile of the f32 kernels (keys of flash_dq, queries of
// flash_dkv) for DP, the head dim padded with zeros to a multiple of 32.
// Every tile of the f32 kernels is an unpadded, swizzled (rows, DP) tile
// (mma_tf32.cuh).
constexpr int ring_rows_f32(int dp) { return dp > 160 ? 16 : 32; }

// flash_dq_tf32x3: 16-row groups of 8 / NSPLIT warps (NSPLIT warps share
// a group's output columns); Q and dO (BM rows); 2 stages of K and V.
template <int DP, int NSPLIT>
struct DqCfg {
  static constexpr int WG = 8 / NSPLIT;
  static constexpr int BM = 16 * WG;
  static constexpr int BN = ring_rows_f32(DP);
  static constexpr size_t kSmem = sizeof(float) * (2 * BM + 4 * BN) * DP;
  static_assert(kSmem <= kMaxSmem, "a flash_dq block fits in 227 KB");
};

// flash_dkv_tf32x3: K and V (BKV32 rows); 2 stages of Q, dO and the Q
// tile's LSE and delta; and the fragments a warp pair exchanges: 4 key
// groups x 2 roles x 2 buffers x (2 n8 tiles x 32 lanes x 4 floats).
template <int DP>
struct DkvCfg {
  static constexpr int BN = ring_rows_f32(DP);
  static constexpr int XF = 256;  // floats of one exchanged fragment pair
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * BKV32 + 4 * BN) * DP + 4 * BN + 16 * XF);
  static_assert(kSmem <= kMaxSmem, "a flash_dkv block fits in 227 KB");
};

// The thread's output columns c0 + 16j + 4t .. 4t+3 of rows g (hr 0) and
// g + 8 (hr 1), from the tiles 2j and 2j+1 of acc (the relabelled output
// columns of a product whose B operand came in 8-byte loads), stored as
// one float4 where D allows.
template <int NO>
__device__ __forceinline__ void store_rows_f32(float* base, long long row0,
                                               long long row1, int H, int D,
                                               int c0, int t,
                                               const float (&acc)[NO][4],
                                               bool in0, bool in1) {
  const bool quads = (D & 3) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!(hr ? in1 : in0)) continue;
    float* orow = base + (hr ? row1 : row0) * H * D;
#pragma unroll
    for (int j = 0; j < NO / 2; ++j) {
      const int c = c0 + 16 * j + 4 * t;
      const float x[4] = {acc[2 * j][2 * hr], acc[2 * j + 1][2 * hr],
                          acc[2 * j][2 * hr + 1], acc[2 * j + 1][2 * hr + 1]};
      if (quads && c + 3 < D) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) orow[c + e] = x[e];
      }
    }
  }
}

// acc (16 x NN*8) += A B^T in 3xTF32: A is rows a0 + g, a0 + g + 8 of the
// tile at, B rows b0.. of the tile bt (both (., DP), swizzled). k8 step 2c
// takes columns 16c + 4t, 4t+1 as logical k t, t+4, step 2c+1 columns
// 4t+2, 4t+3: one 16-byte load gives two k8 steps of A and of B.
template <int DP, int NN>
__device__ __forceinline__ void mma_abt_3xtf32(float (&acc)[NN][4],
                                               const float* at, int a0,
                                               const float* bt, int b0,
                                               int g, int t) {
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    const int col = 16 * c + 4 * t;
    const float4 x0 = *reinterpret_cast<const float4*>(
        at + mml::swz_off<DP>(a0 + g, col));
    const float4 x1 = *reinterpret_cast<const float4*>(
        at + mml::swz_off<DP>(a0 + g + 8, col));
    uint32_t ab0[4], as0[4], ab1[4], as1[4];
    mml::split_a_tf32(x0.x, x1.x, x0.y, x1.y, ab0, as0);
    mml::split_a_tf32(x0.z, x1.z, x0.w, x1.w, ab1, as1);
#pragma unroll
    for (int nt = 0; nt < NN; ++nt) {
      const float4 y = *reinterpret_cast<const float4*>(
          bt + mml::swz_off<DP>(b0 + nt * 8 + g, col));
      mml::mma_3xtf32(acc[nt], ab0, as0, y.x, y.y);
      mml::mma_3xtf32(acc[nt], ab1, as1, y.z, y.w);
    }
  }
}

// acc (16 x NO*8, output columns c0..) += X (16 x NK*8, the f32 C
// fragments x) times rows r0.. of a swizzled (., DP) tile, in 3xTF32. X's
// C fragment of an n8 tile is the A fragment of one k8 step (a0..a3 = c0
// c2 c1 c3, logical k t <-> row 2t, t+4 <-> 2t+1); output tiles 2j and
// 2j+1 take columns c0 + 16j + 2n and c0 + 16j + 2n + 1 for logical n, so
// one 8-byte load of each of the rows 2t, 2t+1 feeds both. The tensor
// cores round each accumulation toward zero: fed straight into acc, the
// three products of every k8 step bias a long sum (dK, dV over all
// queries) in proportion to its length, 7x the error of f32 FMA sums at
// 1024 causal queries (PERF.md, §6). So the NK k8 steps of a tile pair
// are summed in a zeroed fragment and added to acc by f32 adds, which
// round to nearest.
template <int DP, int NK, int NO>
__device__ __forceinline__ void mma_xb_3xtf32(float (&acc)[NO][4],
                                              const float (&x)[NK][4],
                                              const float* bt, int r0,
                                              int c0, int g, int t) {
  uint32_t xb[NK][4], xs[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    mml::split_a_tf32(x[kk][0], x[kk][2], x[kk][1], x[kk][3], xb[kk],
                      xs[kk]);
#pragma unroll
  for (int j = 0; j < NO / 2; ++j) {
    const int col = c0 + 16 * j + 2 * g;
    float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int r = r0 + kk * 8 + 2 * t;
      const float2 y0 =
          *reinterpret_cast<const float2*>(bt + mml::swz_off<DP>(r, col));
      const float2 y1 =
          *reinterpret_cast<const float2*>(bt + mml::swz_off<DP>(r + 1, col));
      mml::mma_3xtf32(p0, xb[kk], xs[kk], y0.x, y1.x);
      mml::mma_3xtf32(p1, xb[kk], xs[kk], y0.y, y1.y);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * j][e] += p0[e];
      acc[2 * j + 1][e] += p1[e];
    }
  }
}

// Wait for the `threads` threads of named barrier `id` (1..15; 0 is
// __syncthreads); orders their shared-memory accesses like it.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int DP, int NSPLIT>
__global__ void __launch_bounds__(NT32)
    flash_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlt, float* __restrict__ dq,
                    Args a, int vec) {
  using C = DqCfg<DP, NSPLIT>;
  constexpr int NT = NT32, BM = C::BM, BN = C::BN;
  constexpr int DPW = DP / NSPLIT;  // output columns of one warp
  constexpr int NO = DPW / 8;       // n8 tiles of a warp's dQ rows
  constexpr int NS = BN / 8;        // n8 tiles of a warp's S and dP rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // (BM, DP)
  float* Gs = Qs + BM * DP;                         // (BM, DP): dO
  float* Ks = Gs + BM * DP;                         // 2 stages of (BN, DP)
  float* Vs = Ks + 2 * BN * DP;                     // 2 stages of (BN, DP)

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BM;
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp % C::WG) * 16;  // the warp's first row in the Q tile
  const int c0 = (warp / C::WG) * DPW;  // the warp's first output column

  const float* qb = q + b * a.qsb + h * a.qsh;
  const float* kb = k + b * a.ksb + h * a.ksh;
  const float* vb = v + b * a.vsb + h * a.vsh;
  const float* gb = g + b * a.gsb + h * a.gsh;

  int n_kv = (a.Lk + BN - 1) / BN;
  if (a.causal) {
    // tile kt is fully masked when kt*BN + k_off > q0 + BM - 1 + q_off
    const long long last =
        static_cast<long long>(q0) + BM - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BN) + 1;
    n_kv = min(n_kv, n_c);
  }

  mml::stage_tile_swz<BM, DP, NT>(Qs, qb, a.qsl, q0, a.Lq, D, vec);
  mml::stage_tile_swz<BM, DP, NT>(Gs, gb, a.gsl, q0, a.Lq, D, vec);
  if (n_kv > 0) {
    mml::stage_tile_swz<BN, DP, NT>(Ks, kb, a.ksl, 0, a.Lk, D, vec);
    mml::stage_tile_swz<BN, DP, NT>(Vs, vb, a.vsl, 0, a.Lk, D, vec);
  }
  mml::cp_async_commit();

  // LSE and delta of the thread's rows g (hr 0) and g + 8 (hr 1); a row
  // past Lq reads 0 for both, and its zero Q and dO then give dS = 0
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + gq + 8 * hr;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse_r[hr] = row < a.Lq ? lse[at] : 0.f;
    dlt_r[hr] = row < a.Lq ? dlt[at] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // global position of the thread's first row; the last key position the
  // warp's rows reach (causal)
  const long long qpos0 = static_cast<long long>(q0) + wr + gq + a.q_off;
  const long long wlast =
      static_cast<long long>(q0) + wr + 15 + a.q_off - a.k_off;
  const bool rows_in = q0 + wr < a.Lq;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * BN;
      mml::stage_tile_swz<BN, DP, NT>(Ks + (st ^ 1) * BN * DP, kb, a.ksl, k1,
                                      a.Lk, D, vec);
      mml::stage_tile_swz<BN, DP, NT>(Vs + (st ^ 1) * BN * DP, vb, a.vsl, k1,
                                      a.Lk, D, vec);
    }
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile kt (and Q, dO) landed
    __syncthreads();
    const float* Kt = Ks + st * BN * DP;
    const float* Vt = Vs + st * BN * DP;
    const int k0 = kt * BN;

    // the warp's rows see some key of the tile
    if (rows_in && (!a.causal || k0 <= wlast)) {
      // S = Q K^T (unscaled) and dP = dO V^T, 16 x BN per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      mma_abt_3xtf32<DP, NS>(s, Qs, wr, Kt, 0, gq, t);
      mma_abt_3xtf32<DP, NS>(dp, Gs, wr, Vt, 0, gq, t);

      // P = valid ? exp(S * scale - LSE) : 0, dS = P o (dP - delta) * scale
      // in place of dP; the thread's keys are k0 + nt*8 + 2t + e
      const bool full =
          k0 + BN <= a.Lk &&
          (!a.causal || static_cast<long long>(q0) + wr + a.q_off >=
                            static_cast<long long>(k0) + BN - 1 + a.k_off);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + nt * 8 + 2 * t + e;
            const bool ok =
                full || (kpos < a.Lk &&
                         (!a.causal || qpos0 + 8 * hr >=
                                           static_cast<long long>(kpos) +
                                               a.k_off));
            const float p =
                ok ? expf(s[nt][2 * hr + e] * a.scale - lse_r[hr]) : 0.f;
            float& x = dp[nt][2 * hr + e];
            x = p * (x - dlt_r[hr]) * a.scale;
          }

      // dQ += dS K
      mma_xb_3xtf32<DP, NS, NO>(acc, dp, Kt, 0, c0, gq, t);
    }
    __syncthreads();  // stage st is free for tile kt + 2
  }
  mml::cp_async_wait<0>();

  const long long row0 = static_cast<long long>(q0) + wr + gq;
  store_rows_f32<NO>(dq + (static_cast<long long>(b) * a.Lq * a.H + h) * D,
                     row0, row0 + 8, a.H, D, c0, t, acc, row0 < a.Lq,
                     row0 + 8 < a.Lq);
}

template <int DP>
__global__ void __launch_bounds__(NT32)
    flash_dkv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlt, float* __restrict__ dk,
                     float* __restrict__ dv, Args a, int vec) {
  using C = DkvCfg<DP>;
  constexpr int NT = NT32, BM = BKV32, BN = C::BN;
  constexpr int DPW = DP / 2;  // output columns of one warp
  constexpr int NO = DPW / 8;  // n8 tiles of a warp's dK and dV rows
  constexpr int QS = 16;       // queries of a slice of the Q tile
  constexpr int NS = QS / 8;   // n8 tiles of a warp's S^T rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // (BM, DP)
  float* Vs = Ks + BM * DP;                         // (BM, DP)
  float* Qs = Vs + BM * DP;                         // 2 stages of (BN, DP)
  float* Gs = Qs + 2 * BN * DP;                     // 2 stages of (BN, DP)
  float* Ls = Gs + 2 * BN * DP;                     // 2 x BN: LSE
  float* Ds = Ls + 2 * BN;                          // 2 x BN: delta
  float* Xs = Ds + 2 * BN;                          // exchanged fragments

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.x * BM;  // causal: the first tiles are heaviest
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int kg = warp & 3;     // the warp's 16-key group
  const int role = warp >> 2;  // 0: S^T and P^T, 1: dP^T; output half
  const int kr = kg * 16;      // the group's first key in the block
  const int c0 = role * DPW;   // the warp's first output column

  const float* qb = q + b * a.qsb + h * a.qsh;
  const float* kb = k + b * a.ksb + h * a.ksh;
  const float* vb = v + b * a.vsb + h * a.vsh;
  const float* gb = g + b * a.gsb + h * a.gsh;
  const float* lse_b = lse + static_cast<long long>(bh) * a.Lq;
  const float* dlt_b = dlt + static_cast<long long>(bh) * a.Lq;

  const int nq = (a.Lq + BN - 1) / BN;
  int qt0 = 0;
  if (a.causal) {
    // Q tile qt is fully masked when k0 + k_off > qt*BN + BN - 1 + q_off
    const long long need =
        static_cast<long long>(k0) + a.k_off - a.q_off - (BN - 1);
    qt0 = need <= 0 ? 0
                    : static_cast<int>(min(static_cast<long long>(nq),
                                           (need + BN - 1) / BN));
  }

  // the Q tile qt into ring stage st: Q, dO, LSE, delta
  auto stage_q = [&](int qt, int st) {
    const int r0 = qt * BN;
    mml::stage_tile_swz<BN, DP, NT>(Qs + st * BN * DP, qb, a.qsl, r0, a.Lq,
                                    D, vec);
    mml::stage_tile_swz<BN, DP, NT>(Gs + st * BN * DP, gb, a.gsl, r0, a.Lq,
                                    D, vec);
    for (int r = threadIdx.x; r < BN; r += NT) {
      const int row = r0 + r;
      const bool in = row < a.Lq;
      mml::cp_async4(Ls + st * BN + r, in ? lse_b + row : lse_b, in);
      mml::cp_async4(Ds + st * BN + r, in ? dlt_b + row : dlt_b, in);
    }
  };

  mml::stage_tile_swz<BM, DP, NT>(Ks, kb, a.ksl, k0, a.Lk, D, vec);
  mml::stage_tile_swz<BM, DP, NT>(Vs, vb, a.vsl, k0, a.Lk, D, vec);
  if (qt0 < nq) stage_q(qt0, 0);
  mml::cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  // the first query position that reaches the group's first key (causal)
  const long long kfirst =
      static_cast<long long>(k0) + kr + a.k_off - a.q_off;
  const bool keys_in = k0 + kr < a.Lk;
  int n_xch = 0;  // slices the pair has exchanged: the buffer's parity

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nq) stage_q(qt + 1, st ^ 1);
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile qt (and K, V) landed
    __syncthreads();
    const float* Qt = Qs + st * BN * DP;
    const float* Gt = Gs + st * BN * DP;
    const float* Lt = Ls + st * BN;
    const float* Dt = Ds + st * BN;
    const int q0 = qt * BN;

#pragma unroll 1
    for (int qh = 0; qh < BN; qh += QS) {
      const int qs0 = q0 + qh;
      // the slice's queries see none of the group's keys (both warps of
      // the pair skip alike)
      if (!keys_in || qs0 >= a.Lq ||
          (a.causal && static_cast<long long>(qs0) + QS - 1 < kfirst))
        continue;

      // role 0: S^T = K Q^T, then P^T = valid ? exp(S^T * scale - LSE_q)
      // : 0; role 1: dP^T = V dO^T; 16 keys x QS queries. The thread's
      // keys are kr + g (hr 0) and kr + g + 8 (hr 1), its queries
      // qh + nt*8 + 2t + e.
      float x[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
      if (role == 0) {
        mma_abt_3xtf32<DP, NS>(x, Ks, kr, Qt, qh, gq, t);
        const bool full =
            qs0 + QS <= a.Lq && k0 + kr + 16 <= a.Lk &&
            (!a.causal || static_cast<long long>(qs0) >= kfirst + 15);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = qh + nt * 8 + 2 * t + e;
              float& y = x[nt][2 * hr + e];
              y = full || is_valid(a, q0 + c, k0 + kr + gq + 8 * hr)
                      ? expf(y * a.scale - Lt[c])
                      : 0.f;
            }
      } else {
        mma_abt_3xtf32<DP, NS>(x, Vs, kr, Gt, qh, gq, t);
      }
      // hand the fragment to the other warp of the pair and take its own
      float* xo = Xs + ((kg * 2 + role) * 2 + (n_xch & 1)) * C::XF;
      const float* xi =
          Xs + ((kg * 2 + (role ^ 1)) * 2 + (n_xch & 1)) * C::XF;
      ++n_xch;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        *reinterpret_cast<float4*>(xo + nt * 128 + 4 * lane) =
            make_float4(x[nt][0], x[nt][1], x[nt][2], x[nt][3]);
      bar_sync(1 + kg, 64);
      float pt[NS][4], ds[NS][4];  // P^T and dS^T
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float4 y =
            *reinterpret_cast<const float4*>(xi + nt * 128 + 4 * lane);
        const float o[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pt[nt][e] = role == 0 ? x[nt][e] : o[e];
          ds[nt][e] = role == 0 ? o[e] : x[nt][e];
        }
      }
      // dS^T = P^T o (dP^T - delta_q) * scale
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = qh + nt * 8 + 2 * t + e;
            float& y = ds[nt][2 * hr + e];
            y = pt[nt][2 * hr + e] * (y - Dt[c]) * a.scale;
          }

      // the warp's half of the columns: dV += P^T dO, dK += dS^T Q
      mma_xb_3xtf32<DP, NS, NO>(dva, pt, Gt, qh, c0, gq, t);
      mma_xb_3xtf32<DP, NS, NO>(dka, ds, Qt, qh, c0, gq, t);
    }
    __syncthreads();  // stage st is free for tile qt + 2
  }
  mml::cp_async_wait<0>();

  const long long row0 = static_cast<long long>(k0) + kr + gq;
  const long long base = static_cast<long long>(b) * a.Lk * a.H + h;
  store_rows_f32<NO>(dk + base * D, row0, row0 + 8, a.H, D, c0, t, dka,
                     row0 < a.Lk, row0 + 8 < a.Lk);
  store_rows_f32<NO>(dv + base * D, row0, row0 + 8, a.H, D, c0, t, dva,
                     row0 < a.Lk, row0 + 8 < a.Lk);
}

// 16-byte staging (the kernels' vec argument): every row of q, k, v and dO
// 16-byte aligned and D a whole number of 16-byte chunks.
template <typename T>
int vec16(const T* q, const T* k, const T* v, const T* g, const Args& a) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const long long strides = a.qsb | a.qsl | a.qsh | a.ksb | a.ksl | a.ksh |
                            a.vsb | a.vsl | a.vsh | a.gsb | a.gsl | a.gsh;
  return ptrs % 16 == 0 && strides % E == 0 && a.D % E == 0;
}

template <int DP, int NSPLIT>
int launch_dq_tf32_dp(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* dlt,
                      float* dq, int B, const Args& a, int vec,
                      cudaStream_t stream, int* occ) {
  using C = DqCfg<DP, NSPLIT>;
  const cudaError_t err =
      mml::opt_in(flash_dq_tf32x3<DP, NSPLIT>, NT32, C::kSmem, occ);
  if (err != cudaSuccess || occ) return static_cast<int>(err);
  const dim3 grid((a.Lq + C::BM - 1) / C::BM, B * a.H);
  flash_dq_tf32x3<DP, NSPLIT><<<grid, NT32, C::kSmem, stream>>>(
      q, k, v, g, lse, dlt, dq, a, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv_tf32_dp(const float* q, const float* k, const float* v,
                       const float* g, const float* lse, const float* dlt,
                       float* dk, float* dv, int B, const Args& a, int vec,
                       cudaStream_t stream, int* occ) {
  constexpr size_t smem = DkvCfg<DP>::kSmem;
  const cudaError_t err = mml::opt_in(flash_dkv_tf32x3<DP>, NT32, smem, occ);
  if (err != cudaSuccess || occ) return static_cast<int>(err);
  const dim3 grid((a.Lk + BKV32 - 1) / BKV32, B * a.H);
  flash_dkv_tf32x3<DP><<<grid, NT32, smem, stream>>>(q, k, v, g, lse, dlt,
                                                     dk, dv, a, vec);
  return static_cast<int>(cudaGetLastError());
}

// One kernel for every float32 shape: DP = D rounded up to 32, 64, 128,
// 160 or 256, two warps per 16-row group above 128; 16-byte staging where
// every row is 16-byte aligned and D % 4 == 0, element-wise staging
// otherwise. With occ, the kernel's blocks per SM and shared memory
// instead of a launch (mml::opt_in).
int launch_dq_tf32(const float* q, const float* k, const float* v,
                   const float* g, const float* lse, const float* dlt,
                   float* dq, int B, const Args& a, cudaStream_t stream,
                   int* occ = nullptr) {
  const int vec = vec16(q, k, v, g, a);
#define MML_DQ32(P, S) \
  launch_dq_tf32_dp<P, S>(q, k, v, g, lse, dlt, dq, B, a, vec, stream, occ)
  if (a.D <= 32) return MML_DQ32(32, 1);
  if (a.D <= 64) return MML_DQ32(64, 1);
  if (a.D <= 128) return MML_DQ32(128, 1);
  if (a.D <= 160) return MML_DQ32(160, 2);
  if (a.D <= 256) return MML_DQ32(256, 2);
#undef MML_DQ32
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dkv_tf32(const float* q, const float* k, const float* v,
                    const float* g, const float* lse, const float* dlt,
                    float* dk, float* dv, int B, const Args& a,
                    cudaStream_t stream, int* occ = nullptr) {
  const int vec = vec16(q, k, v, g, a);
#define MML_DKV32(P) \
  launch_dkv_tf32_dp<P>(q, k, v, g, lse, dlt, dk, dv, B, a, vec, stream, occ)
  if (a.D <= 32) return MML_DKV32(32);
  if (a.D <= 64) return MML_DKV32(64);
  if (a.D <= 128) return MML_DKV32(128);
  if (a.D <= 160) return MML_DKV32(160);
  if (a.D <= 256) return MML_DKV32(256);
#undef MML_DKV32
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------- flash_dkv, bf16 (mma)
constexpr int BKV16 = 64;  // keys per block of flash_dkv_bf16

size_t dkv_bf16_smem_bytes(int dp) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(2 * BKV16 + 4 * BQ) *
             (dp + 8) +
         sizeof(float) * 4 * BQ;
}

// DP: the head dim padded with zeros to a multiple of 16 (32, 64, 128,
// 160 or 256); NSPLIT: warps sharing a 16-key group's output columns.
template <int DP, int NSPLIT>
__global__ void __launch_bounds__(128 * NSPLIT)
    flash_dkv_bf16(const mml::bf16* __restrict__ q,
                   const mml::bf16* __restrict__ k,
                   const mml::bf16* __restrict__ v,
                   const mml::bf16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ dlt, mml::bf16* __restrict__ dk,
                   mml::bf16* __restrict__ dv, Args a, int vec) {
  using mml::bf16;
  constexpr int NT = 128 * NSPLIT;
  constexpr int LD = DP + 8;      // row stride of the shared tiles
  constexpr int NKS = DP / 16;    // k16 steps of S^T and dP^T
  constexpr int DPW = DP / NSPLIT;  // output columns of one warp
  constexpr int NO = DPW / 8;     // n8 tiles of a warp's dK and dV rows
  constexpr int QS = 32;          // queries of a half of the Q tile
  constexpr int NS = QS / 8;      // n8 tiles of a warp's S^T rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // (BKV16, LD)
  bf16* Vs = Ks + BKV16 * LD;                     // (BKV16, LD)
  bf16* Qs = Vs + BKV16 * LD;                     // 2 stages of (BQ, LD)
  bf16* Gs = Qs + 2 * BQ * LD;                    // 2 stages of (BQ, LD): dO
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // 2 x BQ: LSE
  float* Ds = Ls + 2 * BQ;                                 // 2 x BQ: delta

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = blockIdx.x * BKV16;  // causal: the first tiles are heaviest
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int kr = (warp & 3) * 16;        // the warp's first key in the block
  const int c0 = (warp >> 2) * DPW;      // the warp's first output column

  const bf16* qb = q + b * a.qsb + h * a.qsh;
  const bf16* kb = k + b * a.ksb + h * a.ksh;
  const bf16* vb = v + b * a.vsb + h * a.vsh;
  const bf16* gb = g + b * a.gsb + h * a.gsh;
  const float* lse_b = lse + static_cast<long long>(bh) * a.Lq;
  const float* dlt_b = dlt + static_cast<long long>(bh) * a.Lq;

  const int nq = (a.Lq + BQ - 1) / BQ;
  int qt0 = 0;
  if (a.causal) {
    // Q tile qt is fully masked when k0 + k_off > qt*BQ + BQ - 1 + q_off
    const long long need =
        static_cast<long long>(k0) + a.k_off - a.q_off - (BQ - 1);
    qt0 = need <= 0 ? 0
                    : static_cast<int>(min(static_cast<long long>(nq),
                                           (need + BQ - 1) / BQ));
  }

  // the Q tile qt into ring stage st: Q, dO, LSE, delta
  auto stage_q = [&](int qt, int st) {
    const int r0 = qt * BQ;
    mml::stage_tile<BQ, DP, LD, NT>(Qs + st * BQ * LD, qb, a.qsl, r0, a.Lq,
                                    D, vec);
    mml::stage_tile<BQ, DP, LD, NT>(Gs + st * BQ * LD, gb, a.gsl, r0, a.Lq,
                                    D, vec);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const int row = r0 + r;
      const bool in = row < a.Lq;
      mml::cp_async4(Ls + st * BQ + r, in ? lse_b + row : lse_b, in);
      mml::cp_async4(Ds + st * BQ + r, in ? dlt_b + row : dlt_b, in);
    }
  };

  mml::stage_tile<BKV16, DP, LD, NT>(Ks, kb, a.ksl, k0, a.Lk, D, vec);
  mml::stage_tile<BKV16, DP, LD, NT>(Vs, vb, a.vsl, k0, a.Lk, D, vec);
  if (qt0 < nq) stage_q(qt0, 0);
  mml::cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nq) stage_q(qt + 1, st ^ 1);
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile qt (and K, V) landed
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* Gt = Gs + st * BQ * LD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    const int q0 = qt * BQ;

    // two halves of QS queries each, so that S^T and dP^T of a half
    // (2 x 16 floats a thread) fit beside dK and dV without spilling
    const bool full =
        q0 + BQ <= a.Lq && k0 + kr + 16 <= a.Lk &&
        (!a.causal || static_cast<long long>(q0) + a.q_off >=
                          static_cast<long long>(k0) + kr + 15 + a.k_off);
#pragma unroll 1
    for (int qh = 0; qh < BQ; qh += QS) {
      // S^T = K Q^T (unscaled), 16 keys x QS queries per warp
      float s[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t af[4];
        mml::ldmatrix_x4(af, mml::a_addr(Ks, LD, kr, ks * 16, lane));
#pragma unroll
        for (int nb = 0; nb < NS / 2; ++nb) {
          uint32_t bf[4];
          mml::ldmatrix_x4(bf,
                           mml::b_addr(Qt, LD, qh + nb * 16, ks * 16, lane));
          mml::mma_bf16(s[2 * nb], af, bf[0], bf[1]);
          mml::mma_bf16(s[2 * nb + 1], af, bf[2], bf[3]);
        }
      }

      // P^T = valid ? exp(S^T * scale - LSE_q) : 0; the thread's keys are
      // kr + gq (hr 0) and kr + gq + 8 (hr 1), its queries nt*8 + 2t + e
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * t + e;
            float& x = s[nt][2 * hr + e];
            x = full || is_valid(a, q0 + qh + c, k0 + kr + gq + 8 * hr)
                    ? expf(x * a.scale - Lt[qh + c])
                    : 0.f;
          }

      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t ph[4], pl[4];
        mml::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
        for (int nb = 0; nb < NO / 2; ++nb) {
          uint32_t bf[4];
          mml::ldmatrix_x4_trans(
              bf, mml::bt_addr(Gt, LD, qh + kk * 16, c0 + nb * 16, lane));
          mml::mma_bf16(dva[2 * nb], ph, bf[0], bf[1]);
          mml::mma_bf16(dva[2 * nb], pl, bf[0], bf[1]);
          mml::mma_bf16(dva[2 * nb + 1], ph, bf[2], bf[3]);
          mml::mma_bf16(dva[2 * nb + 1], pl, bf[2], bf[3]);
        }
      }

      // dP^T = V dO^T
      float dp[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        uint32_t af[4];
        mml::ldmatrix_x4(af, mml::a_addr(Vs, LD, kr, ks * 16, lane));
#pragma unroll
        for (int nb = 0; nb < NS / 2; ++nb) {
          uint32_t bf[4];
          mml::ldmatrix_x4(bf,
                           mml::b_addr(Gt, LD, qh + nb * 16, ks * 16, lane));
          mml::mma_bf16(dp[2 * nb], af, bf[0], bf[1]);
          mml::mma_bf16(dp[2 * nb + 1], af, bf[2], bf[3]);
        }
      }

      // dS^T = P^T o (dP^T - delta_q) * scale, in place of dP^T
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * t + e;
            float& x = dp[nt][2 * hr + e];
            x = s[nt][2 * hr + e] * (x - Dt[qh + c]) * a.scale;
          }

      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t dh[4], dl[4];
        mml::split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
        for (int nb = 0; nb < NO / 2; ++nb) {
          uint32_t bf[4];
          mml::ldmatrix_x4_trans(
              bf, mml::bt_addr(Qt, LD, qh + kk * 16, c0 + nb * 16, lane));
          mml::mma_bf16(dka[2 * nb], dh, bf[0], bf[1]);
          mml::mma_bf16(dka[2 * nb], dl, bf[0], bf[1]);
          mml::mma_bf16(dka[2 * nb + 1], dh, bf[2], bf[3]);
          mml::mma_bf16(dka[2 * nb + 1], dl, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for tile qt + 2
  }
  mml::cp_async_wait<0>();

  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = k0 + kr + gq + 8 * hr;
    if (row >= a.Lk) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Lk + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = c0 + i * 8 + 2 * t;
      const float k0v = dka[i][2 * hr], k1v = dka[i][2 * hr + 1];
      const float v0v = dva[i][2 * hr], v1v = dva[i][2 * hr + 1];
      if (pairs && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
            __floats2bfloat162_rn(k0v, k1v);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
            __floats2bfloat162_rn(v0v, v1v);
      } else {
        if (c < D) {
          dk[at + c] = __float2bfloat16(k0v);
          dv[at + c] = __float2bfloat16(v0v);
        }
        if (c + 1 < D) {
          dk[at + c + 1] = __float2bfloat16(k1v);
          dv[at + c + 1] = __float2bfloat16(v1v);
        }
      }
    }
  }
}

template <int DP, int NSPLIT>
int launch_dkv_bf16_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* g,
                       const float* lse, const float* dlt, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, int B, const Args& a, int vec,
                       cudaStream_t stream) {
  const size_t smem = dkv_bf16_smem_bytes(DP);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      mml::opt_in(flash_dkv_bf16<DP, NSPLIT>, 128 * NSPLIT, smem, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + BKV16 - 1) / BKV16, B * a.H);
  flash_dkv_bf16<DP, NSPLIT><<<grid, 128 * NSPLIT, smem, stream>>>(
      q, k, v, g, lse, dlt, dk, dv, a, vec);
  return static_cast<int>(cudaGetLastError());
}

// One kernel for every bf16 shape: DP = D rounded up to 32, 64, 128, 160
// or 256, two warps per 16-key group above 128; 16-byte staging where every
// row is 16-byte aligned, element-wise staging otherwise.
int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const __nv_bfloat16* g,
                    const float* lse, const float* dlt, __nv_bfloat16* dk,
                    __nv_bfloat16* dv, int B, const Args& a,
                    cudaStream_t stream) {
  const int vec = vec16(q, k, v, g, a);
#define MML_DKV16(P, S) \
  launch_dkv_bf16_dp<P, S>(q, k, v, g, lse, dlt, dk, dv, B, a, vec, stream)
  if (a.D <= 32) return MML_DKV16(32, 1);
  if (a.D <= 64) return MML_DKV16(64, 1);
  if (a.D <= 128) return MML_DKV16(128, 1);
  if (a.D <= 160) return MML_DKV16(160, 2);
  if (a.D <= 256) return MML_DKV16(256, 2);
#undef MML_DKV16
  return static_cast<int>(cudaErrorInvalidValue);
}

// ----------------------------------------------------- flash_dq, bf16 (mma)
constexpr int BKQ16 = 32;  // keys per KV tile of flash_dq_bf16

size_t dq_bf16_smem_bytes(int dp) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(2 * BQ + 4 * BKQ16) *
         (dp + 8);
}

// DP: the head dim padded with zeros to a multiple of 16 (32, 64, 128,
// 160 or 256); NSPLIT: warps sharing a 16-row group's output columns.
template <int DP, int NSPLIT>
__global__ void __launch_bounds__(128 * NSPLIT)
    flash_dq_bf16(const mml::bf16* __restrict__ q,
                  const mml::bf16* __restrict__ k,
                  const mml::bf16* __restrict__ v,
                  const mml::bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ dlt, mml::bf16* __restrict__ dq,
                  Args a, int vec) {
  using mml::bf16;
  constexpr int NT = 128 * NSPLIT;
  constexpr int LD = DP + 8;        // row stride of the shared tiles
  constexpr int NKS = DP / 16;      // k16 steps of S and dP
  constexpr int DPW = DP / NSPLIT;  // output columns of one warp
  constexpr int NO = DPW / 8;       // n8 tiles of a warp's dQ rows
  constexpr int NS = BKQ16 / 8;     // n8 tiles of a warp's S and dP rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ, LD)
  bf16* Gs = Qs + BQ * LD;                        // (BQ, LD): dO
  bf16* Ks = Gs + BQ * LD;                        // 2 stages of (BKQ16, LD)
  bf16* Vs = Ks + 2 * BKQ16 * LD;                 // 2 stages of (BKQ16, LD)

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BQ;
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp & 3) * 16;    // the warp's first row in the Q tile
  const int c0 = (warp >> 2) * DPW;  // the warp's first output column

  const bf16* qb = q + b * a.qsb + h * a.qsh;
  const bf16* kb = k + b * a.ksb + h * a.ksh;
  const bf16* vb = v + b * a.vsb + h * a.vsh;
  const bf16* gb = g + b * a.gsb + h * a.gsh;

  int n_kv = (a.Lk + BKQ16 - 1) / BKQ16;
  if (a.causal) {
    // tile kt is fully masked when kt*BKQ16 + k_off > q0 + BQ - 1 + q_off
    const long long last =
        static_cast<long long>(q0) + BQ - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BKQ16) + 1;
    n_kv = min(n_kv, n_c);
  }

  mml::stage_tile<BQ, DP, LD, NT>(Qs, qb, a.qsl, q0, a.Lq, D, vec);
  mml::stage_tile<BQ, DP, LD, NT>(Gs, gb, a.gsl, q0, a.Lq, D, vec);
  if (n_kv > 0) {
    mml::stage_tile<BKQ16, DP, LD, NT>(Ks, kb, a.ksl, 0, a.Lk, D, vec);
    mml::stage_tile<BKQ16, DP, LD, NT>(Vs, vb, a.vsl, 0, a.Lk, D, vec);
  }
  mml::cp_async_commit();

  // LSE and delta of the thread's rows g (hr 0) and g + 8 (hr 1); a row
  // past Lq reads 0 for both, and its zero Q and dO then give dS = 0
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + gq + 8 * hr;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse_r[hr] = row < a.Lq ? lse[at] : 0.f;
    dlt_r[hr] = row < a.Lq ? dlt[at] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // global position of the thread's first row
  const long long qpos0 = static_cast<long long>(q0) + wr + gq + a.q_off;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * BKQ16;
      mml::stage_tile<BKQ16, DP, LD, NT>(Ks + (st ^ 1) * BKQ16 * LD, kb,
                                         a.ksl, k1, a.Lk, D, vec);
      mml::stage_tile<BKQ16, DP, LD, NT>(Vs + (st ^ 1) * BKQ16 * LD, vb,
                                         a.vsl, k1, a.Lk, D, vec);
    }
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile kt (and Q, dO) landed
    __syncthreads();
    const bf16* Kt = Ks + st * BKQ16 * LD;
    const bf16* Vt = Vs + st * BKQ16 * LD;

    // S = Q K^T (unscaled) and dP = dO V^T, 16 x 32 per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t qf[4], gf[4];
      mml::ldmatrix_x4(qf, mml::a_addr(Qs, LD, wr, ks * 16, lane));
      mml::ldmatrix_x4(gf, mml::a_addr(Gs, LD, wr, ks * 16, lane));
#pragma unroll
      for (int nb = 0; nb < NS / 2; ++nb) {
        uint32_t kf[4], vf[4];
        mml::ldmatrix_x4(kf, mml::b_addr(Kt, LD, nb * 16, ks * 16, lane));
        mml::ldmatrix_x4(vf, mml::b_addr(Vt, LD, nb * 16, ks * 16, lane));
        mml::mma_bf16(s[2 * nb], qf, kf[0], kf[1]);
        mml::mma_bf16(s[2 * nb + 1], qf, kf[2], kf[3]);
        mml::mma_bf16(dp[2 * nb], gf, vf[0], vf[1]);
        mml::mma_bf16(dp[2 * nb + 1], gf, vf[2], vf[3]);
      }
    }

    // P = valid ? exp(S * scale - LSE) : 0, dS = P o (dP - delta) * scale
    // in place of dP; the thread's keys are k0 + nt*8 + 2t + e
    const int k0 = kt * BKQ16;
    const bool full =
        k0 + BKQ16 <= a.Lk &&
        (!a.causal || static_cast<long long>(q0) + wr + a.q_off >=
                          static_cast<long long>(k0) + BKQ16 - 1 + a.k_off);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + nt * 8 + 2 * t + e;
          const bool ok =
              full || (kpos < a.Lk &&
                       (!a.causal || qpos0 + 8 * hr >=
                                         static_cast<long long>(kpos) +
                                             a.k_off));
          const float p =
              ok ? expf(s[nt][2 * hr + e] * a.scale - lse_r[hr]) : 0.f;
          float& x = dp[nt][2 * hr + e];
          x = p * (x - dlt_r[hr]) * a.scale;
        }

    // dQ += dS K, dS from registers as hi + lo bf16
#pragma unroll
    for (int kk = 0; kk < BKQ16 / 16; ++kk) {
      uint32_t dh[4], dl[4];
      mml::split_a(dp[2 * kk], dp[2 * kk + 1], dh, dl);
#pragma unroll
      for (int nb = 0; nb < NO / 2; ++nb) {
        uint32_t bf[4];
        mml::ldmatrix_x4_trans(
            bf, mml::bt_addr(Kt, LD, kk * 16, c0 + nb * 16, lane));
        mml::mma_bf16(acc[2 * nb], dh, bf[0], bf[1]);
        mml::mma_bf16(acc[2 * nb], dl, bf[0], bf[1]);
        mml::mma_bf16(acc[2 * nb + 1], dh, bf[2], bf[3]);
        mml::mma_bf16(acc[2 * nb + 1], dl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage st is free for tile kt + 2
  }
  mml::cp_async_wait<0>();

  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + gq + 8 * hr;
    if (row >= a.Lq) continue;
    bf16* orow =
        dq + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = c0 + i * 8 + 2 * t;
      const float x0 = acc[i][2 * hr], x1 = acc[i][2 * hr + 1];
      if (pairs && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) orow[c] = __float2bfloat16(x0);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP, int NSPLIT>
int launch_dq_bf16_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, const __nv_bfloat16* g,
                      const float* lse, const float* dlt, __nv_bfloat16* dq,
                      int B, const Args& a, int vec, cudaStream_t stream,
                      int* occ) {
  const size_t smem = dq_bf16_smem_bytes(DP);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      mml::opt_in(flash_dq_bf16<DP, NSPLIT>, 128 * NSPLIT, smem, occ);
  if (err != cudaSuccess || occ) return static_cast<int>(err);
  const dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_dq_bf16<DP, NSPLIT><<<grid, 128 * NSPLIT, smem, stream>>>(
      q, k, v, g, lse, dlt, dq, a, vec);
  return static_cast<int>(cudaGetLastError());
}

// One kernel for every bf16 shape, as launch_dkv_bf16 chooses it. With
// occ, its blocks per SM and shared memory instead of a launch
// (mml::opt_in).
int launch_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, const __nv_bfloat16* g,
                   const float* lse, const float* dlt, __nv_bfloat16* dq,
                   int B, const Args& a, cudaStream_t stream,
                   int* occ = nullptr) {
  const int vec = vec16(q, k, v, g, a);
#define MML_DQ16(P, S) \
  launch_dq_bf16_dp<P, S>(q, k, v, g, lse, dlt, dq, B, a, vec, stream, occ)
  if (a.D <= 32) return MML_DQ16(32, 1);
  if (a.D <= 64) return MML_DQ16(64, 1);
  if (a.D <= 128) return MML_DQ16(128, 1);
  if (a.D <= 160) return MML_DQ16(160, 2);
  if (a.D <= 256) return MML_DQ16(256, 2);
#undef MML_DQ16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns the cudaError_t of
// its launch (0 on success). q and g (dO) are (B, Lq, H, D), k and v
// (B, Lk, H, D), each with unit stride along D and the given element
// strides along batch, sequence and head; lse and delta are contiguous
// (B, H, Lq) float32; dq is a contiguous (B, Lq, H, D) tensor, dk and dv
// contiguous (B, Lk, H, D) tensors, all of the inputs' type. Needs
// 1 <= D <= 256, Lq >= 1, Lk >= 1, B * H in [1, 65535].
extern "C" {

#define MML_ARGS                                                           \
  int B, int H, int Lq, int Lk, int D, long long qsb, long long qsl,       \
      long long qsh, long long ksb, long long ksl, long long ksh,          \
      long long vsb, long long vsl, long long vsh, long long gsb,          \
      long long gsl, long long gsh, float scale, int causal, int q_off,    \
      int k_off, void *stream
#define MML_PACK                                                          \
  const Args a{H,   Lq,  Lk,  D,   qsb, qsl,   qsh,    ksb,   ksl, ksh, \
               vsb, vsl, vsh, gsb, gsl, gsh, scale, causal, q_off, k_off}

int mml_flash_dq_f32(const float* q, const float* k, const float* v,
                     const float* g, const float* lse, const float* dlt,
                     float* dq, MML_ARGS) {
  MML_PACK;
  return launch_dq_tf32(q, k, v, g, lse, dlt, dq, B, a,
                        static_cast<cudaStream_t>(stream));
}

int mml_flash_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, const __nv_bfloat16* g,
                      const float* lse, const float* dlt, __nv_bfloat16* dq,
                      MML_ARGS) {
  MML_PACK;
  return launch_dq_bf16(q, k, v, g, lse, dlt, dq, B, a,
                        static_cast<cudaStream_t>(stream));
}

int mml_flash_dkv_f32(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* dlt,
                      float* dk, float* dv, MML_ARGS) {
  MML_PACK;
  return launch_dkv_tf32(q, k, v, g, lse, dlt, dk, dv, B, a,
                         static_cast<cudaStream_t>(stream));
}

int mml_flash_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* g,
                       const float* lse, const float* dlt,
                       __nv_bfloat16* dk, __nv_bfloat16* dv, MML_ARGS) {
  MML_PACK;
  return launch_dkv_bf16(q, k, v, g, lse, dlt, dk, dv, B, a,
                         static_cast<cudaStream_t>(stream));
}

#undef MML_ARGS
#undef MML_PACK

// Blocks of a kernel for head dim D that fit on one SM, and its dynamic
// shared memory (occ[0], occ[1]). Each returns the cudaError_t.
int mml_flash_dq_bf16_occupancy(int D, int* occ) {
  Args a{};
  a.D = D;
  return launch_dq_bf16(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 0, a, nullptr, occ);
}

int mml_flash_dq_f32_occupancy(int D, int* occ) {
  Args a{};
  a.D = D;
  return launch_dq_tf32(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 0, a, nullptr, occ);
}

int mml_flash_dkv_f32_occupancy(int D, int* occ) {
  Args a{};
  a.D = D;
  return launch_dkv_tf32(nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, 0, a, nullptr, occ);
}

}  // extern "C"
