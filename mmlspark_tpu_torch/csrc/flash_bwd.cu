// Flash-attention backward for Hopper (sm_90a): two kernels.
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
//     parallel: a flash_dq block owns one (batch*head, 64-row Q tile) and
//     loops over KV tiles; a flash_dkv block owns one (batch*head, key tile)
//     and loops over Q tiles. No block writes another's rows: no atomics,
//     so two launches are bitwise equal.
//   * Causal skipping as _fully_masked does it: flash_dq stops before the
//     first KV tile above the diagonal; flash_dkv starts at the first Q tile
//     whose last row reaches the key tile's first key.
//   * No padding: the TPU's padded Q rows carry dO = 0 and delta = 0 and
//     cancel out. Here the kernels read q / k / v / dO in place through
//     their (batch, sequence, head) strides (q / k / v are views of one
//     (B, L, 3*dim) projection), stage ragged tails as zeros and mask query
//     rows >= Lq and keys >= Lk themselves. dq / dk / dv are written as
//     fresh contiguous (B, L, H, D) tensors in the inputs' type.
//   * Every product accumulates in f32; bf16 is rounded once, at the store.
//
// Layout of the work: 256 threads as a 16 x 16 grid, (tr, tc).
//   flash_dq: thread (tr, tc) owns query rows tr + 16*i (i < 4), score
//     columns tc + 16*j (j < 4) of each 64-key tile and output columns
//     tc + 16*jj (jj < NJ, 16*NJ >= D); dQ accumulates in registers
//     (4 x NJ floats). Shared memory: Q and dO tiles (64 x (D+1) f32 each,
//     staged once), one KV buffer (64 x (D+1)) that holds V for dP, then K
//     for S and dQ, and the 64 x 65 dS tile: 115.7 KB at D = 128 (one block
//     per SM), 214 KB at D = 256.
//   flash_dkv: thread (tr, tc) owns key rows tr + 16*i (i < KR, a tile of
//     16*KR keys), query columns tc + 16*j (j < 4) of each 64-row Q tile and
//     output columns tc + 16*jj; dK and dV accumulate in registers
//     (2 x KR x NJ floats: 64 at D = 128). Shared memory: K and V of the
//     block's keys (staged once), the Q and dO tiles, one (16*KR) x 65 tile
//     that holds P for dV, then dS for dK, and the tile's LSE and delta:
//     149.2 KB at D = 128 (one block per SM). KR = 4 (64 keys) while that
//     fits in 227 KB, KR = 2 (32 keys) above D = 208.
//   Row strides of D + 1 keep column reads free of bank conflicts.
//   Registers (nvcc -Xptxas -v, sm_90a): at D = 128 flash_dq<T, 8> uses
//   128 and flash_dkv<float, 8, 4> 160; the widest, flash_dkv<float, 16,
//   4>, 233; no spills. Shared memory, not registers, holds both kernels to
//   one block (8 warps) per SM. Both bodies run float32 only.
//
//   flash_dkv_bf16<DP, NSPLIT>, bfloat16, on the tensor cores
//     (mma_bf16.cuh), in the transposed orientation. A block owns 64 keys,
//     4 warps x 16 keys as the M rows, and loops over 64-row Q tiles from
//     the first causal one. K and V of the block are staged once; Q, dO and
//     the tile's LSE and delta go through a two-stage cp.async ring (tile
//     t+1's loads issued before tile t is computed). Per half of a Q tile
//     (32 queries, so that nothing spills at D = 128), all in registers:
//     S^T = K Q^T and dP^T = V dO^T by mma.sync with Q and dO's
//     (q, d) rows as the .col B operand (ldmatrix; K and V re-read from
//     shared memory with ldmatrix rather than held); P^T and dS^T on the
//     f32 fragments; dV += P^T dO and dK += dS^T Q with P^T and dS^T as A
//     fragments straight from registers, split into hi + lo bf16 halves so
//     the products keep them in f32 as the TPU kernel does, and dO and Q
//     through ldmatrix.trans. dK and dV accumulate in registers (128 floats
//     a thread at D = 128). Heads above D = 128 (DP 160, 256) run the same
//     kernel with 8 warps: each 16-key group's output columns are split
//     between two warps, which both compute S^T and dP^T. Shared memory:
//     K, V and 2 x (Q, dO) as bf16 rows of DP + 8, 103 KB at D = 128 (two
//     blocks per SM), 198 KB at D = 256. No atomics.
//
//   flash_dq_bf16<DP, NSPLIT>, bfloat16, on the tensor cores, in the
//     forward's orientation. A block owns one (batch*head, 64-row Q tile),
//     4 warps x 16 query rows, heaviest causal tiles first, and loops over
//     32-key KV tiles; a thread keeps the LSE and delta of its two rows
//     (g, g + 8) in registers. Q and dO are staged once; K and V go through
//     a two-stage cp.async ring. Per KV tile, all in registers: S = Q K^T
//     and dP = dO V^T by mma.sync with Q and dO as row A operands
//     (ldmatrix, re-read per tile rather than held, so that nothing spills
//     at D = 128) and K and V's (key, d) rows as the .col B operand; P and
//     dS on the f32 fragments; dQ += dS K with dS as the A fragment
//     straight from registers, split hi + lo so that the product keeps dS
//     in f32 as the TPU kernel does (4 products where a plain bf16 kernel
//     does 3), and K through ldmatrix.trans. Only tiles that the diagonal
//     or a ragged edge crosses pay for the per-element mask. dQ accumulates
//     in registers (64 floats a thread at D = 128); heads above D = 128 (DP
//     160, 256) split each warp-row group's output columns between two
//     warps (NSPLIT = 2), which both compute S and dP. Shared memory: Q,
//     dO and 2 x (K, V) as bf16 rows of DP + 8, 68 KB at D = 128 (three
//     blocks per SM), 132 KB at D = 256. No atomics.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: flash_dq does 6*D flops per unmasked (query, key) pair
// (51.6 GFLOP), flash_dkv 8*D (68.8 GFLOP). Under the f32 contract the
// least time is 3xTF32 on the tensor cores (495 / 3 TFLOP/s of useful
// work): 0.31 ms and 0.42 ms (0.77 and 1.03 ms on the CUDA cores at 67
// TFLOP/s), far above the ~0.1 ms needed to move their inputs and outputs
// once at 3.35 TB/s: bound by operations. In bf16 on the tensor cores
// (989 TFLOP/s) flash_dq needs 0.052 ms and flash_dkv 0.070 ms for their
// operations, above the bytes' 0.05-0.06 ms. The f32 bodies do every
// product in f32 FMA on the CUDA cores, fed by shared-memory loads; the
// bf16 kernels run their products on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;             // query rows per Q tile
constexpr int BK = 64;             // keys per KV tile of flash_dq
constexpr int TR = 16;             // thread grid rows
constexpr int TC = 16;             // thread grid columns
constexpr int RPT = BQ / TR;       // query rows per thread in flash_dq
constexpr int CPT = 4;             // score columns per thread (64 / 16)
constexpr int NTHREADS = TR * TC;  // 256
constexpr int SLD = 65;            // row stride of the score tile
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's opt-in maximum

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// Stage rows [r0, r0 + rows) of one head (rows past `limit` as zeros) into
// shared memory as f32 with row stride ld.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long sl,
                                      int r0, int rows, int limit, int D,
                                      int ld) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < limit ? to_f32(src[row * sl + d]) : 0.f;
  }
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BQ + BK) * (D + 1) + BQ * SLD);
}

size_t dkv_smem_bytes(int D, int kr) {
  const size_t bkv = static_cast<size_t>(TR) * kr;
  return sizeof(float) *
         ((2 * bkv + 2 * BQ) * (D + 1) + bkv * SLD + 2 * BQ);
}

// ---------------------------------------------------------------- flash_dq
template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
    flash_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ dlt,
             T* __restrict__ dq, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int ld = D + 1;
  float* Qs = smem;            // (BQ, ld)
  float* Gs = Qs + BQ * ld;    // (BQ, ld): dO
  float* KVs = Gs + BQ * ld;   // (BK, ld): V for dP, then K for S and dQ
  float* Ss = KVs + BK * ld;   // (BQ, SLD): dS

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BQ;
  const int tr = threadIdx.x / TC;
  const int tc = threadIdx.x - tr * TC;

  const T* qb = q + b * a.qsb + h * a.qsh;
  const T* kb = k + b * a.ksb + h * a.ksh;
  const T* vb = v + b * a.vsb + h * a.vsh;
  const T* gb = g + b * a.gsb + h * a.gsh;

  int n_kv = (a.Lk + BK - 1) / BK;
  if (a.causal) {
    // tile kt is fully masked when kt*BK + k_off > q0 + BQ - 1 + q_off
    const long long last =
        static_cast<long long>(q0) + BQ - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BK) + 1;
    n_kv = min(n_kv, n_c);
  }

  stage(Qs, qb, a.qsl, q0, BQ, a.Lq, D, ld);
  stage(Gs, gb, a.gsl, q0, BQ, a.Lq, D, ld);

  float lse_r[RPT], dlt_r[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + TR * i;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse_r[i] = row < a.Lq ? lse[at] : 0.f;
    dlt_r[i] = row < a.Lq ? dlt[at] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    stage(KVs, vb, a.vsl, k0, BK, a.Lk, D, ld);
    __syncthreads();  // V (and, on the first tile, Q and dO) staged

    float dp[RPT][CPT], s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) dp[i][j] = s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float gv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) gv[i] = Gs[(tr + TR * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = KVs[(tc + TC * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
    }
    __syncthreads();  // every thread is done with V

    stage(KVs, kb, a.ksl, k0, BK, a.Lk, D, ld);
    __syncthreads();
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr + TR * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = KVs[(tc + TC * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + tr + TR * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tc + TC * j;
        const float p = is_valid(a, qpos, kpos)
                            ? expf(s[i][j] * a.scale - lse_r[i])
                            : 0.f;
        Ss[(tr + TR * i) * SLD + tc + TC * j] =
            p * (dp[i][j] - dlt_r[i]) * a.scale;
      }
    }
    __syncthreads();  // dS is written

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = Ss[(tr + TR * i) * SLD + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tc + TC * jj;
        const float kv = d < D ? KVs[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
      }
    }
    __syncthreads();  // K and dS are free for the next tile
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + TR * i;
    if (row >= a.Lq) continue;
    T* orow = dq + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + TC * jj;
      if (d < D) store(orow + d, acc[i][jj]);
    }
  }
}

// --------------------------------------------------------------- flash_dkv
template <typename T, int NJ, int KR>
__global__ void __launch_bounds__(NTHREADS)
    flash_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ dlt,
              T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int BKV = TR * KR;  // keys per block
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int ld = D + 1;
  float* Ks = smem;             // (BKV, ld)
  float* Vs = Ks + BKV * ld;    // (BKV, ld)
  float* Qs = Vs + BKV * ld;    // (BQ, ld)
  float* Gs = Qs + BQ * ld;     // (BQ, ld): dO
  float* Ps = Gs + BQ * ld;     // (BKV, SLD): P^T for dV, then dS^T for dK
  float* Ls = Ps + BKV * SLD;   // (BQ): LSE of the Q tile
  float* Ds = Ls + BQ;          // (BQ): delta of the Q tile

  const int kt = blockIdx.x;    // causal: the first key tiles are heaviest
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * BKV;
  const int tr = threadIdx.x / TC;
  const int tc = threadIdx.x - tr * TC;

  const T* qb = q + b * a.qsb + h * a.qsh;
  const T* kb = k + b * a.ksb + h * a.ksh;
  const T* vb = v + b * a.vsb + h * a.vsh;
  const T* gb = g + b * a.gsb + h * a.gsh;
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

  stage(Ks, kb, a.ksl, k0, BKV, a.Lk, D, ld);
  stage(Vs, vb, a.vsl, k0, BKV, a.Lk, D, ld);

  float dka[KR][NJ], dva[KR][NJ];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    stage(Qs, qb, a.qsl, q0, BQ, a.Lq, D, ld);
    stage(Gs, gb, a.gsl, q0, BQ, a.Lq, D, ld);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const int row = q0 + r;
      Ls[r] = row < a.Lq ? lse_b[row] : 0.f;
      Ds[r] = row < a.Lq ? dlt_b[row] : 0.f;
    }
    __syncthreads();  // the Q tile (and, at first, K and V) staged

    float s[KR][CPT], dp[KR][CPT];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[KR], vv[KR], qv[CPT], gv[CPT];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        kv[i] = Ks[(tr + TR * i) * ld + d];
        vv[i] = Vs[(tr + TR * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        qv[j] = Qs[(tc + TC * j) * ld + d];
        gv[j] = Gs[(tc + TC * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
    // P^T into shared memory; dS^T stays in s until dV is done
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int kpos = k0 + tr + TR * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tc + TC * j;
        const float p = is_valid(a, q0 + c, kpos)
                            ? expf(s[i][j] * a.scale - Ls[c])
                            : 0.f;
        s[i][j] = p * (dp[i][j] - Ds[c]) * a.scale;
        Ps[(tr + TR * i) * SLD + c] = p;
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float pv[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) pv[i] = Ps[(tr + TR * i) * SLD + qq];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tc + TC * jj;
        const float gv = d < D ? Gs[qq * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < KR; ++i) dva[i][jj] = fmaf(pv[i], gv, dva[i][jj]);
      }
    }
    __syncthreads();  // every thread is done with P^T

#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) Ps[(tr + TR * i) * SLD + tc + TC * j] = s[i][j];
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float dsv[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) dsv[i] = Ps[(tr + TR * i) * SLD + qq];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tc + TC * jj;
        const float qv = d < D ? Qs[qq * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < KR; ++i) dka[i][jj] = fmaf(dsv[i], qv, dka[i][jj]);
      }
    }
    __syncthreads();  // Q, dO and dS^T are free for the next Q tile
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int row = k0 + tr + TR * i;
    if (row >= a.Lk) continue;
    const long long at = ((static_cast<long long>(b) * a.Lk + row) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + TC * jj;
      if (d < D) {
        store(dk + at + d, dka[i][jj]);
        store(dv + at + d, dva[i][jj]);
      }
    }
  }
}

// ----------------------------------------------------------------- launch
template <typename T, int NJ>
int launch_dq_nj(const T* q, const T* k, const T* v, const T* g,
                 const float* lse, const float* dlt, T* dq, int B,
                 const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(a.D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_dq<T, NJ><<<grid, NTHREADS, smem, stream>>>(q, k, v, g, lse, dlt, dq,
                                                    a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ, int KR>
int launch_dkv_nj(const T* q, const T* k, const T* v, const T* g,
                  const float* lse, const float* dlt, T* dk, T* dv, int B,
                  const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(a.D, KR);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv<T, NJ, KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + TR * KR - 1) / (TR * KR), B * a.H);
  flash_dkv<T, NJ, KR><<<grid, NTHREADS, smem, stream>>>(q, k, v, g, lse,
                                                         dlt, dk, dv, a);
  return static_cast<int>(cudaGetLastError());
}

// NJ = output columns per thread: the smallest instantiated NJ with
// 16 * NJ >= D (D <= 256).
template <typename T>
int launch_dq(const T* q, const T* k, const T* v, const T* g,
              const float* lse, const float* dlt, T* dq, int B,
              const Args& a, cudaStream_t stream) {
  const int nj = (a.D + TC - 1) / TC;
#define MML_DQ(N) launch_dq_nj<T, N>(q, k, v, g, lse, dlt, dq, B, a, stream)
  if (nj <= 1) return MML_DQ(1);
  if (nj <= 2) return MML_DQ(2);
  if (nj <= 4) return MML_DQ(4);
  if (nj <= 6) return MML_DQ(6);
  if (nj <= 8) return MML_DQ(8);
  if (nj <= 10) return MML_DQ(10);
  if (nj <= 12) return MML_DQ(12);
  if (nj <= 16) return MML_DQ(16);
#undef MML_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

// KR = 4 (64 keys per block) while its shared memory fits, else KR = 2
// (32 keys), which only the widest heads (NJ = 16) need.
template <typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* g,
               const float* lse, const float* dlt, T* dk, T* dv, int B,
               const Args& a, cudaStream_t stream) {
  const int nj = (a.D + TC - 1) / TC;
#define MML_DKV(N, R) \
  launch_dkv_nj<T, N, R>(q, k, v, g, lse, dlt, dk, dv, B, a, stream)
  if (nj <= 1) return MML_DKV(1, 4);
  if (nj <= 2) return MML_DKV(2, 4);
  if (nj <= 4) return MML_DKV(4, 4);
  if (nj <= 6) return MML_DKV(6, 4);
  if (nj <= 8) return MML_DKV(8, 4);
  if (nj <= 10) return MML_DKV(10, 4);
  if (nj <= 12) return MML_DKV(12, 4);
  if (nj <= 16)
    return dkv_smem_bytes(a.D, 4) <= kMaxSmem ? MML_DKV(16, 4)
                                              : MML_DKV(16, 2);
#undef MML_DKV
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
// 16-byte staging of the bf16 kernels: every row of q, k, v and dO
// 16-byte aligned and D % 8 == 0.
int bf16_vec(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, const __nv_bfloat16* g, const Args& a) {
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g);
  const long long strides = a.qsb | a.qsl | a.qsh | a.ksb | a.ksl | a.ksh |
                            a.vsb | a.vsl | a.vsh | a.gsb | a.gsl | a.gsh;
  return ptrs % 16 == 0 && strides % 8 == 0 && a.D % 8 == 0;
}

int launch_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const __nv_bfloat16* g,
                    const float* lse, const float* dlt, __nv_bfloat16* dk,
                    __nv_bfloat16* dv, int B, const Args& a,
                    cudaStream_t stream) {
  const int vec = bf16_vec(q, k, v, g, a);
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
  const int vec = bf16_vec(q, k, v, g, a);
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
  return launch_dq<float>(q, k, v, g, lse, dlt, dq, B, a,
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
  return launch_dkv<float>(q, k, v, g, lse, dlt, dk, dv, B, a,
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

// Blocks of the bf16 flash_dq kernel for head dim D that fit on one SM,
// and its dynamic shared memory (occ[0], occ[1]). Returns the cudaError_t.
int mml_flash_dq_bf16_occupancy(int D, int* occ) {
  Args a{};
  a.D = D;
  return launch_dq_bf16(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, 0, a, nullptr, occ);
}

}  // extern "C"
