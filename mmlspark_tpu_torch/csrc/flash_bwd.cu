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
//   128 and flash_dkv<T, 8, 4> 160 (f32) / 164 (bf16); the widest,
//   flash_dkv<T, 16, 4>, 233; no spills. Shared memory, not registers,
//   holds both kernels to one block (8 warps) per SM.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: flash_dq does 6*D flops per unmasked (query, key) pair
// (51.6 GFLOP), flash_dkv 8*D (68.8 GFLOP). In f32 on the CUDA cores
// (67 TFLOP/s) that is 0.77 ms and 1.03 ms, far above the ~0.1 ms needed to
// move their inputs and outputs once at 3.35 TB/s: bound by operations.
// In bf16 on the tensor cores (989 TFLOP/s) both would be bound by bytes.
// This first design does every product in f32 FMA on the CUDA cores, each
// one fed by shared-memory loads, with one block per SM; mma / wgmma on
// bf16 tiles, TMA staging and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as Tensor.to()
}

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
  return launch_dq<__nv_bfloat16>(q, k, v, g, lse, dlt, dq, B, a,
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
  return launch_dkv<__nv_bfloat16>(q, k, v, g, lse, dlt, dk, dv, B, a,
                                   static_cast<cudaStream_t>(stream));
}

#undef MML_ARGS
#undef MML_PACK

}  // extern "C"
