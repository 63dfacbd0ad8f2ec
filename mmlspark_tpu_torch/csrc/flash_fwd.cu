// Flash-attention forward for Hopper (sm_90a).
//
// Replaces mmlspark_tpu/ops/flash_attention.py::_fwd_kernel (its
// pallas_call in _flash_forward). Same function:
//
//   O[b, i, h, :] = sum_j P[i, j] V[b, j, h, :],
//   P = softmax over valid j of S,  S[i, j] = (Q[b, i, h, :] . K[b, j, h, :]) / sqrt(D)
//   LSE[b, h, i]  = m_i + log(l_i)
//
// where key j is valid when j < Lk and, in causal mode, when
// i + q_off >= j + k_off (global positions of sequence shards). The online
// softmax keeps the TPU kernel's algebra exactly:
//   m_new = max(m_prev, max_j s),  p = valid ? exp(s - m_new) : 0,
//   corr  = exp(min(m_prev - m_new, 0)),  l = l * corr + sum p,
//   acc   = acc * corr + P V,  O = acc / l_safe,  l_safe = l > 0 ? l : 1,
// so a row whose keys are all masked gives O = 0 and LSE = -1e30.
//
// What the TPU design was for, and what this one does instead:
//   * The TPU grid walks the KV blocks of one Q block in order and carries
//     (m, l, acc) in VMEM scratch across grid steps. Here one thread block
//     owns one (batch*head, 64-row Q tile) and walks the KV tiles in a loop,
//     keeping (m, l, acc) in registers. No block writes another's rows: no
//     atomics, so two launches are bitwise equal.
//   * Inputs are read in place through their (batch, sequence, head)
//     strides: the q / k / v a TransformerBlock hands over are strided views
//     of one (B, L, 3*dim) projection, and the TPU kernel's heads-major
//     transposes and Mosaic padding have no counterpart. Ragged tails are
//     masked here, not padded.
//   * KV tiles entirely above the causal diagonal are skipped, as
//     _fully_masked skips them on the TPU; the skip leaves the statistics
//     exactly as a fully masked tile would.
//   * Q tiles run heaviest first (the last causal tile sees every key), so
//     the long blocks do not trail the launch.
//
// Two bodies, one per input type.
//
// bfloat16: flash_fwd_bf16<DP>, on the tensor cores (mma_bf16.cuh). Four
// warps, each owning 16 query rows of the 64-row Q tile; KV tiles of 32
// keys. Q is staged once and its A fragments stay in registers (DP <= 128;
// wider heads re-read them with ldmatrix). K and V go through a two-stage
// cp.async ring: tile t+1's loads are issued before tile t is computed.
// S = Q K^T is mma.sync with K's (key, d) rows as the .col B operand
// (ldmatrix); the online softmax runs on the f32 accumulator fragments (a
// thread holds rows g and g+8 of its warp's 16, so a row's max and sum are
// two shuffles within a quad); P stays in registers and is the A operand
// of P V (V through ldmatrix.trans), split into hi + lo bf16 halves so the
// product keeps P in f32 as the TPU kernel does (3 mma per 2 of a plain
// bf16 kernel). exp is __expf (ex2.approx): the algebra above is kept,
// each exp within a few f32 ulps. Only tiles the diagonal or a ragged edge
// crosses pay for the per-element mask. Shared memory pads rows by 16
// bytes (conflict-free ldmatrix) and D up to DP in {32, 64, 128, 160, 256}
// with zeros: Q + 2 x (K + V) is 51 KB at D = 128, and with 168 registers
// a thread three blocks (12 warps) fit on an SM; 64-key tiles took more
// registers and allowed two. Rows that are not 16-byte aligned (or
// D % 8 != 0) are staged element-wise by the same kernel.
//
// float32: flash_fwd<float, NJ>, every product f32 FMA on the CUDA cores.
// TF32 would break the f32 contract, so f32 keeps this body. 256 threads as
// a 16 x 16 grid: thread (tr, tc) owns query rows tr + 16*i (i < 4), score
// columns tc + 16*j (j < 4) of each 64-key tile, and output columns
// tc + 16*jj (jj < NJ, NJ*16 >= D) of its rows. A row's 16 owners are the
// 16 lanes of one half-warp, so row max and row sum are 4 shuffles. Q,
// then K and V (through one shared buffer) are staged as f32 rows of
// stride D + 1 (conflict-free column reads); P goes through shared memory.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: 4*D*(unmasked pairs)*B*H = 34.4 GFLOP. In f32 on the CUDA
// cores (67 TFLOP/s) that is 0.51 ms, above the 0.08 ms needed to move
// q, k, v, O once at 3.35 TB/s: the f32 kernel is bound by operations. In
// bf16 on the tensor cores (989 TFLOP/s) it is 0.035 ms, below the 0.04 ms
// the bytes need: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per KV tile
constexpr int TR = 16;             // thread grid rows
constexpr int TC = 16;             // thread grid columns
constexpr int RPT = BQ / TR;       // query rows per thread
constexpr int CPT = BK / TC;       // score columns per thread
constexpr int NTHREADS = TR * TC;  // 256
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the half-warp of 16 lanes that owns one query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TC / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Args {
  int H, Lq, Lk, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh;
  float scale;
  int causal, q_off, k_off;
};

size_t smem_bytes(int D) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BK) * (D + 1) + BQ * (BK + 1));
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

template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  const int ld = D + 1;
  float* Qs = smem;             // (BQ, ld)
  float* KVs = Qs + BQ * ld;    // (BK, ld): K for S = QK^T, then V for PV
  float* Ps = KVs + BK * ld;    // (BQ, BK + 1)
  constexpr int PLD = BK + 1;

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

  int n_kv = (a.Lk + BK - 1) / BK;
  if (a.causal) {
    // tile kt is fully masked when kt*BK + k_off > q0 + BQ - 1 + q_off
    const long long last =
        static_cast<long long>(q0) + BQ - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BK) + 1;
    n_kv = min(n_kv, n_c);
  }

  stage(Qs, qb, a.qsl, q0, BQ, a.Lq, D, ld);

  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    stage(KVs, kb, a.ksl, k0, BK, a.Lk, D, ld);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
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
      bool valid[CPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tc + TC * j;
        valid[j] = kpos < a.Lk &&
                   (!a.causal || qpos + a.q_off >= kpos + a.k_off);
        s[i][j] = valid[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(fminf(m[i] - m_new, 0.f));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr + TR * i) * PLD + tc + TC * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // every thread is done with K; P is written

    stage(KVs, vb, a.vsl, k0, BK, a.Lk, D, ld);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr + TR * i) * PLD + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tc + TC * jj;
        const float vv = d < D ? KVs[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
    __syncthreads();  // V and P are free for the next tile
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + TR * i;
    if (row >= a.Lq) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = out + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + TC * jj;
      if (d < D) store(orow + d, acc[i][jj] / l_safe);
    }
    if (tc == 0)
      lse[static_cast<long long>(bh) * a.Lq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
int launch_nj(const T* q, const T* k, const T* v, T* out, float* lse, int B,
              const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_fwd<T, NJ><<<grid, NTHREADS, smem, stream>>>(q, k, v, out, lse, a);
  return static_cast<int>(cudaGetLastError());
}

// NJ = output columns per thread: the smallest instantiated NJ with
// 16 * NJ >= D (D <= 256).
template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, float* lse, int B,
           const Args& a, cudaStream_t stream) {
  const int nj = (a.D + TC - 1) / TC;
  if (nj <= 1) return launch_nj<T, 1>(q, k, v, out, lse, B, a, stream);
  if (nj <= 2) return launch_nj<T, 2>(q, k, v, out, lse, B, a, stream);
  if (nj <= 4) return launch_nj<T, 4>(q, k, v, out, lse, B, a, stream);
  if (nj <= 6) return launch_nj<T, 6>(q, k, v, out, lse, B, a, stream);
  if (nj <= 8) return launch_nj<T, 8>(q, k, v, out, lse, B, a, stream);
  if (nj <= 10) return launch_nj<T, 10>(q, k, v, out, lse, B, a, stream);
  if (nj <= 12) return launch_nj<T, 12>(q, k, v, out, lse, B, a, stream);
  if (nj <= 16) return launch_nj<T, 16>(q, k, v, out, lse, B, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------- bf16, tensor cores
constexpr int BQ16 = 64;          // query rows per block, 16 per warp
constexpr int BK16 = 32;          // keys per KV tile
constexpr int NT16 = 2 * BQ16;    // threads: one warp per 16 rows

size_t smem_bytes_bf16(int dp) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(BQ16 + 4 * BK16) *
         (dp + 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// DP: the head dim padded with zeros to a multiple of 16 (32, 64, 128,
// 160 or 256).
template <int DP>
__global__ void __launch_bounds__(NT16)
    flash_fwd_bf16(const mml::bf16* __restrict__ q,
                   const mml::bf16* __restrict__ k,
                   const mml::bf16* __restrict__ v, mml::bf16* __restrict__ out,
                   float* __restrict__ lse, Args a, int vec) {
  using mml::bf16;
  constexpr int LD = DP + 8;      // row stride of the shared tiles
  constexpr int NKS = DP / 16;    // k16 steps of S = Q K^T
  constexpr int NO = DP / 8;      // n8 tiles of a warp's output rows
  constexpr int NS = BK16 / 8;      // n8 tiles of a warp's score rows
  constexpr bool kQReg = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ16, LD)
  bf16* Ks = Qs + BQ16 * LD;                        // 2 stages of (BK16, LD)
  bf16* Vs = Ks + 2 * BK16 * LD;                    // 2 stages of (BK16, LD)

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * BQ16;
  const int D = a.D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the Q tile

  const bf16* qb = q + b * a.qsb + h * a.qsh;
  const bf16* kb = k + b * a.ksb + h * a.ksh;
  const bf16* vb = v + b * a.vsb + h * a.vsh;

  int n_kv = (a.Lk + BK16 - 1) / BK16;
  if (a.causal) {
    const long long last =
        static_cast<long long>(q0) + BQ16 - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BK16) + 1;
    n_kv = min(n_kv, n_c);
  }

  mml::stage_tile<BQ16, DP, NT16>(Qs, qb, a.qsl, q0, a.Lq, D, vec);
  if (n_kv > 0) {
    mml::stage_tile<BK16, DP, NT16>(Ks, kb, a.ksl, 0, a.Lk, D, vec);
    mml::stage_tile<BK16, DP, NT16>(Vs, vb, a.vsl, 0, a.Lk, D, vec);
  }
  mml::cp_async_commit();

  uint32_t qf[kQReg ? NKS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // global positions of the thread's two rows
  const long long qpos0 = static_cast<long long>(q0) + wr + g + a.q_off;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * BK16;
      mml::stage_tile<BK16, DP, NT16>(Ks + (st ^ 1) * BK16 * LD, kb, a.ksl, k1,
                                    a.Lk, D, vec);
      mml::stage_tile<BK16, DP, NT16>(Vs + (st ^ 1) * BK16 * LD, vb, a.vsl, k1,
                                    a.Lk, D, vec);
    }
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile kt (and Q) landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK16 * LD;
    const bf16* Vt = Vs + st * BK16 * LD;
    if (kQReg && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < (kQReg ? NKS : 0); ++ks)
        mml::ldmatrix_x4(qf[ks], mml::a_addr(Qs, LD, wr, ks * 16, lane));
    }

    // S = Q K^T (unscaled), 16 x 64 per warp
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t af[4];
      if (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kQReg ? ks : 0][e];
      } else {
        mml::ldmatrix_x4(af, mml::a_addr(Qs, LD, wr, ks * 16, lane));
      }
#pragma unroll
      for (int nb = 0; nb < NS / 2; ++nb) {
        uint32_t bf[4];
        mml::ldmatrix_x4(bf, mml::b_addr(Kt, LD, nb * 16, ks * 16, lane));
        mml::mma_bf16(s[2 * nb], af, bf[0], bf[1]);
        mml::mma_bf16(s[2 * nb + 1], af, bf[2], bf[3]);
      }
    }

    // online softmax on the fragments: rows g (hr 0) and g + 8 (hr 1)
    const int k0 = kt * BK16;
    const bool masked =
        k0 + BK16 > a.Lk ||
        (a.causal && static_cast<long long>(k0) + BK16 - 1 + a.k_off >
                         static_cast<long long>(q0) + wr + a.q_off);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long qpos = qpos0 + 8 * hr;
      uint32_t valid = 0xffffu;  // bit 2*nt + e
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hr + e];
          if (masked) {
            const int kpos = k0 + nt * 8 + 2 * t + e;
            const bool ok = kpos < a.Lk &&
                            (!a.causal ||
                             qpos >= static_cast<long long>(kpos) + a.k_off);
            if (!ok) valid &= ~(1u << (2 * nt + e));
          }
          x = (valid >> (2 * nt + e)) & 1u ? x * a.scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hr], quad_max(mx));
      const float corr = __expf(fminf(m[hr] - m_new, 0.f));
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hr + e];
          x = (valid >> (2 * nt + e)) & 1u ? __expf(x - m_new) : 0.f;
          rs += x;
        }
      l[hr] = l[hr] * corr + quad_sum(rs);
      m[hr] = m_new;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[i][2 * hr] *= corr;
        acc[i][2 * hr + 1] *= corr;
      }
    }

    // acc += P V, P from registers as hi + lo bf16
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t ph[4], pl[4];
      mml::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int nb = 0; nb < NO / 2; ++nb) {
        uint32_t bf[4];
        mml::ldmatrix_x4_trans(bf,
                               mml::bt_addr(Vt, LD, kk * 16, nb * 16, lane));
        mml::mma_bf16(acc[2 * nb], ph, bf[0], bf[1]);
        mml::mma_bf16(acc[2 * nb], pl, bf[0], bf[1]);
        mml::mma_bf16(acc[2 * nb + 1], ph, bf[2], bf[3]);
        mml::mma_bf16(acc[2 * nb + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage st is free for tile kt + 2
  }
  mml::cp_async_wait<0>();

  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + g + 8 * hr;
    if (row >= a.Lq) continue;
    const float l_safe = l[hr] > 0.f ? l[hr] : 1.f;
    bf16* orow = out + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = i * 8 + 2 * t;
      const float x0 = acc[i][2 * hr] / l_safe;
      const float x1 = acc[i][2 * hr + 1] / l_safe;
      if (pairs && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) orow[c] = __float2bfloat16(x0);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(x1);
      }
    }
    if (t == 0)
      lse[static_cast<long long>(bh) * a.Lq + row] = m[hr] + logf(l_safe);
  }
}

template <int DP>
int launch_bf16_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                   int B, const Args& a, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_fwd_bf16<DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + BQ16 - 1) / BQ16, B * a.H);
  flash_fwd_bf16<DP><<<grid, NT16, smem, stream>>>(q, k, v, out, lse, a,
                                                   vec);
  return static_cast<int>(cudaGetLastError());
}

// One kernel for every bf16 shape: DP = D rounded up to 32, 64, 128, 160
// or 256; 16-byte staging where every row is 16-byte aligned, element-wise
// staging otherwise.
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
                const Args& a, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const long long strides =
      a.qsb | a.qsl | a.qsh | a.ksb | a.ksl | a.ksh | a.vsb | a.vsl | a.vsh;
  const int vec = ptrs % 16 == 0 && strides % 8 == 0 && a.D % 8 == 0;
#define MML_FWD16(P) launch_bf16_dp<P>(q, k, v, out, lse, B, a, vec, stream)
  if (a.D <= 32) return MML_FWD16(32);
  if (a.D <= 64) return MML_FWD16(64);
  if (a.D <= 128) return MML_FWD16(128);
  if (a.D <= 160) return MML_FWD16(160);
  if (a.D <= 256) return MML_FWD16(256);
#undef MML_FWD16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (bound with ctypes). Returns the cudaError_t of the
// launch (0 on success). q is (B, Lq, H, D), k and v (B, Lk, H, D), each
// with unit stride along D and the given element strides along batch,
// sequence and head; out is a contiguous (B, Lq, H, D) tensor of the
// inputs' type, lse a contiguous (B, H, Lq) float32 tensor. Needs
// 1 <= D <= 256, Lq >= 1, B * H in [1, 65535].
extern "C" {

int mml_flash_fwd_f32(const float* q, const float* k, const float* v,
                      float* out, float* lse, int B, int H, int Lq, int Lk,
                      int D, long long qsb, long long qsl, long long qsh,
                      long long ksb, long long ksl, long long ksh,
                      long long vsb, long long vsl, long long vsh,
                      float scale, int causal, int q_off, int k_off,
                      void* stream) {
  const Args a{H, Lq, Lk, D, qsb, qsl, qsh, ksb, ksl, ksh,
               vsb, vsl, vsh, scale, causal, q_off, k_off};
  return launch<float>(q, k, v, out, lse, B, a,
                       static_cast<cudaStream_t>(stream));
}

int mml_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                       int B, int H, int Lq, int Lk, int D, long long qsb,
                       long long qsl, long long qsh, long long ksb,
                       long long ksl, long long ksh, long long vsb,
                       long long vsl, long long vsh, float scale, int causal,
                       int q_off, int k_off, void* stream) {
  const Args a{H, Lq, Lk, D, qsb, qsl, qsh, ksb, ksl, ksh,
               vsb, vsl, vsh, scale, causal, q_off, k_off};
  return launch_bf16(q, k, v, out, lse, B, a,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
