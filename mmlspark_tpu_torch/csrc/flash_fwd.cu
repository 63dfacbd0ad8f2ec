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
// float32: flash_fwd_tf32x3<DP>, on the tensor cores in 3xTF32
// (mma_tf32.cuh): each f32 operand split into big + small TF32 halves and
// multiplied three times into one f32 accumulator, which keeps the f32
// contract (plain TF32 would not). The layout of the bf16 body: four warps
// of 16 query rows, 32-key tiles, K and V through a two-stage cp.async
// ring, the online softmax on the accumulator fragments, P kept in
// registers as the A operand of P V. Tiles stay f32 in shared memory and
// every fragment is split as it is formed (from shared memory for Q, K and
// V, from the fragments for P): split tiles would double the shared memory
// and its reads. Q's fragments are read again for every tile: holding them
// would take 64 more registers a thread at D = 128. ldmatrix moves
// 16-bit elements only, so fragments come from 16-byte loads of Q and K
// (two k8 steps of S per load, rows of DP + 16 floats) and 8-byte loads of
// V (two output tiles per load, rows of DP + 4), each conflict-free, by
// relabelling k (and the output columns of P V) as the sums allow.
// Q + 2 x (K + V) is 105 KB at D = 128: two blocks (8 warps) per SM.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: 4*D*(unmasked pairs)*B*H = 34.4 GFLOP. Under the f32
// contract the least time is 3xTF32 on the tensor cores, 495 / 3 TFLOP/s
// of useful work: 0.21 ms (0.51 ms on the CUDA cores at 67 TFLOP/s), above
// the 0.08 ms needed to move q, k, v, O once at 3.35 TB/s: the f32 kernel
// is bound by operations. In bf16 on the tensor cores (989 TFLOP/s) it is
// 0.035 ms, below the 0.04 ms the bytes need: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr int BQ16 = 64;          // query rows per block, 16 per warp
constexpr int BK16 = 32;          // keys per KV tile
constexpr int NT16 = 2 * BQ16;    // threads: one warp per 16 rows

struct Args {
  int H, Lq, Lk, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh;
  float scale;
  int causal, q_off, k_off;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ------------------------------------------------------- bf16, tensor cores
size_t smem_bytes_bf16(int dp) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(BQ16 + 4 * BK16) *
         (dp + 8);
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

  mml::stage_tile<BQ16, DP, LD, NT16>(Qs, qb, a.qsl, q0, a.Lq, D, vec);
  if (n_kv > 0) {
    mml::stage_tile<BK16, DP, LD, NT16>(Ks, kb, a.ksl, 0, a.Lk, D, vec);
    mml::stage_tile<BK16, DP, LD, NT16>(Vs, vb, a.vsl, 0, a.Lk, D, vec);
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
      mml::stage_tile<BK16, DP, LD, NT16>(Ks + (st ^ 1) * BK16 * LD, kb,
                                          a.ksl, k1, a.Lk, D, vec);
      mml::stage_tile<BK16, DP, LD, NT16>(Vs + (st ^ 1) * BK16 * LD, vb,
                                          a.vsl, k1, a.Lk, D, vec);
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
  const cudaError_t err =
      mml::opt_in(flash_fwd_bf16<DP>, NT16, smem, nullptr);
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

// ------------------------------------------------ float32, 3xTF32 (mma)
size_t smem_bytes_tf32(int dp) {
  return sizeof(float) * static_cast<size_t>((BQ16 + 2 * BK16) * (dp + 16) +
                                             2 * BK16 * (dp + 4));
}

// DP: the head dim padded with zeros to a multiple of 16 (32, 64, 128,
// 160 or 256).
template <int DP>
__global__ void __launch_bounds__(NT16)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, Args a, int vec) {
  constexpr int LDQ = DP + 16;  // Q and K rows: conflict-free 16-byte loads
  constexpr int LDV = DP + 4;   // V rows: conflict-free 8-byte loads
  constexpr int NC = DP / 16;   // 16-column chunks (two k8 steps) of S
  constexpr int NO = DP / 8;    // n8 tiles of a warp's output rows
  constexpr int NS = BK16 / 8;  // n8 tiles of a warp's score rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // (BQ16, LDQ)
  float* Ks = Qs + BQ16 * LDQ;                      // 2 stages of (BK16, LDQ)
  float* Vs = Ks + 2 * BK16 * LDQ;                  // 2 stages of (BK16, LDV)

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

  const float* qb = q + b * a.qsb + h * a.qsh;
  const float* kb = k + b * a.ksb + h * a.ksh;
  const float* vb = v + b * a.vsb + h * a.vsh;

  int n_kv = (a.Lk + BK16 - 1) / BK16;
  if (a.causal) {
    const long long last =
        static_cast<long long>(q0) + BQ16 - 1 + a.q_off - a.k_off;
    const int n_c = last < 0 ? 0 : static_cast<int>(last / BK16) + 1;
    n_kv = min(n_kv, n_c);
  }

  mml::stage_tile<BQ16, DP, LDQ, NT16>(Qs, qb, a.qsl, q0, a.Lq, D, vec);
  if (n_kv > 0) {
    mml::stage_tile<BK16, DP, LDQ, NT16>(Ks, kb, a.ksl, 0, a.Lk, D, vec);
    mml::stage_tile<BK16, DP, LDV, NT16>(Vs, vb, a.vsl, 0, a.Lk, D, vec);
  }
  mml::cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // global positions of the thread's two rows
  const long long qpos0 = static_cast<long long>(q0) + wr + g + a.q_off;
  // the thread's Q columns 16c + 4t .. 4t+3 of rows g and g + 8
  const float* qrow = Qs + (wr + g) * LDQ + 4 * t;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const int k1 = (kt + 1) * BK16;
      mml::stage_tile<BK16, DP, LDQ, NT16>(Ks + (st ^ 1) * BK16 * LDQ, kb,
                                           a.ksl, k1, a.Lk, D, vec);
      mml::stage_tile<BK16, DP, LDV, NT16>(Vs + (st ^ 1) * BK16 * LDV, vb,
                                           a.vsl, k1, a.Lk, D, vec);
    }
    mml::cp_async_commit();
    mml::cp_async_wait<1>();  // tile kt (and Q) landed
    __syncthreads();
    const float* Kt = Ks + st * BK16 * LDQ;
    const float* Vt = Vs + st * BK16 * LDV;

    // S = Q K^T (unscaled), 16 x 32 per warp; k8 step 2c takes columns
    // 16c + 4t, 4t+1 as logical k t, t+4, step 2c+1 columns 4t+2, 4t+3
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(qrow + 16 * c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qrow + 8 * LDQ + 16 * c);
      uint32_t ab0[4], as0[4], ab1[4], as1[4];
      mml::split_a_tf32(x0.x, x1.x, x0.y, x1.y, ab0, as0);
      mml::split_a_tf32(x0.z, x1.z, x0.w, x1.w, ab1, as1);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Kt + (nt * 8 + g) * LDQ + 16 * c + 4 * t);
        mml::mma_3xtf32(s[nt], ab0, as0, kv.x, kv.y);
        mml::mma_3xtf32(s[nt], ab1, as1, kv.z, kv.w);
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

    // acc += P V: P's C fragment of an n8 tile is the A fragment of one k8
    // step (a0..a3 = c0 c2 c1 c3, logical k t <-> key 2t, t+4 <-> 2t+1);
    // output tiles 2j and 2j+1 take columns 16j + 2n and 16j + 2n + 1 for
    // logical n, so one 8-byte load of V feeds both
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t pb[4], ps[4];
      mml::split_a_tf32(s[kk][0], s[kk][2], s[kk][1], s[kk][3], pb, ps);
      const float* v0 = Vt + (kk * 8 + 2 * t) * LDV + 2 * g;
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * j);
        const float2 y = *reinterpret_cast<const float2*>(v0 + LDV + 16 * j);
        mml::mma_3xtf32(acc[2 * j], pb, ps, x.x, y.x);
        mml::mma_3xtf32(acc[2 * j + 1], pb, ps, x.y, y.y);
      }
    }
    __syncthreads();  // stage st is free for tile kt + 2
  }
  mml::cp_async_wait<0>();

  // the thread's output columns 16j + 4t .. 4t+3: tile 2j's c0 / c1 (c2 /
  // c3 for row g + 8) at 4t and 4t+2, tile 2j+1's at 4t+1 and 4t+3
  const bool quads = (D & 3) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wr + g + 8 * hr;
    if (row >= a.Lq) continue;
    const float l_safe = l[hr] > 0.f ? l[hr] : 1.f;
    float* orow =
        out + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NO / 2; ++j) {
      const int c = 16 * j + 4 * t;
      const float x[4] = {
          acc[2 * j][2 * hr] / l_safe, acc[2 * j + 1][2 * hr] / l_safe,
          acc[2 * j][2 * hr + 1] / l_safe, acc[2 * j + 1][2 * hr + 1] / l_safe};
      if (quads && c + 3 < D) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) orow[c + e] = x[e];
      }
    }
    if (t == 0)
      lse[static_cast<long long>(bh) * a.Lq + row] = m[hr] + logf(l_safe);
  }
}

template <int DP>
int launch_tf32_dp(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, const Args& a, int vec,
                   cudaStream_t stream, int* occ) {
  const cudaError_t err =
      mml::opt_in(flash_fwd_tf32x3<DP>, NT16, smem_bytes_tf32(DP), occ);
  if (err != cudaSuccess || occ) return static_cast<int>(err);
  const dim3 grid((a.Lq + BQ16 - 1) / BQ16, B * a.H);
  flash_fwd_tf32x3<DP><<<grid, NT16, smem_bytes_tf32(DP), stream>>>(
      q, k, v, out, lse, a, vec);
  return static_cast<int>(cudaGetLastError());
}

// One kernel for every float32 shape: DP = D rounded up to 32, 64, 128,
// 160 or 256; 16-byte staging where every row is 16-byte aligned and
// D % 4 == 0, element-wise staging otherwise. With occ, the kernel's
// blocks per SM and shared memory instead of a launch (mml::opt_in).
int launch_tf32(const float* q, const float* k, const float* v, float* out,
                float* lse, int B, const Args& a, cudaStream_t stream,
                int* occ = nullptr) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const long long strides =
      a.qsb | a.qsl | a.qsh | a.ksb | a.ksl | a.ksh | a.vsb | a.vsl | a.vsh;
  const int vec = ptrs % 16 == 0 && strides % 4 == 0 && a.D % 4 == 0;
#define MML_FWD32(P) \
  launch_tf32_dp<P>(q, k, v, out, lse, B, a, vec, stream, occ)
  if (a.D <= 32) return MML_FWD32(32);
  if (a.D <= 64) return MML_FWD32(64);
  if (a.D <= 128) return MML_FWD32(128);
  if (a.D <= 160) return MML_FWD32(160);
  if (a.D <= 256) return MML_FWD32(256);
#undef MML_FWD32
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
  return launch_tf32(q, k, v, out, lse, B, a,
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

// Blocks of the float32 kernel for head dim D that fit on one SM, and its
// dynamic shared memory (occ[0], occ[1]). Returns the cudaError_t.
int mml_flash_fwd_f32_occupancy(int D, int* occ) {
  Args a{};
  a.D = D;
  return launch_tf32(nullptr, nullptr, nullptr, nullptr, nullptr, 0, a,
                     nullptr, occ);
}

}  // extern "C"
