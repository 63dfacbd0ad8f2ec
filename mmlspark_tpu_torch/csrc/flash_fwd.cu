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
// Layout of the work: 256 threads as a 16 x 16 grid. Thread (tr, tc) owns
// query rows tr + 16*i (i < 4) for the whole launch, score columns
// tc + 16*j (j < 4) of each 64-key tile, and output columns tc + 16*jj
// (jj < NJ, NJ*16 >= D) of its rows. A row's 16 owners are the 16 lanes of
// one half-warp, so row max and row sum are 4 shuffles. Q, then K and V
// (through one shared buffer) are staged in shared memory as f32 rows of
// stride D + 1 (conflict-free column reads); P goes through shared memory
// between the two products.
//
// Bound on the H100 SXM at the slice's shape (B, L, H, D) = (8, 1024, 16,
// 128), causal: 4*D*(unmasked pairs)*B*H = 34.4 GFLOP. In f32 on the CUDA
// cores (67 TFLOP/s) that is 0.51 ms, above the 0.08 ms needed to move
// q, k, v, O once at 3.35 TB/s: the f32 kernel is bound by operations.
// In bf16 the tensor cores would make it bound by bytes (0.04 ms). This
// first design does every product in f32 FMA on the CUDA cores, each one
// fed by shared-memory loads (8 loads per 16 FMA in QK^T), so it sits
// well above either bound; mma / wgmma, TMA staging and a pipelined KV
// ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as Tensor.to()
}

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
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, a,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
