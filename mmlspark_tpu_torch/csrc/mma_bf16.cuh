// Building blocks of the bf16 tensor-core kernels (sm_90a), inline PTX.
//
//   * ldmatrix (.x4 and .x4.trans): four 8x8 b16 tiles from shared memory
//     into the register fragments of mma.sync;
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32;
//   * 16-byte and 4-byte cp.async with zero fill, commit_group / wait_group;
//   * split_bf16: an f32 pair as a hi and a lo bf16 pair, hi = bf16(x) and
//     lo = bf16(x - hi). Two mma.sync into one f32 accumulator, one with
//     each, multiply x by a bf16 operand to within 2^-17 |x|: products of
//     bf16 values are exact in f32. The kernels use it where an f32
//     operand (P, dS) meets a bf16 one, so the products keep the f32
//     contract of the TPU kernels instead of rounding P or dS to bf16.
//   * stage_tile: rows of one head into a padded tile in shared memory;
//   * opt_in: a kernel's dynamic shared memory, or its blocks per SM.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g < 8, t < 4):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 8+2t..),
//                     a3 (g+8, 8+2t..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 8+2t.., n g)
//   C (16 x 8):       c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two adjacent n8 tiles are the A fragment of one
// k16 step (c_tile0 -> a0 a1, c_tile1 -> a2 a3): a product's result feeds
// the next product from registers.
//
// Tiles in shared memory are row-major bf16 with a row stride of DP + 8
// elements (DP a multiple of 16): the 16-byte pad puts the eight rows that
// one ldmatrix phase reads in eight distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mml {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Address of lane `lane`'s row for the A fragment of the 16 x 16 tile at
// (row r0, column c0) of a tile with row stride ld.
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int ld, int r0,
                                              int c0, int lane) {
  return base + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}

// B fragments of two n8 tiles (n rows r0.., r0 + 8..) over k columns
// c0..c0+15 of a tile stored as (n, k) rows: regs 0-1 tile 0, 2-3 tile 1.
__device__ __forceinline__ const bf16* b_addr(const bf16* base, int ld, int r0,
                                              int c0, int lane) {
  return base + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

// The same for a tile stored as (k, n) rows, loaded with .trans: k rows
// r0..r0+15, n columns c0.. (tile 0) and c0 + 8.. (tile 1).
__device__ __forceinline__ const bf16* bt_addr(const bf16* base, int ld,
                                               int r0, int c0, int lane) {
  return base + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 +
         (lane >> 4) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The hi and lo A fragments of one k16 step from the f32 C fragments of
// two adjacent n8 tiles.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// 16 bytes from global to shared memory; zeros when !in (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [r0, r0 + ROWS) of one head (row stride sl elements, unit
// stride along the head dim) into a (ROWS, LD) tile of T (bf16 or f32);
// rows at or past `limit` and columns at or past D (up to DP) are zeros.
// vec: 16-byte cp.async (needs D a multiple of 16 bytes and 16-byte-aligned
// rows; the caller commits and waits); else element-wise loads and stores,
// visible after the next __syncthreads.
template <int ROWS, int DP, int LD, int NT, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long sl,
                                           int r0, int limit, int D,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int CH = DP / E;         // chunks per row
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH;
      const int c = (i - r * CH) * E;
      T* d = dst + r * LD + c;
      const int row = r0 + r;
      if (c < D) {
        const bool in = row < limit;
        cp_async16(d, in ? src + row * sl + c : src, in);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP;
      const int c = i - r * DP;
      const int row = r0 + r;
      dst[r * LD + c] = (row < limit && c < D) ? src[row * sl + c] : T{};
    }
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory, with the
// carveout at its largest. With occ, then report instead how many blocks of
// `threads` fit on one SM (occ[0]) and the bytes (occ[1]); the caller
// launches only when occ is null.
template <typename K>
cudaError_t opt_in(K kernel, int threads, size_t smem, int* occ) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || occ == nullptr) return err;
  occ[1] = static_cast<int>(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, threads,
                                                       smem);
}

}  // namespace mml
