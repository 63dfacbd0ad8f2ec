// Building blocks of the f32-contract tensor-core kernels (sm_90a): 3xTF32
// on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, inline PTX.
//
// TF32 keeps 10 mantissa bits, so one TF32 product breaks the f32 contract
// of the TPU kernels (about 1e-3 relative). 3xTF32 splits each f32 operand
// into big = tf32(x), rounded to nearest, and small = x - big, and
// accumulates small*big + big*small + big*big in one f32 accumulator; the
// dropped small*small term and the truncation of small to TF32 are
// ~2^-20 |x y| at most, below the f32 sums' own error at the card tests'
// tolerance (rtol 1e-4 / atol 1e-4 against float64;
// tests/test_torch_flash.py::test_3xtf32_keeps_the_f32_contract pins it on
// the CPU). 3 mma per useful product, on 495 TFLOP/s of dense TF32.
//
// Fragment layouts of m16n8k8 .tf32 (lane = 4 * g + t, g < 8, t < 4):
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t+4, n g)
//   C (16 x 8):      c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// A product sums over k in any order, so a kernel may relabel k as long as
// A and B agree. The kernels use two relabellings:
//   * from shared memory: a 16-column chunk c gives thread t the four
//     contiguous columns 16c + 4t .. 4t+3 (one 16-byte load); k8 step 2c
//     takes the first two as logical k t and t+4, step 2c+1 the last two.
//     With a row stride of DP + 16 floats the eight lanes of a quarter-warp
//     hit 32 distinct banks.
//   * from registers: the C fragment of an n8 tile is the A fragment of a
//     k8 step with logical k t <-> column 2t and t+4 <-> 2t+1: a0 a1 a2 a3
//     = c0 c2 c1 c3. The B operand then reads rows 2t and 2t+1.
// ldmatrix moves 16-bit elements only, so the fragments come from plain
// 32-bit or 128-bit shared loads.
//
// A tile that feeds B fragments both ways (K in flash_dq: as the (key, d)
// rows of S = Q K^T and as rows 2t, 2t+1 of dQ += dS K; Q and dO in
// flash_dkv likewise) has no padding that keeps both loads conflict-free:
// a quarter-warp's 16-byte loads of rows g, g+1 need a row stride of 16
// mod 32 floats, a half-warp's 8-byte loads of rows 2t need 4 or 12 mod
// 16. Such tiles are unpadded (row stride DP, a multiple of 32) and
// swizzled: the 16-byte chunk c of row r lies at chunk c ^ swz(r), with
// swz(r) = (r & 6) ^ ((r & 1) << 2). Rows g and g+1 (g even) then differ
// in bit 2 of the swizzle, so their four chunks 4c'+t fall in opposite
// halves of the 32 banks; rows 0, 2, 4, 6 (and 1, 3, 5, 7) differ in bits
// 1-2, so the chunk pairs 4j + (g >> 1) of the 16 lanes of an 8-byte load
// cover the 32 banks once. A-fragment loads (rows g and g + 8, 16 bytes)
// are conflict-free in the same layout, so every f32 tile of the backward
// kernels uses it.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"  // cp_async16

namespace mml {

// x -> big = tf32(x), rounded to nearest (ties away from zero) by adding
// half a TF32 ulp and clearing the 13 low bits, and small = x - big, exact
// in f32. small goes to the mma whole: the tensor cores read the top 19
// bits of an operand, so the mma truncates it to TF32 itself. Two integer
// ops and a subtraction: cvt.rna.tf32.f32 on both halves made the forward
// markedly slower (PERF.md, §6).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a * b, f32 accumulator, one m16n8k8 TF32 product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (four f32 values in a0..a3 order) split into big and small.
__device__ __forceinline__ void split_a_tf32(float x0, float x1, float x2,
                                             float x3, uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  split_tf32(x0, big[0], small[0]);
  split_tf32(x1, big[1], small[1]);
  split_tf32(x2, big[2], small[2]);
  split_tf32(x3, big[3], small[3]);
}

// c += a * b in 3xTF32 from the split A fragment and the B pair (x0, x1):
// the small terms first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float x0,
                                           float x1) {
  uint32_t b0, b1, s0, s1;
  split_tf32(x0, b0, s0);
  split_tf32(x1, b1, s1);
  mma_tf32(c, as, b0, b1);
  mma_tf32(c, ab, s0, s1);
  mma_tf32(c, ab, b0, b1);
}

// The chunk swizzle of row r of an unpadded tile (only r % 8 counts).
__device__ __forceinline__ int swz(int r) { return (r & 6) ^ ((r & 1) << 2); }

// Offset in floats of column col of row r in an unpadded, swizzled tile
// of row stride DP.
template <int DP>
__device__ __forceinline__ int swz_off(int r, int col) {
  return r * DP + ((((col >> 2) ^ swz(r)) << 2) | (col & 3));
}

// stage_tile (mma_bf16.cuh) for f32 rows into an unpadded, swizzled
// (ROWS, DP) tile; rows at or past `limit` and columns at or past D are
// zeros. vec: 16-byte cp.async (D % 4 == 0 and 16-byte-aligned rows; the
// caller commits and waits); else element-wise, visible after the next
// __syncthreads.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage_tile_swz(float* dst, const float* src,
                                               long long sl, int r0,
                                               int limit, int D, bool vec) {
  static_assert(DP % 32 == 0, "the swizzle permutes 8 chunks of a row");
  if (vec) {
    constexpr int CH = DP / 4;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH;
      const int c = (i - r * CH) * 4;
      float* d = dst + swz_off<DP>(r, c);
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
      dst[swz_off<DP>(r, c)] =
          (row < limit && c < D) ? src[row * sl + c] : 0.f;
    }
  }
}

}  // namespace mml
