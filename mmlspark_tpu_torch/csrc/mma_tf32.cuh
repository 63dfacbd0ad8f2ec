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

#pragma once

#include <stdint.h>

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

}  // namespace mml
