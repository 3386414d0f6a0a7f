// 3xTF32 on mma.sync.m16n8k8, shared by kernels 2 (occlude.cu, f32 mode)
// and 4 (flatscan.cu). An f32 operand a is split into two TF32 values hi
// and lo, and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b.
// Every product of two TF32 values is exact; the tensor core's f32
// accumulation is not documented to round as IEEE does. The tensor core
// reads a .tf32 operand by dropping its low 13 bits, so hi must be a TF32
// value itself, or a - hi would be wrong by up to 2^-10 relative. Two
// splits:
//  - split_tf32 (flatscan.cu): hi = rna(a), lo = rna(a - hi), rna being
//    cvt.rna.tf32.f32's rounding; the products miss at most about
//    3 * 2^-22 of |a b|. Five integer and float operations a value.
//  - split_tf32_rz (occlude.cu): hi = a with its low 13 bits cleared
//    (toward zero), lo = a - hi exactly, of which the mma reads the top
//    bits; the products miss less than 3.01 * 2^-20 of |a b| whether the
//    mma truncates or rounds lo. Two operations a value.
#pragma once

#include "common.cuh"

namespace pa {

// The TF32 value nearest to x (ties away from zero), as the f32 bit pattern
// the mma reads: cvt.rna.tf32.f32's rounding, written as the two integer
// operations it comes to for every input that is not a NaN (add half a
// TF32 ulp to the magnitude bits, clear the 13 bits the mma drops); the
// instruction itself compiles to about twice as many.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// hi = a toward zero in TF32 (exact for the mma), lo = a - hi (exact in
// f32; |lo| < 2^-10 |a|).
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D = A B + D on one m16n8k8 TF32 fragment (PTX ISA, "Matrix Fragments for
// mma.m16n8k8" with .tf32): A row-major 16 x 8, a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B column-major 8 x 8, b0 (t, g), b1
// (t + 4, g); C/D c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1), with g = lane / 4 (groupID) and t = lane % 4 (threadID_in_group).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace pa
