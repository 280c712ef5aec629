// Shared device helpers of the port's Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pcpdf {

// Squared distance as (dx*dx + dy*dy) + dz*dz with every operation rounded
// on its own (no FMA contraction), so a kernel and the plain PyTorch
// version, which runs the same elementwise ops one by one, agree bit for
// bit.
__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Split TF32 on the tensor cores (mma.sync m16n8k8): each f32 operand as
// x = hi + lo, both TF32, and a product as a_lo b_hi + a_hi b_lo + a_hi b_hi.

// x rounded to TF32, to nearest, ties away from zero (as cvt.rna does), in
// two integer operations on its bits
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: lo = tf32(x - hi) (rounded, not left to the
// mma's truncation, which would bias every product towards 0)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

// d = a b + c
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

}  // namespace pcpdf
