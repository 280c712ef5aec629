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

// t = a b in split TF32, summed from 0; acc += t, rounded to nearest
__device__ __forceinline__ void mma_split(float (&acc)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  const float kZero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_tf32(t, al, bh, kZero);
  mma_tf32(t, ah, bl, t);
  mma_tf32(t, ah, bh, t);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Asynchronous copies from device memory into shared memory (cp.async):
// issued without waiting, completed by commit groups
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

// 16 bytes, or zeros where !on (nothing read)
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace pcpdf
