// Device helpers for fp32-accurate products on Hopper's TF32 tensor cores
// (split-TF32, "3xTF32"), shared by the fp32 tensor-core kernels
// (ecr_conv.cu): the round to TF32, the split of an fp32 value into two TF32
// values, the m16n8k8 TF32 MMA, and the three-product step. Asynchronous
// copies, ldmatrix and the SM count come from smem_io.cuh.
//
// Why three products: one TF32 product per multiply-add keeps 10 mantissa
// bits of each operand, and over a 4,608-term reduction (VGG-19's 3x3x512)
// errs by about 3x the fp32 kernels' limit (1e-4 * max|plain| + ...). With
// a = a_hi + a_lo, a_hi = tf32(a) and a_lo = tf32(a - a_hi), and the same for
// b, a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi + a_lo*b_lo, where the last term
// is below 2^-22 |a*b| and is dropped. Each product of two TF32 values is
// exact in fp32, and the MMA accumulates in fp32, so the sum holds about
// fp32 accuracy at a third of the TF32 rate: 495 / 3 = 165 TFLOP/s on an
// H100 SXM, 2.5x its 67 TFLOP/s of fp32 outside the tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_io.cuh"

namespace tf32mma {

using smemio::cp_async16;
using smemio::cp_async_commit;
using smemio::cp_async_wait;
using smemio::ldmatrix_x4;
using smemio::sm_count;
using smemio::smem_addr;

// a rounded to TF32 (10 mantissa bits; to nearest, ties away from zero), as
// the bits of an fp32 value whose low 13 mantissa bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a ~= hi + lo with hi = tf32(a) and lo = tf32(a - hi); a - hi is exact in
// fp32, so |a - hi - lo| <= 2^-22 |a| (about).
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col): TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b at about fp32 accuracy from split operands: the two small terms
// first (they are the ones a late add would round away), then hi * hi;
// lo * lo is dropped.
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

}  // namespace tf32mma
