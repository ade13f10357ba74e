// Device helpers for fp32-accurate products on Hopper's TF32 tensor cores
// (split-TF32, "3xTF32"), shared by the fp32 tensor-core kernels
// (ecr_conv.cu, bsr_matmul.cu, flash_attention.cu, flash_attention_bwd.cu):
// the split of an fp32 value into two TF32 values, the m16n8k8 TF32 MMA,
// and the three-product step. Asynchronous copies, ldmatrix, the SM count
// and the shared-memory allowance come from smem_io.cuh.
//
// Why three products: one TF32 product per multiply-add keeps 10 mantissa
// bits of each operand, and over a 4,608-term reduction (VGG-19's 3x3x512)
// errs by about 3x the fp32 kernels' limit (1e-4 * max|plain| + ...). With
// a = a_hi + a_lo (`split`: a_hi = a rounded to TF32, a_lo = the rest in
// TF32), and the same for b, a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi +
// a_lo*b_lo, where the last term is below 2^-22 |a*b| and is dropped. Each
// product of two TF32 values is exact in fp32 and the MMA accumulates in
// fp32, at a third of the TF32 rate: 495 / 3 = 165 TFLOP/s on an H100 SXM,
// 2.5x its 67 TFLOP/s of fp32 outside the tensor cores. The MMA's
// accumulation truncates, though, so a long chain of MMAs into one
// accumulator drifts toward zero; ecr_conv.cu therefore adds each tap's
// products into its accumulator with a rounded FADD.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_io.cuh"

namespace tf32mma {

using smemio::allow_smem;
using smemio::cp_async16;
using smemio::cp_async4;
using smemio::cp_async_commit;
using smemio::cp_async_wait;
using smemio::kMaxDevices;
using smemio::ldmatrix_x4;
using smemio::sm_count;
using smemio::smem_addr;

// a ~= hi + lo as CUTLASS's fast 3xTF32 forms them, in three instructions:
// hi = the bits of a plus half a TF32 ulp, lo = a - tf32(hi), both handed to
// the MMA raw. The tensor cores read a TF32 operand from the top 19 bits of
// its fp32 word, so hi acts as a rounded to nearest (ties away from zero)
// and lo as truncated: |a - hi - lo| <= 2^-21 |a| (about). a - tf32(hi) is
// exact in fp32. Inf inputs come out as NaN.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) + 0x1000u;
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
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
