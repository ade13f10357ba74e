// Device helpers for the bf16 tensor-core kernels (the bf16 flash forward in
// flash_attention.cu and the bf16 flash backward passes in
// flash_attention_bwd.cu): the m16n8k16 bf16 MMA with fp32 accumulation,
// bf16 pairs packed into the 32-bit registers of its fragments, the bf16
// hi + lo split of an fp32 value, and the shared-row geometry of a bf16
// operand. Asynchronous copies and the shared-memory allowance come from
// smem_io.cuh.
//
// A bf16 x bf16 product is exact in fp32 (8 significant bits each), so an
// MMA step adds 16 exact products into an fp32 accumulator: the kernels'
// sums of bf16 operands are the plain versions' fp32 sums, up to order and
// the MMA's truncating accumulation (about 2^-23 of the running sum per
// step, far below the bf16 rounding of every output).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "smem_io.cuh"

namespace bf16mma {

using smemio::allow_smem;
using smemio::cp_async16;
using smemio::cp_async_commit;
using smemio::cp_async_wait;
using smemio::kMaxDevices;
using smemio::smem_addr;

// A bf16 operand's rows in shared memory: the contraction width DK =
// max(D, 16) (head dim 8 zero-padded to the k16 of an MMA), plus 8 elements,
// which keeps the fragment loads (rows g, 32-bit words t) conflict-free.
template <int D>
struct Bf16Rows {
  static constexpr int DK = D < 16 ? 16 : D;
  static constexpr int DP = DK + 8;  // elements per shared row
  static constexpr int W = DP / 2;   // 32-bit words per shared row
};

// c += a (16x16, row) * b (16x8, col): bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest, ties to even) in one
// register: lo in the low half, which a fragment reads as the lower index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

// A bf16 value (its bits) as fp32, exactly.
__device__ __forceinline__ float bf16_bits_to_float(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}

// x0 ~= hi0 + lo0 and x1 ~= hi1 + lo1, packed as two bf16 pairs: hi = x
// rounded to bf16, lo = the rest rounded to bf16, so |x - hi - lo| <=
// 2^-17 |x| (about). Two MMAs (lo, then hi) then give an fp32 operand's
// product with a bf16 one to about 2^-16, where one bf16 product errs by
// 2^-9.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  memcpy(&hi, &h, 4);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// x rounded to the nearest bf16 (ties to even), as an fp32 value: the
// softmax scale as the reference multiplies a bf16 q by it (finite x).
__host__ __device__ inline float round_bf16(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  u &= 0xffff0000u;
  memcpy(&x, &u, 4);
  return x;
}

}  // namespace bf16mma
