// Device helpers shared by the int8 tensor-core kernels (ecr_conv_int8.cu,
// bsr_matmul_int8.cu): the m16n8k32 int8 MMA, and a 4x4 byte transpose that
// turns four rows of an N-contiguous tile into four K-contiguous MMA
// fragments; asynchronous copies, ldmatrix and the SM count come from
// smem_io.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_io.cuh"

namespace int8mma {

using smemio::cp_async16;
using smemio::cp_async8;
using smemio::cp_async_commit;
using smemio::cp_async_wait;
using smemio::ldmatrix_x4;
using smemio::sm_count;
using smemio::smem_addr;

// c += a (16x32, row) * b (32x8, col), int8 in, exact int32 sums.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[i] holds bytes (row i, columns 0..3) of a 4x4 int8 block; o[j] receives
// (rows 0..3, column j): four K-contiguous fragment words out of four
// N-contiguous rows.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3, uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

}  // namespace int8mma
