// Device helpers of the bf16 flash kernels in FlashAttention-2's layout on
// mma.sync m16n8k16 (the forward in flash_attention.cu, both backward passes
// in flash_attention_bwd.cu): the multiply-shift divider of a flattened
// (position, group) row, block-wide cp.async copies of bf16 rows into padded
// shared rows, ldmatrix lane offsets, the MUFU's exp2 and reciprocal, the
// products of a warp's 16 rows against a shared tile (over the head dim, or
// over the tile's keys or rows), the store of a warp's rows rounded to bf16,
// and the heaviest-first grid. Each source is compiled by its own nvcc, so
// what both use lives here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace flashbf16 {

using bf16mma::Bf16Rows;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using smemio::cp_async16;
using smemio::ldmatrix_x4;
using smemio::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;

// n / g for 0 <= n < 2^31 and 1 <= g < 2^31 by a multiply and a shift
// (Granlund and Montgomery's round-up method: m = ceil(2^(31+l) / g) with
// 2^l >= g, so n m / 2^(31+l) errs from n / g by less than 1 / g).
struct DivG {
  unsigned long long m;
  int shift;
  __device__ explicit DivG(int g) {
    int l = 0;
    while ((1ll << l) < g) ++l;
    shift = 31 + l;
    m = ((1ull << shift) + (unsigned long long)g - 1) / (unsigned long long)g;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> shift);
  }
};

// Element offsets of one row in two operands (< 0: past their rows).
struct RowPair {
  long long a, b;
};

// Copy N rows of two bf16 operands into [N][DP] shared rows each, by the
// block's kT threads: row r from element offsets offs(r) (< 0: zero-filled),
// the same row of both (K and V, or Q and dO). TPR threads share a row (8
// or more where the row allows: whole 128-byte lines per instruction), so a
// thread forms one or two rows' offsets per call. 16-byte cp.async when `vec`, else
// element copies by plain loads and stores in a rolled loop (the path of
// misaligned views, kept out of the hot loops' code); the caller's cp.async
// wait and barrier publish either.
template <int D, int N, int kT, typename RowOffs>
__device__ __forceinline__ void copy_rows_bf16(uint16_t* dst_a, const uint16_t* __restrict__ a,
                                               uint16_t* dst_b, const uint16_t* __restrict__ b,
                                               RowOffs offs, bool vec) {
  constexpr int DP = Bf16Rows<D>::DP;
  constexpr int kC = D / 8;  // 16-byte chunks per row
  constexpr int TPR0 = kT / N < 8 ? 8 : kT / N;
  constexpr int TPR = TPR0 < kC ? TPR0 : kC;  // threads per row
  constexpr int RP = kT / TPR;                // rows per pass of the block
  static_assert(kT % N == 0, "whole rows per thread group");
  const int r0 = threadIdx.x / TPR, part = threadIdx.x % TPR;
#pragma unroll
  for (int pass = 0; pass < (N + RP - 1) / RP; ++pass) {
    const int r = r0 + pass * RP;
    if (N % RP != 0 && r >= N) break;
    const RowPair o = offs(r);
    uint16_t* const ra = dst_a + r * DP;
    uint16_t* const rb = dst_b + r * DP;
    if (vec) {
      const uint16_t* const fa = a + (o.a >= 0 ? o.a : 0);
      const uint16_t* const fb = b + (o.b >= 0 ? o.b : 0);
#pragma unroll
      for (int j = 0; j < kC / TPR; ++j) {
        const int c = 8 * (part + TPR * j);
        cp_async16(smem_addr(ra + c), fa + c, o.a >= 0);
        cp_async16(smem_addr(rb + c), fb + c, o.b >= 0);
      }
    } else {
#pragma unroll 1
      for (int d = part; d < D; d += TPR) {
        ra[d] = o.a >= 0 ? a[o.a + d] : (uint16_t)0;
        rb[d] = o.b >= 0 ? b[o.b + d] : (uint16_t)0;
      }
    }
  }
}

// Zero `bytes` of shared memory (the pad columns D .. 15 that the k16 MMAs
// contract at head dim 8); the caller synchronises.
template <int kT>
__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The element offsets, within a [16][DP] tile, of the row address lane l
// gives ldmatrix.x4: for an A fragment or a .trans B fragment (matrices:
// rows 0-7 / 8-15 of columns 0-7, then of columns 8-15), and for a
// non-transposed B fragment of two n8 tiles (n rows 0-7 at columns 0-7 and
// 8-15, then n rows 8-15).
__device__ __forceinline__ int lane_a(int lane, int dp) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * dp + (lane >> 4) * 8;
}
__device__ __forceinline__ int lane_b(int lane, int dp) {
  return ((lane & 7) + (lane >> 4) * 8) * dp + ((lane >> 3) & 1) * 8;
}

// 2^x by the MUFU's ex2.approx (subnormal results flushed to 0, 2^-22 of
// relative error): exp2f's range scaling costs four instructions more on the
// passes' critical path.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x by the MUFU's rcp.approx (1 ulp; x normal).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of a 16 x 16 product from the C fragments x0, x1 of two n8
// tiles (a lane holds columns 2t, 2t + 1 of rows g (e < 2) and g + 8),
// rounded to bf16: A's own layout, no renaming needed.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// One k16 step (ks) of rows_product.
template <int D, int NJ, int KR, bool kFresh>
__device__ __forceinline__ void rows_step(float (&acc)[NJ][4], const uint32_t (&af)[KR][4],
                                          uint32_t a, uint32_t b, int ks) {
  constexpr int DP = Bf16Rows<D>::DP, KS = Bf16Rows<D>::DK / 16;
  uint32_t x[4];
  if (KR == KS) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = af[KR == KS ? ks : 0][i];
  } else {
    ldmatrix_x4(x, a + 32 * ks);
  }
#pragma unroll
  for (int np = 0; np < NJ / 2; ++np) {
    uint32_t bf[4];
    ldmatrix_x4(bf, b + 2 * (16 * np * DP + 16 * ks));
    if (kFresh) {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(s0, x, bf[0], bf[1]);
      mma_bf16(s1, x, bf[2], bf[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] += s0[e];
        acc[2 * np + 1][e] += s1[e];
      }
    } else {
      mma_bf16(acc[2 * np], x, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], x, bf[2], bf[3]);
    }
  }
}

// acc[j] += A (16 x DK) . B^T for the NJ n8 tiles of B^T's [NJ * 8][DP]
// rows at shared address `b` (bytes; lane_b's offset added): S and dP in
// dq, S^T and dP^T in dk/dv, S in the forward. A's fragments are `af` when
// it holds all KS k steps (KR == KS), else read at each step by ldmatrix
// from `a` (bytes; lane_a's offset added). With kFresh each MMA goes into a
// zeroed fragment that a rounded FADD adds to acc (the forward's S: a chain
// of MMAs into one accumulator truncates at every step, and m and l hold
// 1e-5). SU < KS (A read by ldmatrix) unrolls SU steps per trip of a rolled
// loop, which bounds the loads the compiler hoists ahead of their MMAs.
template <int D, int NJ, int KR, bool kFresh = false, int SU = Bf16Rows<D>::DK / 16>
__device__ __forceinline__ void rows_product(float (&acc)[NJ][4], const uint32_t (&af)[KR][4],
                                             uint32_t a, uint32_t b) {
  constexpr int KS = Bf16Rows<D>::DK / 16;
  static_assert(SU == KS || (KR != KS && KS % SU == 0), "a rolled k loop reads A by ldmatrix");
  if constexpr (SU == KS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) rows_step<D, NJ, KR, kFresh>(acc, af, a, b, ks);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < KS; k0 += SU) {
#pragma unroll
      for (int kk = 0; kk < SU; ++kk) rows_step<D, NJ, KR, kFresh>(acc, af, a, b, k0 + kk);
    }
  }
}

// acc[n] += A . B[:, 8n ..] for the n < NO n8 tiles of an output row, where
// B's 16 k rows (keys or query rows) sit at shared address `b` (bytes;
// lane_a's offset, the k step's rows and the first column added): dq += ds.K,
// dK += dS^T.Q, and with `lo` also dV += lo.dO then hi.dO.
template <int NO, int NA>
__device__ __forceinline__ void cols_product(float (&acc)[NA][4], const uint32_t (&a)[4],
                                             uint32_t b) {
#pragma unroll
  for (int np = 0; np < (NO + 1) / 2; ++np) {
    uint32_t bf[4];
    smemio::ldmatrix_x4_trans(bf, b + 32 * np);
    mma_bf16(acc[2 * np], a, bf[0], bf[1]);
    if (2 * np + 1 < NO) mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
  }
}
template <int NO, int NA>
__device__ __forceinline__ void cols_product_split(float (&acc)[NA][4], const uint32_t (&lo)[4],
                                                   const uint32_t (&hi)[4], uint32_t b) {
#pragma unroll
  for (int np = 0; np < (NO + 1) / 2; ++np) {
    uint32_t bf[4];
    smemio::ldmatrix_x4_trans(bf, b + 32 * np);
    mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
    mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
    if (2 * np + 1 < NO) {
      mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
      mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
    }
  }
}

// Store a warp's 16 output rows from its accumulators, times `mul`, rounded
// to bf16: the lane's rows g and g + 8 at element offsets o[hf] (< 0: not
// written), columns 8n + 2t, 2t + 1 for n < NO.
template <int NO, int NA>
__device__ __forceinline__ void store_rows_bf16(uint16_t* __restrict__ out,
                                                const float (&acc)[NA][4],
                                                const long long (&o)[2], float mul, int t,
                                                bool vec) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (o[hf] < 0) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const uint32_t y = pack_bf16(acc[n][2 * hf] * mul, acc[n][2 * hf + 1] * mul);
      uint16_t* dst = out + o[hf] + 8 * n + 2 * t;
      if (vec) {
        *reinterpret_cast<uint32_t*>(dst) = y;
      } else {
        dst[0] = (uint16_t)y;
        dst[1] = (uint16_t)(y >> 16);
      }
    }
  }
}

// The grid of either pass: kv heads on x, the tile order on y (and z past
// 65535 tiles), so the blocks launch tile-major, heaviest first.
inline dim3 bf16_grid(int nbkv, int n_tiles) {
  return dim3(nbkv, n_tiles < 65535 ? n_tiles : 65535, (n_tiles + 65534) / 65535);
}

__device__ __forceinline__ int tile_order() { return blockIdx.y + blockIdx.z * gridDim.y; }

}  // namespace flashbf16
