// Block-sparse matmul for Hopper (sm_90a): y = h @ w, skipping the (bt, bf)
// blocks of h that the per-row-block schedule leaves out.
//
// Replaces the TPU kernel
//   repro/kernels/bsr_matmul/kernel.py bsr_matmul_pallas -> repro_bsr_matmul_f32
// (fp32 operands, fp32 accumulate). The int8 form (`repro_bsr_matmul_i8`)
// has its own tensor-core body in bsr_matmul_int8.cu.
//
// What it computes (the same function as the Pallas kernels): h (T,F) and
// w (F,D) row-major; row-block i (rows [8i, 8i+8)) sums only over the
// reduction blocks ids[i, 0..cnt[i]) of width bf:
//   y[r, :] = sum_k h[r, ids[i,k]*bf : +bf] @ w[ids[i,k]*bf : +bf, :].
// A block left out of the schedule contributes nothing; cnt[i] = 0 writes a
// row-block of zeros. In the conv lowering (`sparse_weights/conv.py`) h is
// the pruned weight matrix W (O, K) and w the patch matrix A^T (K, N*oh*ow).
// Ragged shapes need no padding: rows >= T, reduction rows >= F and columns
// >= D are masked (K = 27 on VGG-19 conv1_1, O = 6 on LeNet-5 conv1, any P).
//
// Design for this card, and what bounds it:
// - The Pallas kernel reduces over the live blocks along an in-order grid
//   axis into VMEM scratch. Hopper blocks run in no order, so here one CUDA
//   block owns one (row-block i, 128-wide column tile j) output tile and the
//   reduction is a loop `k < cnt[i]` over ids[i,k] inside the block, with the
//   8 x 1 accumulators of each thread in registers. Nothing is reduced across
//   blocks, and the block reads its own ids/cnt.
// - Traffic is the danger: in the conv lowering w is the im2col patch
//   matrix, K x P (925 MB in fp32 at VGG-19 conv1_2, batch 8), and every
//   output row-block reads it again. Row-blocks are on blockIdx.x, so the
//   nt row-blocks that share column tile j are scheduled side by side and
//   read the tile from the 50 MB L2 rather than from HBM: device memory sees
//   the patch matrix about once.
// - Per live block the block stages 32-row chunks of its (8 x bf) slice of h
//   (transposed, so a thread reads all 8 rows of one reduction row with a
//   broadcast) and of the (bf x 128) slice of w in shared memory; each of
//   the 128 threads owns one output column and 8 rows: 8 multiply-adds per
//   shared-memory load of w. fp32 FMA on CUDA cores (no TF32: the port holds
//   fp32 parity); bound on the live work by shared-memory loads and the
//   CUDA-core rate, well below the card's 67 TFLOP/s fp32. The simple,
//   correct first kernel; wgmma/TMA come later.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 8;            // rows of a row-block (the pruner's block height)
constexpr int kTileD = 128;       // output columns per block
constexpr int kThreads = kTileD;  // one thread per output column
constexpr int kChunkF = 32;       // reduction rows staged per step

struct BsrParams {
  int t, f, d;  // h (t, f), w (f, d), out (t, d)
  int bf, nf;   // reduction block width, schedule width (ceil(f / bf))
};

__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                  float* __restrict__ out, BsrParams p) {
  __shared__ __align__(16) float hs[kChunkF][kBT];     // h chunk, [f][row]
  __shared__ __align__(16) float ws[kChunkF][kTileD];  // w chunk, [f][col]
  const int i = blockIdx.x;
  const int row0 = i * kBT;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kTileD + tid;

  float acc[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) acc[r] = 0.f;

  // the schedule is the loop bound (the Pallas kernel's @pl.when(k < cnt))
  const int n_live = min(max(cnt[i], 0), p.nf);
  const int32_t* ids_i = ids + (size_t)i * p.nf;
  for (int k = 0; k < n_live; ++k) {
    const int f0 = ids_i[k] * p.bf;
    for (int c0 = 0; c0 < p.bf; c0 += kChunkF) {
      const int nc = min(kChunkF, p.bf - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int l = tid; l < nc * kBT; l += kThreads) {
        const int r = l / nc, fi = l % nc;  // neighbours read neighbouring f
        const int gr = row0 + r, gf = f0 + c0 + fi;
        float v = 0.f;
        if (gr < p.t && (unsigned)gf < (unsigned)p.f) v = h[(size_t)gr * p.f + gf];
        hs[fi][r] = v;
      }
      for (int fi = 0; fi < nc; ++fi) {
        const int gf = f0 + c0 + fi;
        float v = 0.f;
        if (col < p.d && (unsigned)gf < (unsigned)p.f) v = w[(size_t)gf * p.d + col];
        ws[fi][tid] = v;
      }
      __syncthreads();
      for (int fi = 0; fi < nc; ++fi) {
        const float wv = ws[fi][tid];
#pragma unroll
        for (int r = 0; r < kBT; ++r) acc[r] = fmaf(hs[fi][r], wv, acc[r]);
      }
    }
  }

  if (col >= p.d) return;
#pragma unroll
  for (int r = 0; r < kBT; ++r) {
    const int row = row0 + r;
    if (row < p.t) out[(size_t)row * p.d + col] = acc[r];
  }
}

int launch(const float* h, const float* w, const int32_t* ids, const int32_t* cnt,
           float* out, int t, int f, int d, int bt, int bf, int nf, cudaStream_t stream) {
  if (t < 1 || f < 1 || d < 1 || bt != kBT || bf < 1 || nf != (f + bf - 1) / bf)
    return (int)cudaErrorInvalidValue;
  const int nt = (t + kBT - 1) / kBT;
  const int nd = (d + kTileD - 1) / kTileD;
  if (nd > 65535) return (int)cudaErrorInvalidValue;
  BsrParams p{t, f, d, bf, nf};
  dim3 grid(nt, nd);  // row-blocks fastest: they share the column tile in L2
  bsr_matmul_kernel<<<grid, kThreads, 0, stream>>>(h, w, ids, cnt, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32: h (T,F), w (F,D), ids (ceil(T/8), nf), cnt (ceil(T/8),) -> out (T,D).
int repro_bsr_matmul_f32(const float* h, const float* w, const int32_t* ids,
                         const int32_t* cnt, float* out, int t, int f, int d,
                         int bt, int bf, int nf, void* stream) {
  return launch(h, w, ids, cnt, out, t, f, d, bt, bf, nf, (cudaStream_t)stream);
}

}  // extern "C"
