// Block-sparse matmul for Hopper (sm_90a): y = h @ w, skipping the (bt, bf)
// blocks of h that the per-row-block schedule leaves out.
//
// Replaces the TPU kernels
//   repro/kernels/bsr_matmul/kernel.py bsr_matmul_pallas      -> repro_bsr_matmul_f32
//   repro/quant/kernels.py             bsr_matmul_int8_pallas -> repro_bsr_matmul_i8
// with one device body instantiated for fp32 (fp32 accumulate) and for int8
// (int32 accumulate, flushed as ((float)acc * sh[row]) * sw, the reference's
// order).
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
//   shared-memory load of w. fp32 FMA (no TF32: the port holds fp32 parity)
//   or exact int32 multiply-adds on CUDA cores; bound on the live work by
//   shared-memory loads and the CUDA-core rate, well below the card's
//   67 TFLOP/s fp32 and far below its int8 tensor-core rate. The simple,
//   correct first kernel; wgmma/TMA come later.
// - int8 sums are exact (|acc| <= 127 * 127 * F < 2^31 for every VGG-19
//   layer), so the kernel agrees bitwise with a plain version that sums in
//   float64.
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

__device__ __forceinline__ float mac(float acc, float h, float w) {
  return fmaf(h, w, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int8_t h, int8_t w) {
  return acc + (int32_t)h * (int32_t)w;
}

__device__ __forceinline__ float flush(float acc, const float*, const float*, int) {
  return acc;
}
__device__ __forceinline__ float flush(int32_t acc, const float* sh, const float* sw,
                                       int row) {
  return ((float)acc * sh[row]) * sw[0];
}

// T: operand type (float or int8_t); A: accumulator (float or int32_t).
// sh (T,) per-row and sw (1,) scales of the int8 form (null for fp32).
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const T* __restrict__ h, const T* __restrict__ w,
                  const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                  const float* __restrict__ sh, const float* __restrict__ sw,
                  float* __restrict__ out, BsrParams p) {
  __shared__ __align__(16) T hs[kChunkF][kBT];     // h chunk, [f][row]
  __shared__ __align__(16) T ws[kChunkF][kTileD];  // w chunk, [f][col]
  const int i = blockIdx.x;
  const int row0 = i * kBT;
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kTileD + tid;

  A acc[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) acc[r] = A(0);

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
        T v = T(0);
        if (gr < p.t && (unsigned)gf < (unsigned)p.f) v = h[(size_t)gr * p.f + gf];
        hs[fi][r] = v;
      }
      for (int fi = 0; fi < nc; ++fi) {
        const int gf = f0 + c0 + fi;
        T v = T(0);
        if (col < p.d && (unsigned)gf < (unsigned)p.f) v = w[(size_t)gf * p.d + col];
        ws[fi][tid] = v;
      }
      __syncthreads();
      for (int fi = 0; fi < nc; ++fi) {
        const T wv = ws[fi][tid];
#pragma unroll
        for (int r = 0; r < kBT; ++r) acc[r] = mac(acc[r], hs[fi][r], wv);
      }
    }
  }

  if (col >= p.d) return;
#pragma unroll
  for (int r = 0; r < kBT; ++r) {
    const int row = row0 + r;
    if (row < p.t) out[(size_t)row * p.d + col] = flush(acc[r], sh, sw, row);
  }
}

template <typename T, typename A>
int launch(const T* h, const T* w, const int32_t* ids, const int32_t* cnt,
           const float* sh, const float* sw, float* out, int t, int f, int d,
           int bt, int bf, int nf, cudaStream_t stream) {
  if (t < 1 || f < 1 || d < 1 || bt != kBT || bf < 1 || nf != (f + bf - 1) / bf)
    return (int)cudaErrorInvalidValue;
  const int nt = (t + kBT - 1) / kBT;
  const int nd = (d + kTileD - 1) / kTileD;
  if (nd > 65535) return (int)cudaErrorInvalidValue;
  BsrParams p{t, f, d, bf, nf};
  dim3 grid(nt, nd);  // row-blocks fastest: they share the column tile in L2
  bsr_matmul_kernel<T, A><<<grid, kThreads, 0, stream>>>(h, w, ids, cnt, sh, sw, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32: h (T,F), w (F,D), ids (ceil(T/8), nf), cnt (ceil(T/8),) -> out (T,D).
int repro_bsr_matmul_f32(const float* h, const float* w, const int32_t* ids,
                         const int32_t* cnt, float* out, int t, int f, int d,
                         int bt, int bf, int nf, void* stream) {
  return launch<float, float>(h, w, ids, cnt, nullptr, nullptr, out, t, f, d,
                              bt, bf, nf, (cudaStream_t)stream);
}

// int8: h (T,F) int8, w (F,D) int8, sh (T,) and sw (1,) fp32 scales -> out
// (T,D) fp32 = ((float)(h @ w over the schedule) * sh[row]) * sw.
int repro_bsr_matmul_i8(const int8_t* h, const int8_t* w, const int32_t* ids,
                        const int32_t* cnt, const float* sh, const float* sw,
                        float* out, int t, int f, int d, int bt, int bf, int nf,
                        void* stream) {
  return launch<int8_t, int32_t>(h, w, ids, cnt, sh, sw, out, t, f, d, bt, bf,
                                 nf, (cudaStream_t)stream);
}

}  // extern "C"
