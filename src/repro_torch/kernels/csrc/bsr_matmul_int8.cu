// int8 block-sparse matmul on Hopper's int8 tensor cores (sm_90a):
// y = h @ w over the (8, bf) blocks of h that the per-row-block schedule
// keeps, with exact int32 sums.
//
// Replaces the TPU kernel
//   repro/quant/kernels.py bsr_matmul_int8_pallas
// as the entry point `repro_bsr_matmul_i8`.
//
// What it computes (the Pallas kernel's function): h (T,F) and w (F,D), both
// int8 and row-major; row-block i (rows [8i, 8i+8)) sums only over the
// reduction blocks ids[i, 0..cnt[i]) of width bf, in int32, and leaves as
// fp32 rescaled in the reference's order:
//   y[r, :] = ((float)(sum_k h[r, ids[i,k]*bf : +bf] @ w[ids[i,k]*bf : +bf, :])
//              * sh[r]) * sw.
// cnt[i] = 0 writes a row-block of zeros. Ragged shapes need no padding:
// rows >= T, reduction rows >= F and columns >= D are masked. In the conv
// lowering (`sparse_weights/conv.py`) h is the pruned, quantized weight
// matrix W (O, K) and w the quantized patch matrix A^T (K, N*oh*ow). The
// integer sums are exact in any order (|acc| <= 127 * 127 * F < 2^31 for
// every VGG-19 layer), so the kernel agrees bitwise with a plain version
// that sums in float64.
//
// What bounds it on this card: the bytes, not the tensor cores (the
// multiply-adds, 2 * live blocks * 8 * bf * D, are a few GOP per layer,
// microseconds at the int8 rate). The bound is reading A^T once (231 MB of
// int8 at VGG-19 conv1_2, batch 8) and writing the fp32 output once. What
// the kernel spends beyond that is mostly the work each staged step costs
// inside the SM: per 32 reduction rows a block transposes its A^T
// fragments and runs 2 MMAs per 16-column tile for each row-block that
// keeps the rows, N being only 8.
//
// Design:
// - out^T = A . W^T on mma.sync m16n8k32 s8: M = output columns (the long P
//   axis), N = the 8 rows of one row-block (the pruner's block height is
//   exactly the MMA's n8), K = the scheduled reduction rows.
// - A block owns R = 8 row-blocks and 256 output columns, and streams A^T
//   once for all of them: it stages the union of their schedules (blocks in
//   ascending order, with the set of row-blocks keeping each), and each
//   row-block runs its MMAs only on the steps whose blocks it keeps (a
//   warp-uniform branch), so every row-block keeps its own skip. At density
//   0.3 the union of 8 schedules covers about 1 - 0.7^8 = 94% of the blocks
//   but is read once instead of by 8 x 0.3 = 2.4 row-blocks, and the
//   transposed A fragments serve every row-block that keeps them. R = 1
//   (each row-block alone, sharing A^T only through L2) measured slower on
//   the served layers; where 8 row-blocks per block would leave SMs idle
//   (conv13 at batch 8: 56 blocks) R = 2. Row groups are on blockIdx.x, so
//   the groups that share a column tile also share it in L2.
// - A staged step is 64 union rows, two MMA steps. On the served layers
//   (bf = 128, F and D multiples of 16) it is 64 contiguous rows of one
//   block: A^T and each row-block's W rows are copied as they lie, 16 bytes
//   per cp.async, into a 4-deep ring, so three steps load while one
//   multiplies. Otherwise (bf < 64: VGG-19 conv1 has bf = 8, F = 27; ragged
//   or unaligned operands) a step goes row by row through the union table,
//   with W words zeroed where a row-block's schedule leaves their block out
//   and byte loads of A^T where 16-byte copies do not fit.
// - A operand: A^T is P-contiguous but the fragment wants 4 K-contiguous
//   bytes per output column, and ldmatrix cannot transpose bytes. Each
//   thread reads four 32-bit words (4 columns at 4 consecutive k) and
//   transposes the 4x4 bytes in registers (prmt); the four words are the
//   fragments of two m16 tiles whose rows interleave (rows g and g + 8 of
//   tile j are columns 4g + 2j and 4g + 2j + 1). 16-byte chunks of a staged
//   row are XOR-swizzled by (row / 4), so the four k-rows a warp reads fall
//   in distinct banks; staged W rows are padded to 80 bytes for the same
//   reason.
// - 8 warps, each 32 output columns x the group's row-blocks: per MMA step
//   8 shared loads and 16 byte permutes for A, then 2 shared loads and 2
//   MMAs for each row-block that keeps the step.
//
// Launch hygiene: the entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace int8mma;

constexpr int kBT = 8;                // rows of a row-block (MMA n8)
constexpr int kThreads = 256;         // 8 warps, 32 output columns each
constexpr int kCols = 256;            // output columns per block
constexpr int kK = 32;                // reduction rows per MMA step
constexpr int kKS = 64;               // reduction rows per staged step
constexpr int kStages = 4;            // cp.async ring depth
constexpr int kAStage = kKS * kCols;  // A^T bytes per step
constexpr int kWRow = kKS + 16;       // a staged W row, padded (conflict-free b0/b1)

// Bytes of one staged step of a block of R row-blocks: 21,504 at R = 8.
__host__ __device__ constexpr int stage_bytes(int R) { return kAStage + R * kBT * kWRow; }

struct Params {
  int t, f, d;  // h (t, f), w (f, d), out (t, d)
  int bf, nf;   // reduction block width, schedule width (ceil(f / bf))
  int nt;       // row-blocks
  int fast;     // bf % kKS == 0, F and D % 16 == 0, 16-byte aligned: a step
                // is kKS contiguous rows of one block, staged in 16-byte copies
};

// Byte offset of column byte cc (0..255) of staged A^T row v (0..kKS-1):
// 16-byte chunks XOR-swizzled by bits 2-3 of v.
__device__ __forceinline__ int a_off(int v, int cc) {
  return v * kCols + ((((cc >> 4) ^ (((v >> 2) & 3) << 1))) << 4) + (cc & 15);
}

// Byte offset of reduction byte k of staged W row n of row-block r.
__device__ __forceinline__ int w_off(int r, int n, int k) {
  return kAStage + (r * kBT + n) * kWRow + k;
}

// The union of the group's schedules, in shared memory: ublk[k] is the k-th
// reduction block any of the group's row-blocks keeps (ascending), umask[k]
// the row-blocks that keep it; n blocks, n * bf virtual rows.
struct Union {
  const int* ublk;
  const uint32_t* umask;
  int n;
};

// Reduction row of virtual row vr (< n * bf), or -1 past F; *mask gets the
// row-blocks that keep its block.
__device__ __forceinline__ int union_row(const Union& u, int vr, const Params& p,
                                         uint32_t* mask) {
  const int k = vr / p.bf;
  *mask = u.umask[k];
  const int row = u.ublk[k] * p.bf + (vr - k * p.bf);
  return row < p.f ? row : -1;
}

// Stage a step that is kKS contiguous rows f0.. of one block: the A^T rows
// and every row-block's W rows as they lie (a row-block that does not keep
// the block skips its MMAs, so its W values are never used).
template <int R>
__device__ __forceinline__ void stage_fast(unsigned char* st, const int8_t* __restrict__ h,
                                           const int8_t* __restrict__ w, int f0, int rb0,
                                           int col0, const Params& p) {
  const int tid = threadIdx.x;
  const int cc = (tid & 15) * 16, col = col0 + cc;
#pragma unroll
  for (int i = 0; i < kKS / 16; ++i) {
    const int v = (tid >> 4) + 16 * i, f = f0 + v;
    const bool ok = f < p.f && col < p.d;
    cp_async16(smem_addr(st + a_off(v, cc)), ok ? w + (size_t)f * p.d + col : w, ok);
  }
  for (int l = tid; l < R * kBT * (kKS / 16); l += kThreads) {
    const int r = l / (kBT * (kKS / 16)), n = (l / (kKS / 16)) % kBT, c = l % (kKS / 16);
    const int row = (rb0 + r) * kBT + n, f = f0 + 16 * c;
    const bool ok = row < p.t && f < p.f;
    cp_async16(smem_addr(st + w_off(r, n, 16 * c)), ok ? h + (size_t)row * p.f + f : h, ok);
  }
}

// Stage step s in general (any bf, ragged or unaligned operands): row by
// row through the union table; W words are zero where a row-block's
// schedule leaves their block out. V = 16: 16-byte copies of A^T (D a
// multiple of 16), V = 1: byte loads.
template <int V, int R>
__device__ void stage_gen(unsigned char* st, const int8_t* __restrict__ h,
                          const int8_t* __restrict__ w, const Union& un, int s, int rb0,
                          int col0, const Params& p) {
  const int tid = threadIdx.x;
  const int n_rows = un.n * p.bf;
  constexpr int kPerRow = kCols / V;
  const int cc = (tid % kPerRow) * V, col = col0 + cc;
  for (int v = tid / kPerRow; v < kKS; v += kThreads / kPerRow) {
    const int vr = s * kKS + v;
    uint32_t m = 0;
    const int f = vr < n_rows ? union_row(un, vr, p, &m) : -1;
    if constexpr (V == 1) {
      int8_t val = 0;
      if (f >= 0 && col < p.d) val = w[(size_t)f * p.d + col];
      st[a_off(v, cc)] = (unsigned char)val;
    } else {
      const bool ok = f >= 0 && col < p.d;  // D % 16 == 0: a copy is all in or all out
      cp_async16(smem_addr(st + a_off(v, cc)), ok ? w + (size_t)f * p.d + col : w, ok);
    }
  }
  for (int l = tid; l < R * kBT * (kKS / 4); l += kThreads) {
    const int r = l / (kBT * (kKS / 4)), n = (l / (kKS / 4)) % kBT, kq = l % (kKS / 4);
    const int row = (rb0 + r) * kBT + n;
    uint32_t word = 0;
    for (int e = 0; e < 4; ++e) {
      const int vr = s * kKS + 4 * kq + e;
      uint32_t m = 0;
      const int f = vr < n_rows && row < p.t ? union_row(un, vr, p, &m) : -1;
      if (f >= 0 && ((m >> r) & 1))
        word |= (uint32_t)(uint8_t)h[(size_t)row * p.f + f] << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(st + w_off(r, n, 4 * kq)) = word;
  }
}

// R row-blocks per block (8, or 2 when the grid would leave SMs idle).
template <int V, int R>
__global__ void __launch_bounds__(kThreads, 2)
bsr_matmul_i8_kernel(const int8_t* __restrict__ h, const int8_t* __restrict__ w,
                     const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                     const float* __restrict__ sh, const float* __restrict__ sw,
                     float* __restrict__ out, Params p) {
  constexpr int kStageBytes = stage_bytes(R);
  extern __shared__ __align__(128) unsigned char smem[];
  // [kStages steps][umask: nf words][ublk: nf ints][n_union]
  uint32_t* umask = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  int* ublk = reinterpret_cast<int*>(umask + p.nf);
  int* n_union = ublk + p.nf;
  const int rb0 = blockIdx.x * R;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the union of the group's schedules (the Pallas kernel's
  // @pl.when(k < cnt), per row-block): mark, then compact in order
  for (int k = tid; k < p.nf; k += kThreads) umask[k] = 0;
  __syncthreads();
  for (int r = 0; r < R && rb0 + r < p.nt; ++r) {
    const int live = min(max(cnt[rb0 + r], 0), p.nf);
    for (int k = tid; k < live; k += kThreads)
      atomicOr(&umask[ids[(size_t)(rb0 + r) * p.nf + k]], 1u << r);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < p.nf; k0 += 32) {
      const int k = k0 + lane;
      const uint32_t m = k < p.nf ? umask[k] : 0u;
      const unsigned live = __ballot_sync(0xffffffffu, m != 0);
      const int at = n + __popc(live & ((1u << lane) - 1));
      __syncwarp();
      if (m != 0) {  // at <= k: every lane has read its slot before any lane writes
        ublk[at] = k;
        umask[at] = m;
      }
      __syncwarp();
      n += __popc(live);
    }
    if (lane == 0) *n_union = n;
  }
  __syncthreads();
  const Union un{ublk, umask, *n_union};
  const int n_rows = un.n * p.bf;
  const int n_steps = (n_rows + kKS - 1) / kKS;
  const bool fast = V == 16 && p.fast;
  const int steps_per_block = fast ? p.bf / kKS : 1;

  int32_t acc[R][2][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][j][c] = 0;

  auto stage = [&](int s) {
    unsigned char* st = smem + (s % kStages) * kStageBytes;
    if (fast) {
      const int k = s / steps_per_block;
      stage_fast<R>(st, h, w, ublk[k] * p.bf + (s - k * steps_per_block) * kKS, rb0, col0, p);
    } else {
      stage_gen<V, R>(st, h, w, un, s, rb0, col0, p);
    }
  };

  // A: this thread reads column quad g of its warp's 32 columns (16-byte
  // chunk 2*warp + (g >> 2)), swizzled by t, since rows 4t+i and 16+4t+i
  // (mod 32) have (row >> 2) & 3 == t
  const int a_col = ((((2 * warp + (g >> 2)) ^ (t << 1))) << 4) + ((g & 3) << 2);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s-1's buffer is free
    if (s + kStages - 1 < n_steps) stage(s + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (s % kStages) * kStageBytes;
    // the row-blocks that keep the step's block (warp-uniform)
    const uint32_t live_step = fast ? un.umask[s / steps_per_block] : 0u;
#pragma unroll
    for (int ks = 0; ks < kKS / kK; ++ks) {
      const int vr = s * kKS + ks * kK;
      uint32_t live = live_step;
      if (!fast) {  // a step may span several blocks: each MMA step's own
        if (vr >= n_rows) break;
        for (int k = vr / p.bf; k <= min((vr + kK - 1) / p.bf, un.n - 1); ++k)
          live |= un.umask[k];
      }
      uint32_t x[2][4];  // [k half][column 4g + j]
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const unsigned char* base = st + (ks * kK + 16 * kh + 4 * t) * kCols + a_col;
        transpose4x4(*reinterpret_cast<const uint32_t*>(base),
                     *reinterpret_cast<const uint32_t*>(base + kCols),
                     *reinterpret_cast<const uint32_t*>(base + 2 * kCols),
                     *reinterpret_cast<const uint32_t*>(base + 3 * kCols), x[kh]);
      }
      // tile j: fragment row g is column 4g + 2j, row g + 8 column 4g + 2j + 1
      const uint32_t a0[4] = {x[0][0], x[0][1], x[1][0], x[1][1]};
      const uint32_t a1[4] = {x[0][2], x[0][3], x[1][2], x[1][3]};
      uint32_t b[R][2];  // loaded before the branches, so the loads overlap
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned char* wb = st + w_off(r, g, ks * kK + 4 * t);
        b[r][0] = *reinterpret_cast<const uint32_t*>(wb);
        b[r][1] = *reinterpret_cast<const uint32_t*>(wb + 16);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((live >> r) & 1)) continue;
        mma_s8(acc[r][0], a0, b[r][0], b[r][1]);
        mma_s8(acc[r][1], a1, b[r][0], b[r][1]);
      }
    }
  }

  // epilogue: of tile j, fragment (row g, col 2t + e) is output row
  // (rb0 + r) * 8 + 2t + e, column col0 + 32*warp + 4g + 2j, and fragment
  // row g + 8 the next column
  const float s_w = sw[0];
  const int c0 = col0 + 32 * warp + 4 * g;
  const bool vec = (p.d & 3) == 0 && c0 + 3 < p.d;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = (rb0 + r) * kBT + 2 * t + e;
      if (row >= p.t) continue;
      const float s_r = sh[row];
      const float f[4] = {((float)acc[r][0][e] * s_r) * s_w,
                          ((float)acc[r][0][2 + e] * s_r) * s_w,
                          ((float)acc[r][1][e] * s_r) * s_w,
                          ((float)acc[r][1][2 + e] * s_r) * s_w};
      float* dst = out + (size_t)row * p.d + c0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < p.d) dst[j] = f[j];
      }
    }
  }
}

template <int V, int R>
int launch_vr(int nd, cudaStream_t stream, const int8_t* h, const int8_t* w,
              const int32_t* ids, const int32_t* cnt, const float* sh, const float* sw,
              float* out, const Params& p) {
  const size_t smem = (size_t)kStages * stage_bytes(R) + (2 * (size_t)p.nf + 1) * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      bsr_matmul_i8_kernel<V, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.nt + R - 1) / R, nd);  // row groups fastest: they share the column tile in L2
  bsr_matmul_i8_kernel<V, R><<<grid, kThreads, smem, stream>>>(h, w, ids, cnt, sh, sw, out, p);
  return (int)cudaGetLastError();
}

// 8 row-blocks per block share each staged A^T tile; when that grid would
// leave SMs idle (few row-blocks and columns: conv13 at batch 8), 2.
template <int V>
int launch_v(int nd, cudaStream_t stream, const int8_t* h, const int8_t* w,
             const int32_t* ids, const int32_t* cnt, const float* sh, const float* sw,
             float* out, const Params& p) {
  if ((long long)((p.nt + 7) / 8) * nd >= sm_count())
    return launch_vr<V, 8>(nd, stream, h, w, ids, cnt, sh, sw, out, p);
  return launch_vr<V, 2>(nd, stream, h, w, ids, cnt, sh, sw, out, p);
}

int launch(const int8_t* h, const int8_t* w, const int32_t* ids, const int32_t* cnt,
           const float* sh, const float* sw, float* out, int t, int f, int d, int bt,
           int bf, int nf, cudaStream_t stream) {
  if (t < 1 || f < 1 || d < 1 || bt != kBT || bf < 1 || nf != (f + bf - 1) / bf)
    return (int)cudaErrorInvalidValue;
  const int nt = (t + kBT - 1) / kBT;
  const int nd = (d + kCols - 1) / kCols;
  if (nd > 65535) return (int)cudaErrorInvalidValue;
  const bool a16 = d % 16 == 0 && ((uintptr_t)w & 15) == 0;
  Params p{t, f, d, bf, nf, nt, 0};
  p.fast = a16 && bf % kKS == 0 && f % 16 == 0 && ((uintptr_t)h & 15) == 0;
  if (a16) return launch_v<16>(nd, stream, h, w, ids, cnt, sh, sw, out, p);
  return launch_v<1>(nd, stream, h, w, ids, cnt, sh, sw, out, p);
}

}  // namespace

extern "C" {

// int8: h (T,F) int8, w (F,D) int8, sh (T,) and sw (1,) fp32 scales -> out
// (T,D) fp32 = ((float)(h @ w over the schedule) * sh[row]) * sw.
int repro_bsr_matmul_i8(const int8_t* h, const int8_t* w, const int32_t* ids,
                        const int32_t* cnt, const float* sh, const float* sw,
                        float* out, int t, int f, int d, int bt, int bf, int nf,
                        void* stream) {
  return launch(h, w, ids, cnt, sh, sw, out, t, f, d, bt, bf, nf, (cudaStream_t)stream);
}

}  // extern "C"
