// Block-sparse matmul on Hopper's TF32 tensor cores at fp32 accuracy through
// split-TF32 (sm_90a): y = h @ w, skipping the (8, bf) blocks of h that the
// per-row-block schedule leaves out.
//
// Replaces the TPU kernel
//   repro/kernels/bsr_matmul/kernel.py bsr_matmul_pallas -> repro_bsr_matmul_f32
// (fp32 operands, fp32 out). The int8 form (`repro_bsr_matmul_i8`) has its
// own body in bsr_matmul_int8.cu, whose structure this one carries over.
//
// What it computes (the Pallas kernel's function): h (T,F) and w (F,D)
// row-major; row-block i (rows [8i, 8i+8)) sums only over the reduction
// blocks ids[i, 0..cnt[i]) of width bf:
//   y[r, :] = sum_k h[r, ids[i,k]*bf : +bf] @ w[ids[i,k]*bf : +bf, :].
// A block left out of the schedule contributes nothing; cnt[i] = 0 writes
// a row-block of zeros. A schedule lists each block at most once
// (`guard_schedule` refuses one that repeats a block: the Pallas kernel
// would add it once per listing, this kernel and the plain version once).
// In the conv lowering (`sparse_weights/conv.py`) h is the pruned weight
// matrix W (O, K) and w the patch matrix A^T (K, N*oh*ow).
// Ragged shapes need no padding: rows >= T, reduction rows >= F and columns
// >= D are masked (K = 27 on VGG-19 conv1_1, O = 6 on LeNet-5 conv1, any P).
// fp32 in, fp32 out, within the port's fp32 limit of a plain fp32 sum
// (1e-4 * max|plain| + 1e-5 * min(1, max|plain|)).
//
// What bounds it on this card: the bytes, closely followed by the
// operations. The served pruned VGG-19 at batch 8 reads about 2.9 GB of fp32
// patches (925 MB at conv1_2 alone) against about 0.1 TFLOP of live
// multiply-adds, which split-TF32 (three TF32 products per multiply-add,
// tf32_mma.cuh; 495 / 3 = 165 TFLOP/s) runs in a little less time than HBM
// takes for the bytes. fp32 FMA on the CUDA cores (67 TFLOP/s) would make
// the products the bound; one TF32 product per multiply-add errs past the
// fp32 limit at K = 4608. What holds the kernel above the bound: on the
// shallow layers the A^T stream itself; on the deep ones (T = 512) the L2
// traffic of eight row groups each reading A^T, and the instructions that
// feed mma.sync (fragment loads, splits, per-row-block branches), which the
// double buffer overlaps only in part.
//
// Design (bsr_matmul_int8.cu's, for fp32):
// - out^T = A . W^T on mma.sync m16n8k8 TF32: M = output columns (the long
//   P axis), N = the 8 rows of one row-block (the pruner's block height is
//   exactly the MMA's n8), K = the scheduled reduction rows.
// - A block owns R = 8 row-blocks and 256 output columns and streams A^T
//   once for all of them through the union of their schedules (blocks in
//   ascending order, with the set of row-blocks keeping each); each
//   row-block runs its MMAs only on the steps whose blocks it keeps (a
//   warp-uniform branch), so every row-block keeps its own skip. Where 8
//   row-blocks per block would leave SMs idle (conv13 at batch 8: 56 blocks)
//   R = 4 or 2, the largest whose grid reaches 3/4 of the SMs (conv13: 4;
//   chosen on the card over 2 and 8, whose groups each stream A^T through
//   L2 or leave SMs idle). Row groups are on blockIdx.x, so the groups that
//   share a column tile share it in L2.
// - Balanced groups. Block pruning keeps whole row-blocks or none (half of
//   VGG-19 conv10-13's row-blocks keep no block, a third keep all 36), so
//   groups of consecutive row-blocks would differ threefold in work and the
//   heaviest would set the kernel's time. Each block ranks the row-blocks by
//   count and deals them to the groups in snake order, so every group gets
//   about the mean work; a row-block's sum runs in the same order in any
//   group, so the results do not depend on the grouping. The counts sit in
//   shared memory (one int per row-block), so a launch takes T up to about
//   280,000 rows and refuses more (cudaErrorInvalidValue).
// - Shared memory. A staged step is 32 union rows: A^T 32 x 256 fp32
//   (33 KB with the row padding) and each row-block's 8 x 32 W values
//   (9 KB at R = 8); a double buffer takes 85 KB, so two blocks (16 warps)
//   share an SM and one step loads while the other multiplies. (The int8
//   step of 64 rows x 256 columns is 16 KB; in fp32 it would be 64 KB, and
//   the int8 kernel's four of them exceed a block's 227 KB.) On the card,
//   deeper rings at one block per SM, and 16- or 8-row steps with more
//   barriers per row, were slower at the served shapes: the SM's
//   instruction stream, not the memory, holds this kernel back.
// - Staging. On the served layers (bf = 128, F and D multiples of 4,
//   16-byte aligned) a step is 32 contiguous rows of one block, copied as
//   they lie, 16 bytes per cp.async. Otherwise (bf < 32: VGG-19 conv1_1 has
//   bf = 8, F = 27; ragged or unaligned operands) a step goes row by row
//   through the union table, with W values zero-filled where a row-block's
//   schedule leaves their block out, and 4-byte copies where 16-byte ones
//   do not fit.
// - A fragments. A TF32 A fragment holds A[m][k] at (m = g, k = t),
//   (g + 8, t), (g, t + 4), (g + 8, t + 4); from the P-contiguous A^T these
//   are 32-bit words of rows t and t + 4 at columns g and g + 8. Staged rows
//   are padded to 264 floats (= 8 mod 32 words), so the 32 lanes of each
//   load hit 32 banks; no byte transpose is needed, as it was for int8.
// - The split. Each thread splits its A fragments in registers once after
//   loading them (split: hi = a rounded to TF32, lo = a - hi, truncated
//   by the MMA), holding two MMA steps' worth at a time; the pairs then
//   serve every row-block of the group that keeps the steps, 3 MMAs per m16
//   tile (lo*hi, hi*lo, hi*hi). W values are split as their fragments load
//   (W rows padded to 36 floats: conflict-free), so no split copy of either
//   operand sits in shared memory.
// - 8 warps, each 32 output columns (two m16 tiles) x the group's
//   row-blocks: per two MMA steps 16 shared loads and 16 splits for A, then
//   for each row-block that keeps the steps (one warp-uniform branch) 4
//   loads, 4 splits and 12 MMAs.
//
// Launch hygiene: the entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kBT = 8;                    // rows of a row-block (MMA n8)
constexpr int kThreads = 256;             // 8 warps, 32 output columns each
constexpr int kCols = 256;                // output columns per block
constexpr int kK = 8;                     // reduction rows per MMA step
constexpr int kKS = 32;                   // reduction rows per staged step
constexpr int kStages = 2;                // cp.async ring depth
constexpr int kGroup = 2;                 // MMA steps whose A fragments are held at once
constexpr int kAPitch = kCols + 8;        // floats per staged A^T row (8 mod 32)
constexpr int kWPitch = kKS + 4;          // floats per staged W row (4 x odd)
constexpr int kAStage = kKS * kAPitch;    // A^T floats per step

// Floats of one staged step of a block of R row-blocks: 10,752 at R = 8.
__host__ __device__ constexpr int stage_floats(int R) { return kAStage + R * kBT * kWPitch; }

struct Params {
  int t, f, d;  // h (t, f), w (f, d), out (t, d)
  int bf, nf;   // reduction block width, schedule width (ceil(f / bf))
  int nt;       // row-blocks
  int fast;     // bf % kKS == 0, F % 4 == 0, h 16-byte aligned (with V = 4):
                // a step is kKS contiguous rows of one block
};

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
// and every row-block's W values as they lie (a row-block that does not
// keep the block skips its MMAs, so its W values are never used).
template <int R>
__device__ __forceinline__ void stage_fast(float* st, const float* __restrict__ h,
                                           const float* __restrict__ w, int f0,
                                           const int* rbs, int col0, const Params& p) {
  const int tid = threadIdx.x;
  const int cc = (tid & 63) * 4, col = col0 + cc;
#pragma unroll
  for (int i = 0; i < kKS / 4; ++i) {
    const int v = (tid >> 6) + 4 * i, f = f0 + v;
    const bool ok = f < p.f && col < p.d;  // D % 4 == 0: a copy is all in or all out
    cp_async16(smem_addr(st + v * kAPitch + cc), ok ? w + (size_t)f * p.d + col : w, ok);
  }
  for (int l = tid; l < R * kBT * (kKS / 4); l += kThreads) {
    const int rr = l / (kKS / 4), c = l % (kKS / 4);  // rr = r * 8 + n
    const int rb = rbs[rr / kBT], row = rb * kBT + rr % kBT, f = f0 + 4 * c;
    const bool ok = rb >= 0 && row < p.t && f < p.f;  // F % 4 == 0
    cp_async16(smem_addr(st + kAStage + rr * kWPitch + 4 * c),
               ok ? h + (size_t)row * p.f + f : h, ok);
  }
}

// Stage step s in general (any bf, ragged or unaligned operands): row by
// row through the union table; W values are zero-filled where a row-block's
// schedule leaves their block out. V = 4: 16-byte copies of A^T (D a
// multiple of 4, w aligned), V = 1: 4-byte copies.
template <int V, int R>
__device__ void stage_gen(float* st, const float* __restrict__ h, const float* __restrict__ w,
                          const Union& un, int s, const int* rbs, int col0,
                          const Params& p) {
  const int tid = threadIdx.x;
  const int n_rows = un.n * p.bf;
  constexpr int kPerRow = kCols / V;
  const int cc = (tid % kPerRow) * V, col = col0 + cc;
  for (int v = tid / kPerRow; v < kKS; v += kThreads / kPerRow) {
    const int vr = s * kKS + v;
    uint32_t m = 0;
    const int f = vr < n_rows ? union_row(un, vr, p, &m) : -1;
    const bool ok = f >= 0 && col < p.d;
    const float* src = ok ? w + (size_t)f * p.d + col : w;
    if constexpr (V == 1) {
      cp_async4(smem_addr(st + v * kAPitch + cc), src, ok);
    } else {
      cp_async16(smem_addr(st + v * kAPitch + cc), src, ok);
    }
  }
  for (int l = tid; l < R * kBT * kKS; l += kThreads) {
    const int rr = l / kKS, k = l % kKS;
    const int rb = rbs[rr / kBT], row = rb * kBT + rr % kBT, vr = s * kKS + k;
    uint32_t m = 0;
    const int f = rb >= 0 && vr < n_rows && row < p.t ? union_row(un, vr, p, &m) : -1;
    const bool ok = f >= 0 && ((m >> (rr / kBT)) & 1);
    cp_async4(smem_addr(st + kAStage + rr * kWPitch + k), ok ? h + (size_t)row * p.f + f : h,
              ok);
  }
}

// R row-blocks per block (8, 4 or 2: launch_v).
template <int V, int R>
__global__ void __launch_bounds__(kThreads, 2)
bsr_matmul_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                  float* __restrict__ out, Params p) {
  constexpr int kStageFloats = stage_floats(R);
  extern __shared__ __align__(128) float smem[];
  // [kStages steps][umask: nf words][ublk: nf ints][n_union][rbs: R ints]
  // [row-blocks' counts: nt ints]
  uint32_t* umask = reinterpret_cast<uint32_t*>(smem + kStages * kStageFloats);
  int* ublk = reinterpret_cast<int*>(umask + p.nf);
  int* n_union = ublk + p.nf;
  int* rbs = n_union + 1;  // the group's row-blocks, -1 for an empty slot
  int* cnts = rbs + R;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the group's row-blocks (balanced groups): rank by count, heaviest
  // first, and deal in snake order (group 0..G-1, then G-1..0, ...)
  const int n_groups = gridDim.x;
  for (int r = tid; r < R; r += kThreads) rbs[r] = -1;
  for (int i = tid; i < p.nt; i += kThreads) cnts[i] = min(max(cnt[i], 0), p.nf);
  __syncthreads();
  for (int i = tid; i < p.nt; i += kThreads) {
    const int ci = cnts[i];
    int rank = 0;
    for (int j = 0; j < p.nt; ++j) rank += cnts[j] > ci || (cnts[j] == ci && j < i);
    const int round = rank / n_groups, pos = rank - round * n_groups;
    if (((round & 1) ? n_groups - 1 - pos : pos) == (int)blockIdx.x) rbs[round] = i;
  }
  // the union of the group's schedules (the Pallas kernel's
  // @pl.when(k < cnt), per row-block): mark, then compact in order
  for (int k = tid; k < p.nf; k += kThreads) umask[k] = 0;
  __syncthreads();
  for (int r = 0; r < R; ++r) {
    const int rb = rbs[r];
    if (rb < 0) continue;
    const int live = min(max(cnt[rb], 0), p.nf);
    for (int k = tid; k < live; k += kThreads) {
      const int id = ids[(size_t)rb * p.nf + k];
      if ((unsigned)id < (unsigned)p.nf) atomicOr(&umask[id], 1u << r);
    }
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
  const bool fast = V == 4 && p.fast;
  const int steps_per_block = fast ? p.bf / kKS : 1;

  float acc[R][2][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][j][c] = 0.f;

  auto stage = [&](int s) {
    float* st = smem + (s % kStages) * kStageFloats;
    if (fast) {
      const int k = s / steps_per_block;
      stage_fast<R>(st, h, w, ublk[k] * p.bf + (s - k * steps_per_block) * kKS, rbs, col0, p);
    } else {
      stage_gen<V, R>(st, h, w, un, s, rbs, col0, p);
    }
  };

  // A: rows t and t + 4 of an MMA step, columns g and g + 8 of m16 tile j
  // of this warp's 32 columns; W: row g of each row-block, columns t, t + 4
  const int a_off = t * kAPitch + 32 * warp + g;
  const int w_off = kAStage + g * kWPitch + t;

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

    const float* st = smem + (s % kStages) * kStageFloats;
    // the row-blocks that keep the step's block (warp-uniform)
    const uint32_t live_step = fast ? un.umask[s / steps_per_block] : 0u;
#pragma unroll
    for (int hs = 0; hs < kKS / (kGroup * kK); ++hs) {
      const int vr = s * kKS + hs * kGroup * kK;
      uint32_t live = live_step;
      if (!fast) {  // a step may span several blocks: the row-blocks that keep
                    // any of them run; W is zero where one leaves its block out
        if (vr >= n_rows) break;
        for (int k = vr / p.bf; k <= min((vr + kGroup * kK - 1) / p.bf, un.n - 1); ++k)
          live |= un.umask[k];
      }
      // A fragments of kGroup MMA steps, split once for every row-block
      uint32_t ah[kGroup][2][4], al[kGroup][2][4];
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* a = st + (hs * kGroup + q) * kK * kAPitch + a_off + 16 * j;
          split(a[0], ah[q][j][0], al[q][j][0]);
          split(a[8], ah[q][j][1], al[q][j][1]);
          split(a[4 * kAPitch], ah[q][j][2], al[q][j][2]);
          split(a[4 * kAPitch + 8], ah[q][j][3], al[q][j][3]);
        }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((live >> r) & 1)) continue;
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const float* wb = st + w_off + r * kBT * kWPitch + (hs * kGroup + q) * kK;
          uint32_t bh[2], bl[2];
          split(wb[0], bh[0], bl[0]);
          split(wb[4], bh[1], bl[1]);
          mma_split(acc[r][0], ah[q][0], al[q][0], bh, bl);
          mma_split(acc[r][1], ah[q][1], al[q][1], bh, bl);
        }
      }
    }
  }

  // epilogue: of m16 tile j, fragment (row g (+8), col 2t + e) is output
  // row rbs[r] * 8 + 2t + e, column col0 + 32 * warp + 16j + g (+8):
  // each store of the warp fills four 32-byte sectors
  const int c0 = col0 + 32 * warp + g;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rb = rbs[r], row = rb * kBT + 2 * t + e;
      if (rb < 0 || row >= p.t) continue;
      float* dst = out + (size_t)row * p.d;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = c0 + 16 * j + 8 * hf;
          if (col < p.d) dst[col] = acc[r][j][2 * hf + e];
        }
    }
  }
}

template <int V, int R>
int launch_vr(int nd, cudaStream_t stream, const float* h, const float* w,
              const int32_t* ids, const int32_t* cnt, float* out, const Params& p) {
  static std::atomic<int> allowed[kMaxDevices];
  const size_t smem = (size_t)kStages * stage_floats(R) * sizeof(float) +
                      (2 * (size_t)p.nf + 1 + R + (size_t)p.nt) * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem((const void*)bsr_matmul_kernel<V, R>, (int)smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.nt + R - 1) / R, nd);  // row groups fastest: they share the column tile in L2
  bsr_matmul_kernel<V, R><<<grid, kThreads, smem, stream>>>(h, w, ids, cnt, out, p);
  return (int)cudaGetLastError();
}

// The most row-blocks per block (8, 4, 2) whose grid reaches 3/4 of the
// SMs: every group shares its staged A^T steps, but too few blocks leave
// SMs idle (conv13 at batch 8 takes 4: 112 blocks).
template <int V>
int launch_v(int nd, cudaStream_t stream, const float* h, const float* w,
             const int32_t* ids, const int32_t* cnt, float* out, const Params& p) {
  const long long want = 3LL * sm_count() / 4;
  if ((long long)((p.nt + 7) / 8) * nd >= want)
    return launch_vr<V, 8>(nd, stream, h, w, ids, cnt, out, p);
  if ((long long)((p.nt + 3) / 4) * nd >= want)
    return launch_vr<V, 4>(nd, stream, h, w, ids, cnt, out, p);
  return launch_vr<V, 2>(nd, stream, h, w, ids, cnt, out, p);
}

int launch(const float* h, const float* w, const int32_t* ids, const int32_t* cnt,
           float* out, int t, int f, int d, int bt, int bf, int nf, cudaStream_t stream) {
  if (t < 1 || f < 1 || d < 1 || bt != kBT || bf < 1 || nf != (f + bf - 1) / bf)
    return (int)cudaErrorInvalidValue;
  const int nt = (t + kBT - 1) / kBT;
  const int nd = (d + kCols - 1) / kCols;
  if (nd > 65535) return (int)cudaErrorInvalidValue;
  const bool a16 = d % 4 == 0 && ((uintptr_t)w & 15) == 0;
  Params p{t, f, d, bf, nf, nt, 0};
  p.fast = a16 && bf % kKS == 0 && f % 4 == 0 && ((uintptr_t)h & 15) == 0;
  if (a16) return launch_v<4>(nd, stream, h, w, ids, cnt, out, p);
  return launch_v<1>(nd, stream, h, w, ids, cnt, out, p);
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
