// GQA flash-attention backward for Hopper (sm_90a): the two passes of the
// reference's two-pass flash backward, fp32 on the TF32 tensor cores in
// split-TF32, bf16 on the bf16 tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_bwd_pallas, one entry point per pallas_call site and operand type:
//   :265 (_dq_kernel)  -> repro_flash_bwd_dq_f32,  flash_bwd_dq_kernel<D>
//                         repro_flash_bwd_dq_bf16, flash_bwd_dq_bf16_kernel<D, BM>
//   :284 (_dkv_kernel) -> repro_flash_bwd_dkv_f32, flash_bwd_dkv_kernel<D>
//                         repro_flash_bwd_dkv_bf16, flash_bwd_dkv_bf16_kernel<D, BN>
// The fp32 passes run on the TF32 tensor cores in split-TF32 (the design
// below); the bf16 passes (the training step at the reference's default
// bfloat16) on the bf16 tensor cores in FlashAttention-2's layout, with the
// reference's rounding points (the bf16 section further down; the dv
// product keeps p in fp32 through a bf16 hi + lo split).
//
// What bounds the bf16 passes (989 TFLOP/s of bf16, 3.35 TB/s): at the
// trained shape (qwen3-0.6b layer 0, B8, S128, KV 8, G 2, D 128, causal)
// each moves about 17 MB (0.0051 ms) against 0.001 ms of operations, so
// bytes bound it on paper, and in practice latency: 128-512 blocks, a
// prologue that waits for the first tiles of every block at once (about
// the bytes bound), then a serial chain of tiles per warp (8 row tiles for
// the first keys in dk/dv) in which each step waits on dependent MMAs,
// exp2 and a barrier. At the long shape (B4, 2048^2 causal) the work is
// 0.104 (dq) and 0.139 ms (dk/dv) against 0.04 ms of bytes: operations. The
// first bf16 passes reused the fp32 passes' geometry and lost 2x to
// SDPA's backward at the trained shape; the redesign answers each cause:
//  1. Every warp staged its own K/V (dq) or Q/dO (dk/dv) chunks, so a block
//     shared nothing, and the block's own tile loaded synchronously: now
//     one two-stage cp.async ring per block feeds all its warps, and the
//     own tile is copied by cp.async ahead of the first ring stage.
//  2. B fragments were gathered one bf16 at a time (two scalar shared loads
//     and a pack per register): now ldmatrix.x4 for S, dP, S^T, dP^T and
//     ldmatrix.x4.trans for ds.K, dS^T.Q and P^T.dO, conflict-free on rows
//     of D + 8 elements.
//  3. A fragments were re-read from shared memory at every step: dq keeps Q
//     and dO, dk/dv K and V, in registers across steps at D <= 128.
//  4. Four warps split the keys (dq) or rows (dk/dv) and summed their
//     partials through shared memory: now every output element has one
//     owning warp (16 rows of dq; half the columns of 16 keys' dK and dV),
//     which writes it from its registers.
//  5. A warp did at most two chunk steps at the trained shape and most
//     warps of the first row tiles idled under the causal mask: now every
//     warp walks the block's whole visible range, blocks launch heaviest
//     first, and dk/dv gives each 16 keys two warps, so its longest chain
//     (the first keys, which every row sees) runs at twice the warps.
//
// What it computes (the Pallas kernels' function): with the forward's m and
// l (l already max(l, 1e-30)), delta = rowsum(do * out) (formed outside, as
// the reference does), and for every kv head bkv, group g, query position s
// (qpos = q_offset + s) and key k < Sk:
//   s[k]  = (q[bkv,g,s,:] * scale) . k[bkv,k,:], masked to NEG = -1e30 where
//           (causal and qpos < k) or k >= kv_len,
//   p[k]  = exp(s[k] - m) / max(l, 1e-30),
//   dp[k] = do[bkv,g,s,:] . v[bkv,k,:],   ds[k] = p[k] * (dp[k] - delta),
//   dq[bkv,g,s,:] = scale * sum_k ds[k] k[bkv,k,:]
//   dk[bkv,k,:]   = sum_{g,s} ds[k] (scale * q[bkv,g,s,:])   (no second scale)
//   dv[bkv,k,:]   = sum_{g,s} p[k] do[bkv,g,s,:]
// A fully masked row (m = NEG) spreads p = 1/l over all Sk keys, as in the
// reference, because the mask is -1e30 and not -inf. fp32 within the port's
// limit of the plain version (1e-4 * max|plain| + 1e-5 * min(1, max|plain|));
// bf16 within 2^-7 * max|plain| (one bf16 ulp at the largest value) of
// dq, dk and dv.
//
// Layout: q, do and dq are read / written through (b, h, g, s) element
// strides, k, v, dk and dv through (b, h, s) strides, with bkv = b * nh + h
// (nh = 1 for the (BKV, G, Sq, D) / (BKV, Sk, D) layout of the Pallas kernels,
// nh = KV for the model's (B, Sq, KV, G, D) / (B, Sk, KV, D)); the head dim is
// contiguous. m, l and delta are (BKV, G, Sq), contiguous.
//
// What bounds the fp32 passes on this card (H100 SXM: 3.35 TB/s, 495 TFLOP/s
// of TF32, so 165 TFLOP/s at three products per multiply-add): dq does 6 and
// dk/dv 8 fp32 operations per visible (q, k) pair and head-dim element. At
// the trained shape (qwen3-0.6b, B8, S128, KV 8, G 2, D 128, causal) that is
// 0.0049 / 0.0066 ms of split-TF32 work against 0.0100 ms for the 33.5 MB
// each pass must move: bytes, by a little. At the long shape (B4, S 2048
// causal) the work is 0.63 / 0.83 ms against 0.08 ms of bytes: operations.
// In practice neither: a warp's 16 x 16 step is a chain of dependent
// products and exp with two warps per SM sub-partition to hide it, each
// step reads about 3.5x its new operands' bytes from shared memory (the A
// fragments of S and dP are read again for every step), and the split
// costs three ALU instructions per operand element, so tensor cores,
// shared-memory bandwidth and instruction issue share the time, none of
// them saturated; at the trained shape a warp takes at most 4 steps, and
// the prologue (staging) and epilogue (the fixed-order sums) weigh a large
// share of a block's time.
//
// Design of the fp32 passes:
// - Every product runs on mma.sync m16n8k8 TF32 in split-TF32
//   (tf32_mma.cuh: a = hi + lo, three products lo*hi + hi*lo + hi*hi per
//   multiply-add): S = Q.K^T, dP = dO.V^T, dQ = dS.K, dK = dS^T.Q and
//   dV = P^T.dO. One TF32 product misses the fp32 limit on every gradient
//   the product feeds, the scores above all, since p = exp(s - m) / l reads
//   the forward's split-TF32 m and l (host emulation in
//   tests/test_torch_kernels.py). p is formed as exp2((s - m) log2 e) times
//   the row's 1 / l (a subtraction, two multiplies and exp2), within a few
//   ulp of the quotient: expf and a true division sat on every step's
//   critical path.
// - dq pass, the forward's body: a block owns 16 (position, group) rows of
//   one kv head, flattened as row = s * G + g (16 x 64 = 1024 blocks at the
//   trained shape; a 64-row tile would read K and V a quarter as often but
//   leave 256 blocks, under two per SM). Q (scaled) and dO are split and
//   staged once per block. Its 4 warps split the keys in 16-key chunks
//   (c = w, w + 4, ...): a warp forms dP and S, then p and ds in registers,
//   and adds ds.K into its own 16 x D dq. ds feeds the MMA from registers by
//   a renaming: in a C fragment a lane holds keys 2t, 2t + 1 of rows g,
//   g + 8, read as reduction indices t, t + 4 and matched by K's rows 2t,
//   2t + 1 for B. p is exact from the forward's m and l, so the 4 partial
//   dq tiles need no rescale: they are summed in one fixed order through
//   shared memory and scaled once.
// - dk/dv pass, transposed: a block owns 16 keys of one kv head (16 x 8 x 8
//   = 512 blocks at the trained shape), K and V split and staged once while
//   the warps' first chunks load. Its 4 warps split the flattened query
//   rows in 16-row chunks; a warp forms S^T = K.Q^T and dP^T = V.dO^T with
//   each column's m, l and delta, and adds P^T.dO into dV and dS^T.Q into
//   dK (scaled once at the end, as dq is), P^T and dS^T fed from registers
//   by the same renaming (B = dO's and Q's rows 2t, 2t + 1). Each key tile
//   has one owner: the 4 warps' partial dK and dV are summed in one fixed
//   order through shared memory, with no atomics, so two launches on the
//   same inputs agree bitwise.
// - Rows: the lane holding row r of a tile or chunk divides it into
//   (position, group) once and loads its m, l and delta (in dk/dv a chunk
//   ahead); the other lanes take offsets and stats by shuffles.
// - Registers: dK and dV for 16 keys x D are D accumulators a lane (128 at
//   D = 128). At D = 256 the pass runs twice over the head dim, 128 output
//   columns at a time, recomputing S^T and dP^T (a third more work at
//   D = 256 only), so no instantiation holds more than 128 accumulators.
// - Staging: per warp, the next chunk's K/V (dq) or Q/dO (dk/dv) rows are
//   copied by cp.async as soon as the warp is done with the buffer, the
//   forward's staggered scheme: in dq the next V loads under S, ds and ds.K,
//   the next K under the next dP; in dk/dv the next Q under dV += P^T.dO,
//   the next dO under the next S^T. A two-stage ring of both operands per
//   warp would take 169 KB at D = 128, one block of 4 warps per SM; this
//   takes 101 KB (192 x (D + 4) floats: 195 KB at D = 256, under the 227 KB
//   a block may have), two blocks per SM. With 16-byte aligned operands and
//   strides the copies are 16 bytes, else 4 (a view off alignment), with the
//   same results. Shared rows are padded to D + 4 floats, which keeps the
//   fragment loads (rows g, columns t; rows 2t, 2t + 1, column g)
//   conflict-free.
// - The exact skip: when every row of the call sees key 0 (kv_len >= 1 and,
//   under the causal mask, q_offset >= 0), the dq pass stops after the last
//   key its rows can see (kv_len, causal diagonal) and the dk/dv pass starts
//   at the first row chunk that can see its keys and visits none for a key
//   tile wholly past kv_len (writing zeros). Once a row has seen one visible
//   key its m is a real score, so a masked key gives p = exp(-1e30 - m) = 0
//   and adds nothing. Otherwise every tile is visited, as the reference does.
// - Ragged edges for any Sq >= 1 and Sk >= 1: keys past Sk and rows past
//   Sq * G are zero-filled, take p = 0, and write nothing.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, raise a kernel's dynamic shared-memory limit
// once per device, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "flash_bf16.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace flashbf16;
using namespace tf32mma;
using bf16mma::split_pair;

constexpr int kTile = 16;   // rows (dq) or keys (dk/dv) a block owns: one m16 tile
constexpr int kChunk = 16;  // keys (dq) or rows (dk/dv) per warp step: two n8 tiles
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;

struct BwdParams {
  int nh, g, sq, sk, rows;       // rows = sq * g, the flattened (s, g) rows
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale;
  float qscale;  // bf16 passes: scale rounded to bf16, the factor of q in the scores
  int vec;  // every operand and row stride 16-byte aligned: 16-byte copies
  long long q_sb, q_sh, q_sg, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_sg, do_ss;
  long long dq_sb, dq_sh, dq_sg, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
};

// Shared floats of either pass: 4 split tiles [16][D+4] (Q, dO hi/lo; or K,
// V hi/lo) and per warp two fp32 chunk buffers [16][D+4].
template <int D>
constexpr int bwd_smem_floats() {
  return (4 * kTile + kWarps * 2 * kChunk) * (D + 4);
}

// The keys all rows can see, when every row of the call sees key 0: the
// tile skips are then exact. Returns kv_lim, or -1 when nothing may be
// skipped.
__device__ __forceinline__ int exact_kv_lim(const BwdParams& p) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  return kv_lim > 0 && (!p.causal || p.q_offset >= 0) ? kv_lim : -1;
}

// Stage the 16 rows of a warp's chunk of one fp32 operand into its [16][D+4]
// buffer by cp.async, by this warp's lanes: lanes r and r + 16 hold the
// element offset `off` of row r in `src` (< 0: past the operand's rows,
// zero-filled), which the others read by shuffles, so no lane divides a
// flattened row into its position and group more than once.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           long long off, bool vec, int lane) {
  constexpr int DP = D + 4;
  if (vec) {
    constexpr int kC = D / 4;
#pragma unroll
    for (int i = lane; i < kChunk * kC; i += 32) {
      const int r = i / kC, c = i - r * kC;
      const long long o = __shfl_sync(0xffffffffu, off, r);
      cp_async16(smem_addr(dst + r * DP + 4 * c), o >= 0 ? src + o + 4 * c : src, o >= 0);
    }
  } else {
    for (int i = lane; i < kChunk * D; i += 32) {
      const int r = i / D, d = i - r * D;
      const long long o = __shfl_sync(0xffffffffu, off, r);
      cp_async4(smem_addr(dst + r * DP + d), o >= 0 ? src + o + d : src, o >= 0);
    }
  }
}

// Stage the 16 rows of a block's tile of one operand, times `mul`, split into
// hi and lo [16][D+4] tiles, by the whole block; as in stage_rows, lanes r
// and r + 16 of every warp hold row r's offset `off` (< 0: zero-filled).
template <int D>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo,
                                            const float* __restrict__ src, long long off,
                                            float mul, bool vec) {
  constexpr int DP = D + 4;
  for (int i = threadIdx.x; i < kTile * (D / 4); i += kThreads) {  // 4D: whole warps
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
    const long long o = __shfl_sync(0xffffffffu, off, r);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (o >= 0) {
      const float* s = src + o + d;
      if (vec) {
        const float4 f = *reinterpret_cast<const float4*>(s);
        x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = s[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e] * mul, hi[r * DP + d + e], lo[r * DP + d + e]);
  }
}

// acc[j] = A (16 x D, split tiles in shared memory, rows g / g + 8) .
// B^T, where B's rows 8j + g (j = 0, 1) are a [16][D+4] fp32 chunk, times
// `mul`, split as their fragments load: the S / dP shape of either pass.
// Two accumulator chains per n8 tile (k-steps alternate), summed at the end.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[2][4], const uint32_t* ahi,
                                             const uint32_t* alo, const float* bc, float mul,
                                             int g, int t) {
  constexpr int DP = D + 4;
  float part[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[a][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int ao = g * DP + 8 * ks + t;
    const uint32_t ah[4] = {ahi[ao], ahi[ao + 8 * DP], ahi[ao + 4], ahi[ao + 8 * DP + 4]};
    const uint32_t al[4] = {alo[ao], alo[ao + 8 * DP], alo[ao + 4], alo[ao + 8 * DP + 4]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* br = bc + (8 * j + g) * DP + 8 * ks + t;
      uint32_t bh[2], bl[2];
      split(br[0] * mul, bh[0], bl[0]);
      split(br[4] * mul, bh[1], bl[1]);
      mma_split(part[ks & 1][j], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[0][j][e] + part[1][j][e];
}

// acc[n] += X (16 x 16, C fragments x[j] of two n8 tiles) . B[:, c0 + 8n ..]
// for n < NH, where B's 16 rows are a [16][D+4] fp32 chunk: the renaming
// feeds X from registers (step j's reduction index t is column 8j + 2t,
// t + 4 column 8j + 2t + 1, matched by B's rows 8j + 2t, 8j + 2t + 1).
template <int D, int NH>
__device__ __forceinline__ void reg_product(float (&acc)[NH][4], const float (&x)[2][4],
                                            const float* bc, int c0, int g, int t) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t xh[4], xl[4];
    split(x[j][0], xh[0], xl[0]);
    split(x[j][2], xh[1], xl[1]);
    split(x[j][1], xh[2], xl[2]);
    split(x[j][3], xh[3], xl[3]);
    const float* br = bc + (8 * j + 2 * t) * DP + c0 + g;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      uint32_t bh[2], bl[2];
      split(br[8 * n], bh[0], bl[0]);
      split(br[8 * n + DP], bh[1], bl[1]);
      mma_split(acc[n], xh, xl, bh, bl);
    }
  }
}

// p for one (row, key): 0 past Sk or on a dead row, else exp(masked s - m) / l,
// formed as exp2((s - m) log2 e) times the row's 1 / l (within a few ulp of
// the quotient, and off the critical path of two long-latency calls).
__device__ __forceinline__ float prob(float s, int qpos, int kpos, float m, float linv,
                                      bool live, const BwdParams& p) {
  if (!live || kpos >= p.sk) return 0.f;
  if ((p.causal && qpos < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len)) s = kNeg;
  return exp2f((s - m) * kLog2e) * linv;
}

// One flattened (position, group) row of kv head bkv, for the lanes of a
// warp together: the lane of row r (r = lane & 15) divides it once into its
// position s and group gg and holds its offsets in q and do, its m, l and
// delta; the lanes that need them read them by shuffles. A row past Sq * G
// gets offsets -1 and reads nothing.
struct RowInfo {
  long long qo, doo;
  float m, linv, dl;  // m, 1 / max(l, 1e-30), delta
  int s, gg, qpos;
};

__device__ __forceinline__ RowInfo row_info(int row, int bkv, const BwdParams& p,
                                            long long qb, long long dob,
                                            const float* __restrict__ m_in,
                                            const float* __restrict__ l_in,
                                            const float* __restrict__ delta) {
  RowInfo r{-1, -1, 0.f, 1.f, 0.f, 0, 0, 0};
  if (row < p.rows) {
    r.s = row / p.g;
    r.gg = row - r.s * p.g;
    r.qo = qb + r.gg * p.q_sg + r.s * p.q_ss;
    r.doo = dob + r.gg * p.do_sg + r.s * p.do_ss;
    const long long idx = ((long long)bkv * p.g + r.gg) * p.sq + r.s;
    r.m = m_in[idx];
    r.linv = 1.f / fmaxf(l_in[idx], 1e-30f);
    r.dl = delta[idx];
    r.qpos = p.q_offset + r.s;
  }
  return r;
}

// ---------------------------------------------------------------------------
// dq pass: a block per (bkv, 16 rows); its 4 warps split the keys
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta, float* __restrict__ dq, BwdParams p) {
  constexpr int DP = D + 4;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) float smem[];
  uint32_t* const qhi = reinterpret_cast<uint32_t*>(smem);  // [16][DP], scale * q
  uint32_t* const qlo = qhi + kTile * DP;
  uint32_t* const dhi = qlo + kTile * DP;  // do
  uint32_t* const dlo = dhi + kTile * DP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* const kc = smem + 4 * kTile * DP + warp * 2 * kChunk * DP;  // this warp's K
  float* const vc = kc + kChunk * DP;                               // and V chunk

  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int r0 = blockIdx.x * kTile;
  const long long kb = b * p.k_sb + h * p.k_sh;
  const long long vb = b * p.v_sb + h * p.v_sh;

  // the exact skip: stop after the last key a row of the block can see
  int kend = p.sk;
  const int kv_lim = exact_kv_lim(p);
  if (kv_lim > 0) {
    kend = kv_lim;
    if (p.causal) kend = max(0, min(kend, p.q_offset + (min(r0 + kTile, p.rows) - 1) / p.g + 1));
  }
  const int n_chunks = (kend + kChunk - 1) / kChunk;

  // key (lane & 15) of chunk cc: its offset in K or V, < 0 past Sk
  const auto key_off = [&](int cc, long long base, long long ss) -> long long {
    const int key = cc * kChunk + (lane & 15);
    return key < p.sk ? base + key * ss : -1;
  };
  // this warp's first chunk loads while Q and dO are staged: V first, since
  // dP comes first
  int c = warp;
  if (c < n_chunks) stage_rows<D>(vc, v, key_off(c, vb, p.v_ss), p.vec, lane);
  cp_async_commit();
  if (c < n_chunks) stage_rows<D>(kc, k, key_off(c, kb, p.k_ss), p.vec, lane);
  cp_async_commit();

  const RowInfo ri = row_info(r0 + (lane & 15), bkv, p, b * p.q_sb + h * p.q_sh,
                              b * p.do_sb + h * p.do_sh, m_in, l_in, delta);
  stage_split<D>(qhi, qlo, q, ri.qo, p.scale, p.vec);
  stage_split<D>(dhi, dlo, dout, ri.doo, 1.f, p.vec);

  // rows g and g + 8 of the tile
  int qpos[2];
  bool live[2];
  float mrow[2], linv_row[2], drow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    live[hf] = r0 + r < p.rows;
    qpos[hf] = __shfl_sync(0xffffffffu, ri.qpos, r);
    mrow[hf] = __shfl_sync(0xffffffffu, ri.m, r);
    linv_row[hf] = __shfl_sync(0xffffffffu, ri.linv, r);
    drow[hf] = __shfl_sync(0xffffffffu, ri.dl, r);
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (; c < n_chunks; c += kWarps) {
    const int key0 = c * kChunk;
    const bool next = c + kWarps < n_chunks;
    cp_async_wait<1>();  // V(c) landed (K(c) may still be in flight)
    __syncwarp();
    float dp[2][4];
    tile_product<D>(dp, dhi, dlo, vc, 1.f, g, t);
    __syncwarp();  // every lane is done with V(c)
    if (next) stage_rows<D>(vc, v, key_off(c + kWarps, vb, p.v_ss), p.vec, lane);
    cp_async_commit();

    cp_async_wait<1>();  // K(c) landed (V(c + 4) may still be in flight)
    __syncwarp();
    float sc[2][4];
    tile_product<D>(sc, qhi, qlo, kc, 1.f, g, t);

    // p and ds: a lane holds keys 8j + 2t + (e & 1) of rows g (e < 2), g + 8
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float pr = prob(sc[j][e], qpos[hf], key0 + 8 * j + 2 * t + (e & 1), mrow[hf],
                              linv_row[hf], live[hf], p);
        ds[j][e] = pr * (dp[j][e] - drow[hf]);
      }
    reg_product<D, NT>(acc, ds, kc, 0, g, t);  // dq_w += ds K
    __syncwarp();  // every lane is done with K(c)
    if (next) stage_rows<D>(kc, k, key_off(c + kWarps, kb, p.k_ss), p.vec, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warps' partial dq tiles, each into its own K chunk's space, summed in
  // warp order and scaled once
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(kc + (g + 8 * hf) * DP + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  __syncthreads();
  const float* part = smem + 4 * kTile * DP;  // warp w's tile at w * 2 * kChunk * DP
  const long long dqo = ri.qo < 0 ? -1 : b * p.dq_sb + h * p.dq_sh + ri.gg * p.dq_sg +
                                         ri.s * p.dq_ss;
  for (int i = tid; i < kTile * (D / 4); i += kThreads) {  // 4D: whole warps
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
    const long long o = __shfl_sync(0xffffffffu, dqo, r);
    if (o < 0) continue;
    float4 sum = *reinterpret_cast<const float4*>(part + r * DP + d);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(part + w * 2 * kChunk * DP + r * DP + d);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    const float4 y = make_float4(sum.x * p.scale, sum.y * p.scale, sum.z * p.scale,
                                 sum.w * p.scale);
    float* dst = dq + o + d;
    if (p.vec) {
      *reinterpret_cast<float4*>(dst) = y;
    } else {
      dst[0] = y.x; dst[1] = y.y; dst[2] = y.z; dst[3] = y.w;
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv pass: a block per (bkv, 16 keys); its 4 warps split the rows
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, BwdParams p) {
  constexpr int DP = D + 4;
  constexpr int DH = D > 128 ? 128 : D;  // output columns per sweep over the rows
  constexpr int NH = DH / 8;
  extern __shared__ __align__(16) float smem[];
  uint32_t* const khi = reinterpret_cast<uint32_t*>(smem);  // [16][DP]
  uint32_t* const klo = khi + kTile * DP;
  uint32_t* const vhi = klo + kTile * DP;
  uint32_t* const vlo = vhi + kTile * DP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* const qc = smem + 4 * kTile * DP + warp * 2 * kChunk * DP;  // this warp's Q
  float* const dc = qc + kChunk * DP;                               // and dO chunk

  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int k0 = blockIdx.x * kTile;
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long dob = b * p.do_sb + h * p.do_sh;

  // the exact skip: from the first row chunk that can see this key tile
  // (causal), none when the tile lies wholly past kv_len
  const int n_rc = (p.rows + kChunk - 1) / kChunk;
  int c_begin = 0, c_end = n_rc;
  const int kv_lim = exact_kv_lim(p);
  if (kv_lim > 0) {
    if (k0 >= kv_lim)
      c_end = 0;
    else if (p.causal)
      c_begin = (int)min((long long)n_rc,
                         (long long)max(0, k0 - p.q_offset) * p.g / kChunk);
  }

  const int key = k0 + (lane & 15);
  // keys g and g + 8 of the tile
  int kpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) kpos[hf] = k0 + g + 8 * hf;

  for (int c0 = 0; c0 < D; c0 += DH) {
    // this warp's first chunk: Q first, since S^T comes first
    int c = c_begin + warp;
    RowInfo nxt = row_info(c * kChunk + (lane & 15), bkv, p, qb, dob, m_in, l_in, delta);
    if (c < c_end) stage_rows<D>(qc, q, nxt.qo, p.vec, lane);
    cp_async_commit();
    if (c < c_end) stage_rows<D>(dc, dout, nxt.doo, p.vec, lane);
    cp_async_commit();
    if (c0 == 0) {  // K and V, split, while the first chunks load
      stage_split<D>(khi, klo, k, key < p.sk ? b * p.k_sb + h * p.k_sh + key * p.k_ss : -1,
                     1.f, p.vec);
      stage_split<D>(vhi, vlo, v, key < p.sk ? b * p.v_sb + h * p.v_sh + key * p.v_ss : -1,
                     1.f, p.vec);
    }
    __syncthreads();  // K and V are split and staged

    float acc_k[NH][4], acc_v[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    for (; c < c_end; c += kWarps) {
      const int row0 = c * kChunk;
      const bool next = c + kWarps < c_end;
      const RowInfo cur = nxt;
      if (next)  // its stats load under this chunk
        nxt = row_info((c + kWarps) * kChunk + (lane & 15), bkv, p, qb, dob, m_in, l_in, delta);

      cp_async_wait<1>();  // Q(c) landed (dO(c) may still be in flight)
      __syncwarp();
      float sc[2][4];
      tile_product<D>(sc, khi, klo, qc, p.scale, g, t);  // S^T = K (scale Q)^T
      cp_async_wait<0>();  // dO(c) landed
      __syncwarp();
      float dp[2][4];
      tile_product<D>(dp, vhi, vlo, dc, 1.f, g, t);  // dP^T = V dO^T

      // P^T and dS^T: a lane holds rows 8j + 2t + (e & 1) of keys g (e < 2),
      // g + 8; the stats of row r come from lane r
      float pt[2][4], dst_t[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int r = 8 * j + 2 * t + e1;
          const float m = __shfl_sync(0xffffffffu, cur.m, r);
          const float linv = __shfl_sync(0xffffffffu, cur.linv, r);
          const float dl = __shfl_sync(0xffffffffu, cur.dl, r);
          const int qpos = __shfl_sync(0xffffffffu, cur.qpos, r);
          const bool live = row0 + r < p.rows;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + e1;
            pt[j][e] = prob(sc[j][e], qpos, kpos[hf], m, linv, live, p);
            dst_t[j][e] = pt[j][e] * (dp[j][e] - dl);
          }
        }
      reg_product<D, NH>(acc_k, dst_t, qc, c0, g, t);  // dK += dS^T Q (scaled at the end)
      __syncwarp();  // every lane is done with Q(c)
      if (next) stage_rows<D>(qc, q, nxt.qo, p.vec, lane);
      cp_async_commit();
      reg_product<D, NH>(acc_v, pt, dc, c0, g, t);  // dV += P^T dO
      __syncwarp();  // every lane is done with dO(c)
      if (next) stage_rows<D>(dc, dout, nxt.doo, p.vec, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();

    // the warps' partial dK and dV, each into its own Q and dO chunks'
    // space, summed in warp order
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int o = (g + 8 * hf) * DP + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(qc + o) = make_float2(acc_k[n][2 * hf], acc_k[n][2 * hf + 1]);
        *reinterpret_cast<float2*>(dc + o) = make_float2(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
      }
    __syncthreads();
    const float* part = smem + 4 * kTile * DP;  // warp w's dK at w * 2 * kChunk * DP, dV after
    for (int i = tid; i < 2 * kTile * (DH / 4); i += kThreads) {
      const int which = i / (kTile * (DH / 4));  // 0: dk, 1: dv
      const int ii = i - which * kTile * (DH / 4);
      const int r = ii / (DH / 4), d = (ii - r * (DH / 4)) * 4, pos = k0 + r;
      if (pos >= p.sk) continue;
      const float* src = part + which * kChunk * DP + r * DP + d;
      float4 sum = *reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(src + w * 2 * kChunk * DP);
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      float* out = which == 0 ? dk + b * p.dk_sb + h * p.dk_sh + (long long)pos * p.dk_ss
                              : dv + b * p.dv_sb + h * p.dv_sh + (long long)pos * p.dv_ss;
      out += c0 + d;
      if (which == 0) sum = make_float4(sum.x * p.scale, sum.y * p.scale, sum.z * p.scale,
                                        sum.w * p.scale);
      if (p.vec) {
        *reinterpret_cast<float4*>(out) = sum;
      } else {
        out[0] = sum.x; out[1] = sum.y; out[2] = sum.z; out[3] = sum.w;
      }
    }
    __syncthreads();  // every partial is read: the next sweep may stage over them
  }
}

// ---------------------------------------------------------------------------
// bf16 operands on the bf16 tensor cores: both passes
// ---------------------------------------------------------------------------
//
// The functions and rounding points are the reference's, on m16n8k16 bf16
// MMAs with fp32 accumulators: S = Q K^T times the scale rounded to bf16
// (qscale), dP = dO V^T; ds rounds to bf16 as it packs into the A fragment
// of ds.K (dq) and dS^T.Q (dk), exactly where the reference rounds it; dq is
// scaled by the fp32 scale at the end, dk by qscale (the reference's dk =
// bf16(ds)^T (q * bf16(scale)), with the product of two bf16 kept exact).
// dv = P^T dO keeps p in fp32, as the reference does: p is split into bf16
// hi + lo (split_pair) and each multiply-add takes two MMAs, lo then hi,
// within about 2^-16 of p^T do, where one bf16 product would err by 2^-9.
// The plain version computes dv from fp32 p exactly.
//
// p is exp2((x - m) log2 e) times 1 / l as in the fp32 passes, with the
// MUFU's ex2.approx and, in dk/dv, rcp.approx (both within 2^-22 of exact,
// against the 2^-8 of the bf16 rounding that follows).
//
// Geometry: FlashAttention-2's layout on mma.sync; every output element has
// one owning warp, which writes it from its registers, scaled once and
// rounded to bf16: no partial sums cross warps, and each warp's fixed order
// of steps repeats bitwise (no atomics).
// - dq: a block owns BM (kDqRowsBf16) flattened (position, group) rows of
//   one kv head, a warp 16 of them (16 x D of dq), and every warp walks the
//   same KN-key tiles.
// - dk/dv: a block owns BN (kDkvKeysBf16) keys, a pair of warps 16 of them
//   (NWK; one warp at head dim 8), and every pair walks the same KN-row
//   tiles of all G groups. The two warps of a pair split each tile's rows to
//   form S^T, dP^T, P^T and dS^T, swap P^T and dS^T through shared memory
//   (a named barrier per pair), and split the output columns: each owns
//   16 x D/2 of dK and of dV. So dk/dv runs twice the warps of a one-warp
//   owner, for the short sequences where a key tile's rows are a long
//   serial chain, and needs no second sweep at D = 256.
// - The tiles every warp reads (K and V in dq; Q, dO and the rows' m, l,
//   delta and position in dk/dv) pass through a two-stage ring in shared
//   memory, copied once per block by cp.async (16 bytes, 8 threads a row),
//   the next tile in flight while the current one is used, one barrier per
//   tile. The block's own tile (Q and dO, or K and V) is copied by cp.async
//   too, ahead of the first ring tile. In dk/dv a tile's stats load into
//   registers under the previous tile's products and are stored beside its
//   rows after them; 1 / l is taken where it is used.
// - Fragments by ldmatrix: .x4 for the products whose B rows are the
//   contraction's n dimension (S, dP, S^T, dP^T: two n8 tiles of a k16 step
//   per instruction), .x4.trans for those
//   that contract over keys or rows (ds.K, dS^T.Q and both halves of
//   P^T.dO). Shared rows are D + 8 elements (272 bytes at D = 128), so every
//   ldmatrix row address is 16-byte aligned and the 8 rows of a phase fall
//   on 8 distinct bank quads.
// - A fragments of the warp's own rows (dq's Q and dO, dk/dv's K and V) stay
//   in registers across steps at D <= 128 (64 registers at D = 128); at
//   D = 256 they would not fit beside the accumulators and are read by
//   ldmatrix at each step (Bf16Bwd::kRegs).
// - Causal: a dq block stops after its last visible key tile and the blocks
//   with the last rows (the most keys) launch first; a dk/dv block starts at
//   the first row tile that sees its keys, and the first keys (the most
//   rows) launch first. A tile whose rows and keys are all live and visible
//   skips the masks. Exact skip and fully masked rows as the fp32 passes.
// - A view whose strides are not multiples of 8 elements is staged by
//   element copies (plain loads and stores) into the same rows.

// The bf16 passes' geometry at head dim D.
template <int D>
struct Bf16Bwd {
  static constexpr int DP = Bf16Rows<D>::DP;       // elements per shared row
  static constexpr int KS = Bf16Rows<D>::DK / 16;  // k16 steps over the head dim
  static constexpr int NT = D / 8;                 // n8 tiles of a dq row
  static constexpr int KN = D <= 32 ? 64 : 32;     // keys (dq) or rows (dk/dv) per ring tile
  static constexpr int NS = 2;                     // ring stages
  static constexpr int NWK = D >= 16 ? 2 : 1;      // dk/dv: warps per 16 keys
  // A fragments kept in registers across steps: dq's Q and dO, dk/dv's K
  // and V (at D = 256 they would not fit beside the accumulators)
  static constexpr bool kRegs = D <= 128;
};

// Rows a dq block owns and keys a dk/dv block owns (a warp per 16): 64 and
// 32 measured against 32 and 64 at the trained and long shapes (PERF.md §6).
constexpr int kDqRowsBf16 = 64;
constexpr int kDkvKeysBf16 = 32;

// Q and dO [BM][DP] and NS K and V stages [KN][DP]
template <int D, int BM>
__host__ __device__ constexpr int dq_bf16_smem_bytes() {
  return (2 * BM + 2 * Bf16Bwd<D>::NS * Bf16Bwd<D>::KN) * Bf16Bwd<D>::DP * 2;
}
// K and V [BN][DP], NS Q and dO stages and their stats, and per warp group
// the P^T and dS^T it shares (16 x KN fp32 each)
template <int D, int BN>
__host__ __device__ constexpr int dkv_bf16_smem_bytes() {
  return (2 * BN + 2 * Bf16Bwd<D>::NS * Bf16Bwd<D>::KN) * Bf16Bwd<D>::DP * 2 +
         Bf16Bwd<D>::NS * 4 * Bf16Bwd<D>::KN * 4 + (BN / 16) * 2 * 16 * Bf16Bwd<D>::KN * 4;
}

// prob()'s p for the bf16 passes, from the unscaled score sum `acc`: x =
// acc * qscale, masked to NEG where `prob` masks it, exp2((x - m) log2e)
// times the row's 1 / l. With `whole` (every row and key of the warp's tile
// is live and visible) the masks are skipped: they would change nothing.
template <bool whole>
__device__ __forceinline__ float prob_bf16(float acc, int qpos, int kpos, float m, float linv,
                                           bool live, const BwdParams& p) {
  float x = acc * p.qscale;
  if (!whole) {
    if (!live || kpos >= p.sk) return 0.f;
    if ((p.causal && qpos < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len)) x = kNeg;
  }
  return fast_exp2((x - m) * kLog2e) * linv;
}

// Wait until the nthreads threads of a warp group arrive at named barrier
// `id` (barrier 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}


// ---------------------------------------------------------------------------
// bf16 dq pass: a block per (bkv, BM rows), a warp per 16 rows
// ---------------------------------------------------------------------------

template <int D, int BM>
__global__ void __launch_bounds__(2 * BM)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ delta, uint16_t* __restrict__ dq,
                         BwdParams p) {
  using Gm = Bf16Bwd<D>;
  constexpr int DP = Gm::DP, KS = Gm::KS, NT = Gm::NT, KN = Gm::KN, NS = Gm::NS;
  constexpr int NA = NT < 2 ? 2 : NT;
  constexpr int kT = 2 * BM;  // BM / 16 warps
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint16_t* const qs = reinterpret_cast<uint16_t*>(smem_bytes);  // Q [BM][DP]
  uint16_t* const dos = qs + BM * DP;                             // dO [BM][DP]
  uint16_t* const ring = dos + BM * DP;  // stage s: K [KN][DP] at 2 s KN DP, V after it

  const int n_tiles = (p.rows + BM - 1) / BM;
  if (tile_order() >= n_tiles) return;
  const int r0 = (n_tiles - 1 - tile_order()) * BM;  // the last rows (most keys) first
  const int bkv = blockIdx.x;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const DivG divg(p.g);
  if (D < 16) {
    zero_smem<kT>(smem_bytes, dq_bf16_smem_bytes<D, BM>());
    __syncthreads();
  }

  // the exact skip: stop after the last key a row of the block can see
  int kend = p.sk;
  const int kv_lim = exact_kv_lim(p);
  if (kv_lim > 0) {
    kend = kv_lim;
    if (p.causal) kend = max(0, min(kend, p.q_offset + (min(r0 + BM, p.rows) - 1) / p.g + 1));
  }
  const int n_kt = (kend + KN - 1) / KN;

  // Q and dO, then the first key tiles, all by cp.async
  const long long qb = b * p.q_sb + h * p.q_sh, dob = b * p.do_sb + h * p.do_sh;
  const long long kb = b * p.k_sb + h * p.k_sh, vb = b * p.v_sb + h * p.v_sh;
  copy_rows_bf16<D, BM, kT>(qs, q, dos, dout, [&](int r) -> RowPair {
    const int row = r0 + r;
    if (row >= p.rows) return {-1, -1};
    const int s = divg(row), gg = row - s * p.g;
    return {qb + gg * p.q_sg + (long long)s * p.q_ss, dob + gg * p.do_sg + (long long)s * p.do_ss};
  }, p.vec);
  cp_async_commit();
  const auto stage_keys = [&](int kt) {
    uint16_t* const kd = ring + (kt % NS) * 2 * KN * DP;
    const int key0 = kt * KN;
    copy_rows_bf16<D, KN, kT>(kd, k, kd + KN * DP, v, [&](int r) -> RowPair {
      const int key = key0 + r;
      if (key >= p.sk) return {-1, -1};
      return {kb + (long long)key * p.k_ss, vb + (long long)key * p.v_ss};
    }, p.vec);
  };
#pragma unroll
  for (int kt = 0; kt < NS - 1; ++kt) {  // the first NS - 1 key tiles, a group each
    if (kt < n_kt) stage_keys(kt);
    cp_async_commit();
  }

  // this lane's rows g and g + 8 of the warp's 16: stats, position, dq offset
  int qpos[2];
  bool live[2];
  float mrow[2], linv_row[2], drow[2];
  long long dqo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 16 * warp + g + 8 * hf;
    live[hf] = row < p.rows;
    qpos[hf] = 0, mrow[hf] = 0.f, linv_row[hf] = 1.f, drow[hf] = 0.f, dqo[hf] = -1;
    if (live[hf]) {
      const int s = divg(row), gg = row - s * p.g;
      const long long idx = ((long long)bkv * p.g + gg) * p.sq + s;
      mrow[hf] = m_in[idx];
      linv_row[hf] = 1.f / fmaxf(l_in[idx], 1e-30f);
      drow[hf] = delta[idx];
      qpos[hf] = p.q_offset + s;
      dqo[hf] = b * p.dq_sb + h * p.dq_sh + gg * p.dq_sg + (long long)s * p.dq_ss;
    }
  }

  // the keys below warp_lim are live and visible to all 16 rows of the warp
  // (0: some row is past Sq * G, or sees no key)
  int warp_lim = 0;
  if (r0 + 16 * warp + 16 <= p.rows) {
    warp_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
    if (p.causal) warp_lim = min(warp_lim, p.q_offset + divg(r0 + 16 * warp) + 1);
  }

  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int la = lane_a(lane, DP), lb = lane_b(lane, DP);
  const uint32_t qa = smem_addr(qs + 16 * warp * DP + la);
  const uint32_t da = smem_addr(dos + 16 * warp * DP + la);
  constexpr int KR = Gm::kRegs ? KS : 1;
  uint32_t qf[KR][4], df[KR][4];  // the warp's Q and dO A fragments, if kept
  cp_async_wait<NS - 1>();  // Q and dO landed (the first key tiles may be in flight)
  __syncthreads();
  if (Gm::kRegs) {
#pragma unroll
    for (int ks = 0; ks < KR; ++ks) {
      ldmatrix_x4(qf[ks], qa + 32 * ks);
      ldmatrix_x4(df[ks], da + 32 * ks);
    }
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // key tile kt landed; every warp is done with tile kt - 1's stage
    if (kt + NS - 1 < n_kt) stage_keys(kt + NS - 1);
    cp_async_commit();
    const uint16_t* const kst = ring + (kt % NS) * 2 * KN * DP;
    const uint32_t kbase = smem_addr(kst), vbase = smem_addr(kst + KN * DP);

    float sc[KN / 8][4], dp[KN / 8][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    rows_product<D, KN / 8>(dp, df, da, vbase + 2 * lb);  // dP = dO V^T
    rows_product<D, KN / 8>(sc, qf, qa, kbase + 2 * lb);  // S = Q K^T (times qscale)

    // p and ds: a lane holds keys 8j + 2t + (e & 1) of rows g (e < 2), g + 8
    const int key0 = kt * KN;
    const auto probs = [&](auto whole) {
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const float pr = prob_bf16<decltype(whole)::value>(
              sc[j][e], qpos[hf], key0 + 8 * j + 2 * t + (e & 1), mrow[hf], linv_row[hf],
              live[hf], p);
          sc[j][e] = pr * (dp[j][e] - drow[hf]);
        }
    };
    if (key0 + KN <= warp_lim)
      probs(std::true_type{});
    else
      probs(std::false_type{});
    // dq += bf16(ds) K, 16 keys per k step
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, sc[2 * kk], sc[2 * kk + 1]);
      cols_product<NT>(acc, a, kbase + 2 * (16 * kk * DP + la));
    }
  }
  cp_async_wait<0>();
  store_rows_bf16<NT>(dq, acc, dqo, p.scale, t, p.vec);
}

// ---------------------------------------------------------------------------
// bf16 dk/dv pass: a block per (bkv, BN keys), a group of warps per 16 keys
// ---------------------------------------------------------------------------

template <int D, int BN>
__global__ void __launch_bounds__(2 * Bf16Bwd<D>::NWK * BN)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta, uint16_t* __restrict__ dk,
                          uint16_t* __restrict__ dv, BwdParams p) {
  using Gm = Bf16Bwd<D>;
  constexpr int DP = Gm::DP, KS = Gm::KS, RM = Gm::KN, NS = Gm::NS;
  constexpr int NWK = Gm::NWK;     // warps per 16 keys
  constexpr int NJ = RM / 8;       // n8 row tiles of a ring tile
  constexpr int NJW = NJ / NWK;    // of which a warp forms S^T, dP^T, P^T and dS^T
  constexpr int CW = D / NWK;      // dK and dV columns a warp owns
  constexpr int NW = CW / 8;
  constexpr int NA = NW < 2 ? 2 : NW;
  constexpr int kT = 2 * NWK * BN;
  static_assert(kT >= RM, "a thread per row of a ring tile loads its stats");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint16_t* const ks = reinterpret_cast<uint16_t*>(smem_bytes);  // K [BN][DP]
  uint16_t* const vs = ks + BN * DP;                              // V [BN][DP]
  uint16_t* const ring = vs + BN * DP;  // stage s: Q [RM][DP] at 2 s RM DP, dO after it
  // stage s: m, l, delta (float) and position (int) [RM] each, at 4 s RM
  float* const stats = reinterpret_cast<float*>(ring + 2 * NS * RM * DP);
  // per warp group: P^T and dS^T as C fragments, [NJ][32 lanes] float4 each
  float4* const xbuf = reinterpret_cast<float4*>(stats + 4 * NS * RM);

  const int n_tiles = (p.sk + BN - 1) / BN;
  if (tile_order() >= n_tiles) return;
  const int k0 = tile_order() * BN;  // the first keys (seen by the most rows) first
  const int bkv = blockIdx.x;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / NWK, part = warp % NWK;  // 16-key group, and the warp in it
  const int g = lane >> 2, t = lane & 3;
  const DivG divg(p.g);
  if (D < 16) {
    zero_smem<kT>(smem_bytes, dkv_bf16_smem_bytes<D, BN>());
    __syncthreads();
  }

  // the exact skip: from the first row tile that can see this key tile
  // (causal), none when the tile lies wholly past kv_len
  const int n_rt = (p.rows + RM - 1) / RM;
  int c_begin = 0, c_end = n_rt;
  const int kv_lim = exact_kv_lim(p);
  if (kv_lim > 0) {
    if (k0 >= kv_lim)
      c_end = 0;
    else if (p.causal)
      c_begin = (int)min((long long)n_rt, (long long)max(0, k0 - p.q_offset) * p.g / RM);
  }

  // K and V by cp.async; the first row tiles follow under them
  const long long kb = b * p.k_sb + h * p.k_sh, vb = b * p.v_sb + h * p.v_sh;
  copy_rows_bf16<D, BN, kT>(ks, k, vs, v, [&](int r) -> RowPair {
    const int key = k0 + r;
    if (key >= p.sk) return {-1, -1};
    return {kb + (long long)key * p.k_ss, vb + (long long)key * p.v_ss};
  }, p.vec);
  cp_async_commit();

  const long long qb = b * p.q_sb + h * p.q_sh, dob = b * p.do_sb + h * p.do_sh;
  const auto stage_rows = [&](int c, int slot) {
    uint16_t* const qd = ring + slot * 2 * RM * DP;
    copy_rows_bf16<D, RM, kT>(qd, q, qd + RM * DP, dout, [&](int r) -> RowPair {
      const int row = c * RM + r;
      if (row >= p.rows) return {-1, -1};
      const int s = divg(row), gg = row - s * p.g;
      return {qb + gg * p.q_sg + (long long)s * p.q_ss,
              dob + gg * p.do_sg + (long long)s * p.do_ss};
    }, p.vec);
  };
  // row c * RM + tid's stats (threads tid < RM), as row_info gives them,
  // loaded a tile ahead; l is stored as it is, and its reciprocal taken
  // where it is used, so that nothing waits on the loads before the store
  struct Stat {
    float m, l, dl;
    int qpos;
  };
  const auto load_stat = [&](int c) -> Stat {
    Stat st{0.f, 1.f, 0.f, 0};
    const int row = c * RM + tid;
    if (tid < RM && row < p.rows) {
      const int s = divg(row), gg = row - s * p.g;
      const long long idx = ((long long)bkv * p.g + gg) * p.sq + s;
      st.m = m_in[idx];
      st.l = l_in[idx];
      st.dl = delta[idx];
      st.qpos = p.q_offset + s;
    }
    return st;
  };
  const auto put_stat = [&](const Stat& st, int slot) {
    if (tid < RM) {
      float* const sl = stats + slot * 4 * RM;
      sl[tid] = st.m;
      sl[RM + tid] = st.l;
      sl[2 * RM + tid] = st.dl;
      reinterpret_cast<int*>(sl + 3 * RM)[tid] = st.qpos;
    }
  };

  // keys g and g + 8 of the group's 16, and this warp's output columns
  int kpos[2];
  long long dko[2], dvo[2];
  const int c0 = part * CW;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    kpos[hf] = k0 + 16 * grp + g + 8 * hf;
    const bool in = kpos[hf] < p.sk;
    dko[hf] = in ? b * p.dk_sb + h * p.dk_sh + (long long)kpos[hf] * p.dk_ss + c0 : -1;
    dvo[hf] = in ? b * p.dv_sb + h * p.dv_sh + (long long)kpos[hf] * p.dv_ss + c0 : -1;
  }
  // the group's keys all live (below Sk and kv_len), and its last key
  const int kw_last = k0 + 16 * grp + 15;
  const bool warp_keys_live = kw_last < (p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk));

  // A operands: K (S^T) and V (dP^T) rows of the group's keys
  const int la = lane_a(lane, DP), lb = lane_b(lane, DP);
  const uint32_t ka = smem_addr(ks + 16 * grp * DP + la);
  const uint32_t va = smem_addr(vs + 16 * grp * DP + la);
  constexpr int KR = Gm::kRegs ? KS : 1;
  uint32_t kf[KR][4], vf[KR][4];  // their fragments, if kept
  float4* const xg = xbuf + grp * 2 * NJ * 32 + lane;  // P^T tile j at xg[32 j], dS^T after

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // the first NS - 1 row tiles, a group each
    if (c_begin + i < c_end) {
      stage_rows(c_begin + i, i);
      put_stat(load_stat(c_begin + i), i);
    }
    cp_async_commit();
  }

  float acc_k[NA][4], acc_v[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int slot = (c - c_begin) % NS, ahead = (c - c_begin + NS - 1) % NS;
    cp_async_wait<NS - 2>();
    __syncthreads();  // row tile c (first: and K, V) landed; tile c - 1's slot is free
    if (Gm::kRegs && c == c_begin) {
#pragma unroll
      for (int kstep = 0; kstep < KR; ++kstep) {
        ldmatrix_x4(kf[kstep], ka + 32 * kstep);
        ldmatrix_x4(vf[kstep], va + 32 * kstep);
      }
    }
    const bool next = c + NS - 1 < c_end;
    Stat nst{0.f, 1.f, 0.f, 0};
    if (next) {  // tile c + NS - 1's rows by cp.async, its stats under this tile's products
      stage_rows(c + NS - 1, ahead);
      nst = load_stat(c + NS - 1);
    }
    cp_async_commit();
    const uint16_t* const qst = ring + slot * 2 * RM * DP;
    const uint32_t qbase = smem_addr(qst), dbase = smem_addr(qst + RM * DP);
    const float* const sl = stats + slot * 4 * RM;

    // this warp's row tiles j0 .. j0 + NJW - 1: S^T = K Q^T (times qscale)
    // and dP^T = V dO^T
    const int j0 = part * NJW;
    float st[NJW][4], dpt[NJW][4];
#pragma unroll
    for (int j = 0; j < NJW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    rows_product<D, NJW>(st, kf, ka, qbase + 2 * (8 * j0 * DP + lb));
    rows_product<D, NJW>(dpt, vf, va, dbase + 2 * (8 * j0 * DP + lb));

    // P^T and dS^T of those rows: a lane holds rows 8j + 2t + (e & 1) of
    // keys g (e < 2), g + 8
    const int row0 = c * RM;
    // every row of the tile live and, causal, at or past the group's last key
    const bool whole = row0 + RM <= p.rows && warp_keys_live &&
                       (!p.causal || reinterpret_cast<const int*>(sl + 3 * RM)[0] >= kw_last);
    const auto probs = [&](auto whole_t) {
#pragma unroll
      for (int j = 0; j < NJW; ++j) {
        const int r = 8 * (j0 + j) + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(sl + r);
        const float2 l2 = *reinterpret_cast<const float2*>(sl + RM + r);
        const float2 dl2 = *reinterpret_cast<const float2*>(sl + 2 * RM + r);
        const int2 qp2 = *reinterpret_cast<const int2*>(sl + 3 * RM + r);
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const float m = e1 ? m2.y : m2.x, dl = e1 ? dl2.y : dl2.x;
          const float linv = fast_rcp(fmaxf(e1 ? l2.y : l2.x, 1e-30f));
          const int qpos = e1 ? qp2.y : qp2.x;
          const bool live = row0 + r + e1 < p.rows;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int e = 2 * hf + e1;
            const float pt = prob_bf16<decltype(whole_t)::value>(st[j][e], qpos, kpos[hf], m,
                                                                 linv, live, p);
            dpt[j][e] = pt * (dpt[j][e] - dl);
            st[j][e] = pt;
          }
        }
      }
    };
    if (whole)
      probs(std::true_type{});
    else
      probs(std::false_type{});

    // every row tile's P^T and dS^T, through shared memory from the group
    float pa[NJ][4], da[NJ][4];
    if (NWK == 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[j][e] = st[NWK == 1 ? j : 0][e];
          da[j][e] = dpt[NWK == 1 ? j : 0][e];
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJW; ++j) {
        xg[32 * (j0 + j)] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
        xg[32 * (NJ + j0 + j)] = make_float4(dpt[j][0], dpt[j][1], dpt[j][2], dpt[j][3]);
      }
      group_sync(1 + grp, 32 * NWK);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 x = xg[32 * j], y = xg[32 * (NJ + j)];
        pa[j][0] = x.x, pa[j][1] = x.y, pa[j][2] = x.z, pa[j][3] = x.w;
        da[j][0] = y.x, da[j][1] = y.y, da[j][2] = y.z, da[j][3] = y.w;
      }
    }

    // this warp's columns: dK += bf16(dS^T) Q and dV += P^T dO (hi + lo, lo
    // first), 16 rows per k step
#pragma unroll
    for (int kk = 0; kk < RM / 16; ++kk) {
      const int o = 2 * (16 * kk * DP + la + c0);
      uint32_t a[4];
      a_from_c(a, da[2 * kk], da[2 * kk + 1]);
      cols_product<NW>(acc_k, a, qbase + o);
      uint32_t hi[4], lo[4];
      split_pair(pa[2 * kk][0], pa[2 * kk][1], hi[0], lo[0]);
      split_pair(pa[2 * kk][2], pa[2 * kk][3], hi[1], lo[1]);
      split_pair(pa[2 * kk + 1][0], pa[2 * kk + 1][1], hi[2], lo[2]);
      split_pair(pa[2 * kk + 1][2], pa[2 * kk + 1][3], hi[3], lo[3]);
      cols_product_split<NW>(acc_v, lo, hi, dbase + o);
    }
    if (next) put_stat(nst, ahead);
  }
  cp_async_wait<0>();
  store_rows_bf16<NW>(dk, acc_k, dko, p.qscale, t, p.vec);
  store_rows_bf16<NW>(dv, acc_v, dvo, 1.f, t, p.vec);
}

struct OperandsBf16 {
  const uint16_t *q, *k, *v, *dout;
  const float *m, *l, *delta;
  uint16_t *dq, *dk, *dv;
};

// The bf16 dq pass with BM = T, or the dk/dv pass with BN = T.
template <int D, int T>
int launch_dq_bf16(const OperandsBf16& o, const BwdParams& p, int nbkv, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  const int smem = dq_bf16_smem_bytes<D, T>();
  const cudaError_t e = allow_smem((const void*)flash_bwd_dq_bf16_kernel<D, T>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_bf16_kernel<D, T>
      <<<bf16_grid(nbkv, (p.rows + T - 1) / T), 2 * T, smem, stream>>>(
      o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dq, p);
  return (int)cudaGetLastError();
}
template <int D, int T>
int launch_dkv_bf16(const OperandsBf16& o, const BwdParams& p, int nbkv, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  const int smem = dkv_bf16_smem_bytes<D, T>();
  const cudaError_t e = allow_smem((const void*)flash_bwd_dkv_bf16_kernel<D, T>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_bf16_kernel<D, T>
      <<<bf16_grid(nbkv, (p.sk + T - 1) / T), 2 * Bf16Bwd<D>::NWK * T, smem, stream>>>(
      o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dk, o.dv, p);
  return (int)cudaGetLastError();
}

// `tile` 0: the pass's own BM or BN; at D = 128 also the other of 32 and 64,
// built for the comparison the smoke run prints.
template <int D>
int launch_bf16_d(const OperandsBf16& o, const BwdParams& p, int nbkv, bool dkv_pass,
                  cudaStream_t stream, int tile) {
  constexpr int kAltDq = 96 - kDqRowsBf16, kAltDkv = 96 - kDkvKeysBf16;
  if (dkv_pass) {
    if (tile == 0 || tile == kDkvKeysBf16)
      return launch_dkv_bf16<D, kDkvKeysBf16>(o, p, nbkv, stream);
    if constexpr (D == 128) {
      if (tile == kAltDkv) return launch_dkv_bf16<D, kAltDkv>(o, p, nbkv, stream);
    }
  } else {
    if (tile == 0 || tile == kDqRowsBf16)
      return launch_dq_bf16<D, kDqRowsBf16>(o, p, nbkv, stream);
    if constexpr (D == 128) {
      if (tile == kAltDq) return launch_dq_bf16<D, kAltDq>(o, p, nbkv, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

struct Operands {
  const float *q, *k, *v, *dout, *m, *l, *delta;
  float *dq, *dk, *dv;
};

template <int D>
int launch_d(const Operands& o, const BwdParams& p, int nbkv, bool dkv_pass,
             cudaStream_t stream) {
  static std::atomic<int> allowed_dq[kMaxDevices], allowed_dkv[kMaxDevices];
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  if (dkv_pass) {
    const cudaError_t e = allow_smem((const void*)flash_bwd_dkv_kernel<D>, smem, allowed_dkv);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.sk + kTile - 1) / kTile, nbkv);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dk, o.dv, p);
  } else {
    const cudaError_t e = allow_smem((const void*)flash_bwd_dq_kernel<D>, smem, allowed_dq);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.rows + kTile - 1) / kTile, nbkv);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dq, p);
  }
  return (int)cudaGetLastError();
}

// Whether 16-byte copies and 16-byte (fp32) or 8-byte (bf16) accesses keep
// their alignment: every operand's base pointer 16-byte aligned, and every
// stride (elements) a multiple of `per16`, the elements in 16 bytes (4 fp32,
// 8 bf16).
bool aligned(const void* q, const void* k, const void* v, const void* dout, const void* dq,
             const void* dk, const void* dv, const long long* st, int per16) {
  uintptr_t bits = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  bits |= dq != nullptr ? (uintptr_t)dq : (uintptr_t)dk | (uintptr_t)dv;
  bool ok = bits % 16 == 0;
  for (int i = 0; i < 24; ++i) ok = ok && st[i] % per16 == 0;
  return ok;
}

// dims: nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len (< 0: none)
// strides (elements): q b,h,g,s; k b,h,s; v b,h,s; do b,h,g,s; dq b,h,g,s;
// dk b,h,s; dv b,h,s. Returns 0, or the error for dims the passes refuse.
int read_params(BwdParams& p, int& nbkv, int& d, const int* dims, const long long* st,
                float scale) {
  nbkv = dims[0];
  p.nh = dims[1];
  p.g = dims[2];
  p.sq = dims[3];
  p.sk = dims[4];
  d = dims[5];
  p.causal = dims[6];
  p.q_offset = dims[7];
  p.kv_len = dims[8];
  p.scale = scale;
  p.qscale = bf16mma::round_bf16(scale);
  if (nbkv < 1 || nbkv > 65535 || p.nh < 1 || p.g < 1 || p.sq < 1 || p.sk < 1 ||
      (long long)p.sq * p.g > 0x7fffffffLL - kTile)
    return (int)cudaErrorInvalidValue;
  p.rows = p.sq * p.g;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_sg = st[2]; p.q_ss = st[3];
  p.k_sb = st[4]; p.k_sh = st[5]; p.k_ss = st[6];
  p.v_sb = st[7]; p.v_sh = st[8]; p.v_ss = st[9];
  p.do_sb = st[10]; p.do_sh = st[11]; p.do_sg = st[12]; p.do_ss = st[13];
  p.dq_sb = st[14]; p.dq_sh = st[15]; p.dq_sg = st[16]; p.dq_ss = st[17];
  p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
  p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
  return 0;
}

int launch(const Operands& o, const int* dims, const long long* st, float scale,
           bool dkv_pass, cudaStream_t stream) {
  BwdParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, st, scale)) return e;
  p.vec = aligned(o.q, o.k, o.v, o.dout, o.dq, o.dk, o.dv, st, 4);
  switch (d) {
    case 8: return launch_d<8>(o, p, nbkv, dkv_pass, stream);
    case 16: return launch_d<16>(o, p, nbkv, dkv_pass, stream);
    case 32: return launch_d<32>(o, p, nbkv, dkv_pass, stream);
    case 64: return launch_d<64>(o, p, nbkv, dkv_pass, stream);
    case 128: return launch_d<128>(o, p, nbkv, dkv_pass, stream);
    case 256: return launch_d<256>(o, p, nbkv, dkv_pass, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(const OperandsBf16& o, const int* dims, const long long* st, float scale,
                bool dkv_pass, cudaStream_t stream, int tile) {
  BwdParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, st, scale)) return e;
  p.vec = aligned(o.q, o.k, o.v, o.dout, o.dq, o.dk, o.dv, st, 8);
  switch (d) {
    case 8: return launch_bf16_d<8>(o, p, nbkv, dkv_pass, stream, tile);
    case 16: return launch_bf16_d<16>(o, p, nbkv, dkv_pass, stream, tile);
    case 32: return launch_bf16_d<32>(o, p, nbkv, dkv_pass, stream, tile);
    case 64: return launch_bf16_d<64>(o, p, nbkv, dkv_pass, stream, tile);
    case 128: return launch_bf16_d<128>(o, p, nbkv, dkv_pass, stream, tile);
    case 256: return launch_bf16_d<256>(o, p, nbkv, dkv_pass, stream, tile);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq (q's layout) from q, k, v, do, the forward's m and l, and delta.
int repro_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                           const float* dout, const float* m, const float* l,
                           const float* delta, float* dq, const int* dims,
                           const long long* strides, float scale, void* stream) {
  Operands o{q, k, v, dout, m, l, delta, dq, nullptr, nullptr};
  return launch(o, dims, strides, scale, false, (cudaStream_t)stream);
}

// dk, dv (k's and v's layouts), each summed over the G groups and Sq.
int repro_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                            const float* dout, const float* m, const float* l,
                            const float* delta, float* dk, float* dv, const int* dims,
                            const long long* strides, float scale, void* stream) {
  Operands o{q, k, v, dout, m, l, delta, nullptr, dk, dv};
  return launch(o, dims, strides, scale, true, (cudaStream_t)stream);
}

// The bf16 passes: bf16 q, k, v, do, fp32 m, l and delta -> bf16 dq, or bf16
// dk and dv; the scores are scaled by `scale` rounded to bf16, dq by
// `scale` itself.
int repro_flash_bwd_dq_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                            const uint16_t* dout, const float* m, const float* l,
                            const float* delta, uint16_t* dq, const int* dims,
                            const long long* strides, float scale, void* stream) {
  OperandsBf16 o{q, k, v, dout, m, l, delta, dq, nullptr, nullptr};
  return launch_bf16(o, dims, strides, scale, false, (cudaStream_t)stream, 0);
}

int repro_flash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                             const uint16_t* dout, const float* m, const float* l,
                             const float* delta, uint16_t* dk, uint16_t* dv, const int* dims,
                             const long long* strides, float scale, void* stream) {
  OperandsBf16 o{q, k, v, dout, m, l, delta, nullptr, dk, dv};
  return launch_bf16(o, dims, strides, scale, true, (cudaStream_t)stream, 0);
}

// The bf16 passes at a chosen block tile: the rows a dq block owns or the
// keys a dk/dv block owns, 32 or 64 at head dim 128 (0 or the pass's own
// at the others); any other tile returns cudaErrorInvalidValue. For
// comparing the two tiles; the entries above take the pass's own.
int repro_flash_bwd_dq_bf16_tile(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                                 const uint16_t* dout, const float* m, const float* l,
                                 const float* delta, uint16_t* dq, const int* dims,
                                 const long long* strides, float scale, void* stream,
                                 int tile) {
  OperandsBf16 o{q, k, v, dout, m, l, delta, dq, nullptr, nullptr};
  return launch_bf16(o, dims, strides, scale, false, (cudaStream_t)stream, tile);
}

int repro_flash_bwd_dkv_bf16_tile(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                                  const uint16_t* dout, const float* m, const float* l,
                                  const float* delta, uint16_t* dk, uint16_t* dv,
                                  const int* dims, const long long* strides, float scale,
                                  void* stream, int tile) {
  OperandsBf16 o{q, k, v, dout, m, l, delta, nullptr, dk, dv};
  return launch_bf16(o, dims, strides, scale, true, (cudaStream_t)stream, tile);
}


}  // extern "C"
