// GQA flash-attention backward for Hopper (sm_90a): the two passes of the
// reference's two-pass flash backward, on the TF32 tensor cores in
// split-TF32.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_bwd_pallas, one entry point per pallas_call site and operand type:
//   :265 (_dq_kernel)  -> repro_flash_bwd_dq_f32,  flash_bwd_dq_kernel<D>
//                         repro_flash_bwd_dq_bf16, flash_bwd_dq_bf16_kernel<D>
//   :284 (_dkv_kernel) -> repro_flash_bwd_dkv_f32, flash_bwd_dkv_kernel<D>
//                         repro_flash_bwd_dkv_bf16, flash_bwd_dkv_bf16_kernel<D>
// The fp32 passes run on the TF32 tensor cores in split-TF32 (below); the
// bf16 passes (the training step at the reference's default bfloat16) on
// the bf16 tensor cores, with the reference's rounding points (the bf16
// section further down says where; the dv product keeps p in fp32 through a
// bf16 hi + lo split).
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
// What bounds the passes on this card (H100 SXM: 3.35 TB/s, 495 TFLOP/s of
// TF32, so 165 TFLOP/s at three products per multiply-add): dq does 6 and
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
// Design:
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

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;
using bf16mma::Bf16Rows;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using bf16mma::pack_raw;
using bf16mma::split_pair;

constexpr int kTile = 16;   // rows (dq) or keys (dk/dv) a block owns: one m16 tile
constexpr int kChunk = 16;  // keys (dq) or rows (dk/dv) per warp step: two n8 tiles
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
// The fp32 passes' blocks, warps, chunks, staging order and exact skips, on
// m16n8k16 bf16 MMAs with fp32 accumulators. Operands stay raw bf16 in
// shared memory ([16][DP] rows, Bf16Rows): S = Q K^T times the scale
// rounded to bf16 (qscale), dP = dO V^T; ds rounds to bf16 as it packs into
// the A fragment of ds.K (dq) and dS^T.Q (dk), exactly where the reference
// rounds it; dq is scaled by the fp32 scale at the end, dk by qscale (the
// reference's dk = bf16(ds)^T (q * bf16(scale)), with the product of two
// bf16 kept exact). dv = P^T dO keeps p in fp32, as the reference does: p is
// split into bf16 hi + lo (split_pair) and each multiply-add takes two MMAs,
// lo then hi, within about 2^-16 of p^T do, where one bf16 product would
// err by 2^-9. The plain version computes dv from fp32 p exactly.

// Stage the 16 rows of a warp's chunk of one bf16 operand into its
// [16][DP] buffer, by this warp's lanes: lanes r and r + 16 hold the element
// offset `off` of row r (< 0: zero-filled), which the others read by
// shuffles that every lane executes.
template <int D>
__device__ __forceinline__ void stage_rows_bf16(uint16_t* dst, const uint16_t* __restrict__ src,
                                                long long off, bool vec, int lane) {
  constexpr int DP = Bf16Rows<D>::DP;
  if (vec) {
    constexpr int kC = D / 8;  // 16-byte copies per row
    constexpr int kN = kChunk * kC;
#pragma unroll
    for (int i0 = 0; i0 < kN; i0 += 32) {
      const int i = i0 + lane;
      const int r = min(i / kC, kChunk - 1), c = i - r * kC;
      const long long o = __shfl_sync(0xffffffffu, off, r);
      if (i < kN)
        cp_async16(smem_addr(dst + r * DP + 8 * c), o >= 0 ? src + o + 8 * c : src, o >= 0);
    }
  } else {
    for (int i = lane; i < kChunk * D; i += 32) {  // 16 D: whole warps
      const int r = i / D, d = i - r * D;
      const long long o = __shfl_sync(0xffffffffu, off, r);
      dst[r * DP + d] = o >= 0 ? src[o + d] : (uint16_t)0;
    }
  }
}

// Stage keys key0 .. key0 + 15 of one bf16 K or V head into a [16][DP]
// chunk (keys past Sk zero-filled), by this warp's lanes.
template <int D>
__device__ __forceinline__ void stage_keys_bf16(uint16_t* dst, const uint16_t* __restrict__ src,
                                                long long base, long long ss, int key0,
                                                const BwdParams& p, int lane) {
  constexpr int DP = Bf16Rows<D>::DP;
  if (p.vec) {
    constexpr int kC = D / 8;
    for (int i = lane; i < kChunk * kC; i += 32) {
      const int r = i / kC, c = i - r * kC, key = key0 + r;
      const bool ok = key < p.sk;
      cp_async16(smem_addr(dst + r * DP + 8 * c), ok ? src + base + key * ss + 8 * c : src, ok);
    }
  } else {
    for (int i = lane; i < kChunk * D; i += 32) {
      const int r = i / D, d = i - r * D, key = key0 + r;
      dst[r * DP + d] = key < p.sk ? src[base + key * ss + d] : (uint16_t)0;
    }
  }
}

// Stage a block's 16-row tile of one bf16 operand by the whole block, with
// plain loads: row r at element offset row_off(r) (< 0: zero-filled).
template <int D, typename RowOff>
__device__ __forceinline__ void stage_tile_bf16(uint16_t* dst, const uint16_t* __restrict__ src,
                                                RowOff row_off, bool vec) {
  constexpr int DP = Bf16Rows<D>::DP;
  if (vec) {
    for (int i = threadIdx.x; i < kTile * (D / 8); i += kThreads) {
      const int r = i / (D / 8), d = (i - r * (D / 8)) * 8;
      const long long o = row_off(r);
      *reinterpret_cast<uint4*>(dst + r * DP + d) =
          o >= 0 ? *reinterpret_cast<const uint4*>(src + o + d) : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const long long o = row_off(r);
      dst[r * DP + d] = o >= 0 ? src[o + d] : (uint16_t)0;
    }
  }
}

// Zero the shared rows' columns D .. 15 that the k16 MMAs contract when the
// head dim is 8 (a no-op otherwise); the caller synchronises.
template <int D>
__device__ __forceinline__ void zero_pad_bf16(unsigned char* smem, int bytes) {
  if (D < 16)
    for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// acc[j] = A (16 x DK bf16 tile, rows g / g + 8) . B^T, where B's rows 8j + g
// (j = 0, 1) are a bf16 [16][DP] chunk: the S / dP shape of either pass,
// each k16 step's MMA into a fresh fragment added with a rounded FADD, as
// the forward forms its scores.
template <int D>
__device__ __forceinline__ void tile_product_bf16(float (&acc)[2][4], const uint16_t* at,
                                                  const uint16_t* bc, int g, int t) {
  constexpr int NS = Bf16Rows<D>::DK / 16, W = Bf16Rows<D>::W;
  const uint32_t* aw = reinterpret_cast<const uint32_t*>(at);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(bc);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NS; ++ks) {
    const int ao = g * W + 8 * ks + t;
    const uint32_t a[4] = {aw[ao], aw[ao + 8 * W], aw[ao + 4], aw[ao + 8 * W + 4]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int bo = (8 * j + g) * W + 8 * ks + t;
      float step[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(step, a, bw[bo], bw[bo + 4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += step[e];
    }
  }
}

// The A fragment of a 16 x 16 product from the C fragments x[j] of two n8
// tiles (a lane holds columns 8j + 2t, 8j + 2t + 1 of rows g (e < 2) and
// g + 8), rounded to bf16: A's own layout, no renaming needed.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// acc[n] += A . B[:, c0 + 8n ..] for n < NH, where B's 16 rows are a bf16
// [16][DP] chunk (B fragment: rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
// column g).
template <int D, int NH>
__device__ __forceinline__ void reg_product_bf16(float (&acc)[NH][4], const uint32_t (&a)[4],
                                                 const uint16_t* bc, int c0, int g, int t) {
  constexpr int DP = Bf16Rows<D>::DP;
  const uint16_t* br = bc + c0 + g;
#pragma unroll
  for (int n = 0; n < NH; ++n)
    mma_bf16(acc[n], a, pack_raw(br[8 * n + 2 * t * DP], br[8 * n + (2 * t + 1) * DP]),
             pack_raw(br[8 * n + (2 * t + 8) * DP], br[8 * n + (2 * t + 9) * DP]));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         const float* __restrict__ delta, uint16_t* __restrict__ dq,
                         BwdParams p) {
  constexpr int DP = Bf16Rows<D>::DP;
  constexpr int NT = D / 8;
  constexpr int PD = D + 4;  // fp32 partial rows
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint16_t* const qs = reinterpret_cast<uint16_t*>(smem_bytes);  // [16][DP]
  uint16_t* const dos = qs + kTile * DP;                          // dO [16][DP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* const kc = dos + kTile * DP + warp * 2 * kChunk * DP;  // this warp's K
  uint16_t* const vc = kc + kChunk * DP;                           // and V chunk
  zero_pad_bf16<D>(smem_bytes, (2 * kTile + kWarps * 2 * kChunk) * DP * 2);
  __syncthreads();

  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int r0 = blockIdx.x * kTile;
  const long long kb = b * p.k_sb + h * p.k_sh;
  const long long vb = b * p.v_sb + h * p.v_sh;

  int kend = p.sk;
  const int kv_lim = exact_kv_lim(p);
  if (kv_lim > 0) {
    kend = kv_lim;
    if (p.causal) kend = max(0, min(kend, p.q_offset + (min(r0 + kTile, p.rows) - 1) / p.g + 1));
  }
  const int n_chunks = (kend + kChunk - 1) / kChunk;

  int c = warp;
  if (c < n_chunks) stage_keys_bf16<D>(vc, v, vb, p.v_ss, c * kChunk, p, lane);
  cp_async_commit();
  if (c < n_chunks) stage_keys_bf16<D>(kc, k, kb, p.k_ss, c * kChunk, p, lane);
  cp_async_commit();

  const long long qb = b * p.q_sb + h * p.q_sh, dob = b * p.do_sb + h * p.do_sh;
  const RowInfo ri = row_info(r0 + (lane & 15), bkv, p, qb, dob, m_in, l_in, delta);
  const auto q_off = [&](int r) -> long long {
    const int row = r0 + r;
    if (row >= p.rows) return -1;
    const int s = row / p.g;
    return qb + (row - s * p.g) * p.q_sg + (long long)s * p.q_ss;
  };
  const auto do_off = [&](int r) -> long long {
    const int row = r0 + r;
    if (row >= p.rows) return -1;
    const int s = row / p.g;
    return dob + (row - s * p.g) * p.do_sg + (long long)s * p.do_ss;
  };
  stage_tile_bf16<D>(qs, q, q_off, p.vec);
  stage_tile_bf16<D>(dos, dout, do_off, p.vec);

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
    tile_product_bf16<D>(dp, dos, vc, g, t);
    __syncwarp();  // every lane is done with V(c)
    if (next) stage_keys_bf16<D>(vc, v, vb, p.v_ss, (c + kWarps) * kChunk, p, lane);
    cp_async_commit();

    cp_async_wait<1>();  // K(c) landed (V(c + 4) may still be in flight)
    __syncwarp();
    float sc[2][4];
    tile_product_bf16<D>(sc, qs, kc, g, t);
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const float pr = prob(sc[j][e] * p.qscale, qpos[hf], key0 + 8 * j + 2 * t + (e & 1),
                              mrow[hf], linv_row[hf], live[hf], p);
        ds[j][e] = pr * (dp[j][e] - drow[hf]);
      }
    uint32_t a[4];
    a_from_c(a, ds);  // bf16(ds)
    reg_product_bf16<D, NT>(acc, a, kc, 0, g, t);  // dq_w += bf16(ds) K
    __syncwarp();  // every lane is done with K(c)
    if (next) stage_keys_bf16<D>(kc, k, kb, p.k_ss, (c + kWarps) * kChunk, p, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warps' partial dq tiles (fp32 [16][D+4] over each warp's own K and V
  // chunks), summed in warp order, scaled once and rounded to bf16
  float* const mine = reinterpret_cast<float*>(kc);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(mine + (g + 8 * hf) * PD + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  __syncthreads();
  const float* part = reinterpret_cast<const float*>(dos + kTile * DP);
  constexpr int kPartStride = kChunk * DP;  // floats between two warps' partials
  const long long dqo = ri.qo < 0 ? -1 : b * p.dq_sb + h * p.dq_sh + ri.gg * p.dq_sg +
                                         ri.s * p.dq_ss;
  for (int i = tid; i < kTile * (D / 4); i += kThreads) {  // 4D: whole warps
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
    const long long o = __shfl_sync(0xffffffffu, dqo, r);
    if (o < 0) continue;
    float4 sum = *reinterpret_cast<const float4*>(part + r * PD + d);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(part + w * kPartStride + r * PD + d);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    const uint32_t y01 = pack_bf16(sum.x * p.scale, sum.y * p.scale);
    const uint32_t y23 = pack_bf16(sum.z * p.scale, sum.w * p.scale);
    uint16_t* dst = dq + o + d;
    if (p.vec) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(y01, y23);
    } else {
      dst[0] = (uint16_t)y01; dst[1] = (uint16_t)(y01 >> 16);
      dst[2] = (uint16_t)y23; dst[3] = (uint16_t)(y23 >> 16);
    }
  }
}

// One accumulator of the dk/dv pass out: each warp's partial (fp32 [16][DH+4]
// over its own Q and dO chunks), summed in warp order, times `mul`, rounded
// to bf16 and stored at columns c0 .. c0 + DH - 1 of keys k0 .. k0 + 15.
template <int D, int DH>
__device__ __forceinline__ void flush_dkv_bf16(const float (&acc)[DH / 8][4], uint16_t* chunk0,
                                               uint16_t* out, long long base, long long ss,
                                               int k0, int c0, float mul, const BwdParams& p) {
  constexpr int DP = Bf16Rows<D>::DP;
  constexpr int PD = DH + 4;
  constexpr int kPartStride = kChunk * DP;  // floats between two warps' partials
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* const part = reinterpret_cast<float*>(chunk0);
  float* const mine = part + warp * kPartStride;
  __syncthreads();  // every warp is done with the chunks (and the last flush)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(mine + (g + 8 * hf) * PD + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
  __syncthreads();
  for (int i = tid; i < kTile * (DH / 4); i += kThreads) {
    const int r = i / (DH / 4), d = (i - r * (DH / 4)) * 4, pos = k0 + r;
    if (pos >= p.sk) continue;
    float4 sum = *reinterpret_cast<const float4*>(part + r * PD + d);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(part + w * kPartStride + r * PD + d);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    const uint32_t y01 = pack_bf16(sum.x * mul, sum.y * mul);
    const uint32_t y23 = pack_bf16(sum.z * mul, sum.w * mul);
    uint16_t* dst = out + base + (long long)pos * ss + c0 + d;
    if (p.vec) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(y01, y23);
    } else {
      dst[0] = (uint16_t)y01; dst[1] = (uint16_t)(y01 >> 16);
      dst[2] = (uint16_t)y23; dst[3] = (uint16_t)(y23 >> 16);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta, uint16_t* __restrict__ dk,
                          uint16_t* __restrict__ dv, BwdParams p) {
  constexpr int DP = Bf16Rows<D>::DP;
  constexpr int DH = D > 128 ? 128 : D;  // output columns per sweep over the rows
  constexpr int NH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint16_t* const ks = reinterpret_cast<uint16_t*>(smem_bytes);  // K [16][DP]
  uint16_t* const vs = ks + kTile * DP;                           // V [16][DP]
  uint16_t* const chunk0 = vs + kTile * DP;                       // warp 0's chunks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* const qc = chunk0 + warp * 2 * kChunk * DP;  // this warp's Q
  uint16_t* const dc = qc + kChunk * DP;                 // and dO chunk
  zero_pad_bf16<D>(smem_bytes, (2 * kTile + kWarps * 2 * kChunk) * DP * 2);
  __syncthreads();

  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int k0 = blockIdx.x * kTile;
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long dob = b * p.do_sb + h * p.do_sh;

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

  int kpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) kpos[hf] = k0 + g + 8 * hf;
  const long long kb = b * p.k_sb + h * p.k_sh, vb = b * p.v_sb + h * p.v_sh;

  for (int c0 = 0; c0 < D; c0 += DH) {
    int c = c_begin + warp;
    RowInfo nxt = row_info(c * kChunk + (lane & 15), bkv, p, qb, dob, m_in, l_in, delta);
    if (c < c_end) stage_rows_bf16<D>(qc, q, nxt.qo, p.vec, lane);
    cp_async_commit();
    if (c < c_end) stage_rows_bf16<D>(dc, dout, nxt.doo, p.vec, lane);
    cp_async_commit();
    if (c0 == 0) {  // K and V, while the first chunks load
      stage_tile_bf16<D>(ks, k, [&](int r) -> long long {
        return k0 + r < p.sk ? kb + (long long)(k0 + r) * p.k_ss : -1;
      }, p.vec);
      stage_tile_bf16<D>(vs, v, [&](int r) -> long long {
        return k0 + r < p.sk ? vb + (long long)(k0 + r) * p.v_ss : -1;
      }, p.vec);
    }
    __syncthreads();  // K and V are staged

    float acc_k[NH][4], acc_v[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

    for (; c < c_end; c += kWarps) {
      const int row0 = c * kChunk;
      const bool next = c + kWarps < c_end;
      const RowInfo cur = nxt;
      if (next)
        nxt = row_info((c + kWarps) * kChunk + (lane & 15), bkv, p, qb, dob, m_in, l_in, delta);

      cp_async_wait<1>();  // Q(c) landed (dO(c) may still be in flight)
      __syncwarp();
      float sc[2][4];
      tile_product_bf16<D>(sc, ks, qc, g, t);  // S^T = K Q^T (times qscale below)
      cp_async_wait<0>();  // dO(c) landed
      __syncwarp();
      float dp[2][4];
      tile_product_bf16<D>(dp, vs, dc, g, t);  // dP^T = V dO^T

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
            pt[j][e] = prob(sc[j][e] * p.qscale, qpos, kpos[hf], m, linv, live, p);
            dst_t[j][e] = pt[j][e] * (dp[j][e] - dl);
          }
        }
      uint32_t a[4];
      a_from_c(a, dst_t);  // bf16(dS^T)
      reg_product_bf16<D, NH>(acc_k, a, qc, c0, g, t);  // dK += bf16(dS^T) Q
      __syncwarp();  // every lane is done with Q(c)
      if (next) stage_rows_bf16<D>(qc, q, nxt.qo, p.vec, lane);
      cp_async_commit();
      uint32_t ahi[4], alo[4];  // P^T in fp32: hi + lo
      split_pair(pt[0][0], pt[0][1], ahi[0], alo[0]);
      split_pair(pt[0][2], pt[0][3], ahi[1], alo[1]);
      split_pair(pt[1][0], pt[1][1], ahi[2], alo[2]);
      split_pair(pt[1][2], pt[1][3], ahi[3], alo[3]);
      reg_product_bf16<D, NH>(acc_v, alo, dc, c0, g, t);  // dV += P^T dO: lo,
      reg_product_bf16<D, NH>(acc_v, ahi, dc, c0, g, t);  // then hi
      __syncwarp();  // every lane is done with dO(c)
      if (next) stage_rows_bf16<D>(dc, dout, nxt.doo, p.vec, lane);
      cp_async_commit();
    }
    cp_async_wait<0>();
    flush_dkv_bf16<D, DH>(acc_k, chunk0, dk, b * p.dk_sb + h * p.dk_sh, p.dk_ss, k0, c0,
                          p.qscale, p);
    flush_dkv_bf16<D, DH>(acc_v, chunk0, dv, b * p.dv_sb + h * p.dv_sh, p.dv_ss, k0, c0, 1.f,
                          p);
    __syncthreads();  // every partial is read: the next sweep may stage over them
  }
}

// Shared bytes of either bf16 pass: two bf16 tiles [16][DP] and per warp two
// bf16 chunks: 43 KB at D = 128, 84 KB at D = 256.
template <int D>
constexpr int bwd_bf16_smem_bytes() {
  return (2 * kTile + kWarps * 2 * kChunk) * Bf16Rows<D>::DP * 2;
}

struct OperandsBf16 {
  const uint16_t *q, *k, *v, *dout;
  const float *m, *l, *delta;
  uint16_t *dq, *dk, *dv;
};

template <int D>
int launch_bf16_d(const OperandsBf16& o, const BwdParams& p, int nbkv, bool dkv_pass,
                  cudaStream_t stream) {
  static std::atomic<int> allowed_dq[kMaxDevices], allowed_dkv[kMaxDevices];
  const int smem = bwd_bf16_smem_bytes<D>();
  if (dkv_pass) {
    const cudaError_t e =
        allow_smem((const void*)flash_bwd_dkv_bf16_kernel<D>, smem, allowed_dkv);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.sk + kTile - 1) / kTile, nbkv);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dk, o.dv, p);
  } else {
    const cudaError_t e = allow_smem((const void*)flash_bwd_dq_bf16_kernel<D>, smem, allowed_dq);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.rows + kTile - 1) / kTile, nbkv);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dq, p);
  }
  return (int)cudaGetLastError();
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
                bool dkv_pass, cudaStream_t stream) {
  BwdParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, st, scale)) return e;
  p.vec = aligned(o.q, o.k, o.v, o.dout, o.dq, o.dk, o.dv, st, 8);
  switch (d) {
    case 8: return launch_bf16_d<8>(o, p, nbkv, dkv_pass, stream);
    case 16: return launch_bf16_d<16>(o, p, nbkv, dkv_pass, stream);
    case 32: return launch_bf16_d<32>(o, p, nbkv, dkv_pass, stream);
    case 64: return launch_bf16_d<64>(o, p, nbkv, dkv_pass, stream);
    case 128: return launch_bf16_d<128>(o, p, nbkv, dkv_pass, stream);
    case 256: return launch_bf16_d<256>(o, p, nbkv, dkv_pass, stream);
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
  return launch_bf16(o, dims, strides, scale, false, (cudaStream_t)stream);
}

int repro_flash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                             const uint16_t* dout, const float* m, const float* l,
                             const float* delta, uint16_t* dk, uint16_t* dv, const int* dims,
                             const long long* strides, float scale, void* stream) {
  OperandsBf16 o{q, k, v, dout, m, l, delta, nullptr, dk, dv};
  return launch_bf16(o, dims, strides, scale, true, (cudaStream_t)stream);
}

}  // extern "C"
