// MLA attention forward for Hopper (sm_90a): deepseek-v2's absorbed
// multi-head latent attention, one latent kv head under H query heads.
//
// Replaces no pallas_call site. The reference runs this region as its
// chunked jnp `flash_attention` (repro/models/attention.py:336, in
// `mla_attention`), which computes `flash_fwd_pallas`'s function
// (repro/kernels/flash_attention/kernel.py:94) at a shape the Pallas kernel
// cannot take: keys of width Dk = r + dr and values of width Dv = r. The
// port's GQA flash kernels (flash_attention.cu) need Dk = Dv <= 256 and at
// most 64 groups, and keep a 16 x D fp32 output accumulator per warp in
// registers, which at D = 512 is past the register file. Entry points:
//   repro_flash_fwd_mla_f32     fp32 q over an fp32 latent (c_kv, k_rope)
//   repro_flash_fwd_mla_bf16kv  fp32 q over a bf16 latent cache (the
//                               reference's cache for an int8 request)
//
// What it computes, for every batch b, position s and head h, with qpos =
// q_offset + s:
//   scores[k] = (q[b,s,h,:] * scale) . [c_kv[b,k,:] ; k_rope[b,k,:]]   k < Sk,
//   masked to NEG = -1e30 where (causal and qpos < k) or k >= kv_len,
//   m = max_k scores, l = sum_k exp(scores - m),
//   out[b,s,h,:] = sum_k exp(scores - m) c_kv[b,k,:] / max(l, 1e-30),
// and m, l = max(l, 1e-30), (B, Sq * H) with row s * H + h. A fully masked
// row gets the reference's answer, the mean of c_kv over all Sk keys. Over a
// bf16 latent it rounds where the reference does: scores are fp32 sums of
// fp32 q times bf16 keys, p is rounded to bf16 before P.V, out is rounded to
// bf16 once; m and l stay fp32. Limits against the plain version
// (`flash_fwd_mla_plain`): fp32 out 1e-4 * max|plain| + 1e-5 * min(1,
// max|plain|), m and l 1e-5 * max|plain|; bf16 out 2^-7 * max|plain|.
//
// Layout: q (B, Sq, H, r + dr), c_kv (B, Sk, r) and k_rope (B, Sk, dr) are
// read through element strides with a contiguous last dim, so a layer's view
// of the stacked (n_layers, B, S_max, r) cache is read in place and the
// keys [c_kv ; k_rope] are never concatenated in device memory. out (B, Sq,
// H, r), m and l are the wrapper's contiguous outputs. Instantiated at (r,
// dr) = (512, 64) (full width) and (32, 16) (reduced), for any H.
//
// What bounds it on this card (3.35 TB/s; 165 TFLOP/s of split-TF32): the
// served prefill (B 4, Sq 32, H 128, causal over 32 keys) moves 37.7 MB of
// q and 33.5 MB of out against 0.59 GFLOP: bytes, ~21 us, a streaming
// problem. A served decode step (Sq 1, <= 64 keys) moves ~2.7 MB: under a
// microsecond of bound, a latency problem: 32 row tiles of 16 rows are all
// the rows there are. A decode over 4,096 keys (B 4) does 4.6 GFLOP on
// 38 MB of fp32 latent: operations at split-TF32 (27.6 us).
//
// Design (PR 35; the first kernel, PR 29, kept one 4-warp block an SM with
// Q staged twice in shared memory, keys restaged by every 16 rows and 32
// blocks at decode):
// - Work: a row tile is 16 flattened (position, head) rows, row = s * H +
//   h (one m16 tile); keys come in tiles of 16 (two n8 tiles of S). One
//   block of 8 warps runs on an SM. It owns `nrt` row tiles of one batch
//   element (strided: block j takes tiles j, j + n, ... of n blocks, so a
//   causal prefill's blocks each mix short and long rows), one of `NCS`
//   column slices of the r output columns, and one of `nks` chunks of each
//   row tile's key tiles. `kernels/cuda.py::mla_fwd_split` picks the three
//   from (B, Sq * H, the keys visited): the served prefill takes 8 row
//   tiles a block (128 blocks), the served decode 4 column slices (128
//   blocks), a decode over 4,096 keys at B 4 splits its keys in 4 chunks
//   (128 blocks) that a second kernel combines.
// - Streaming: a row tile's q (16 x Dk fp32, unscaled) is staged by
//   cp.async into one of two shared q tiles while the row tile before it
//   computes; its out is staged back into the same tile and leaves as
//   16-byte stores of whole rows. Every global access is a 16-byte access
//   by consecutive threads.
// - S = Q K^T: each warp owns an eighth of S's k8 steps (warp w: steps w,
//   w + 8, ...), keeps its A fragments in registers for the row tile
//   (scaled as the plain version scales q, split into hi and lo as they
//   enter an MMA) and computes its part of the 16 x 16 score tile, three
//   steps' MMA chains interleaved, each step's products into a zeroed
//   fragment added with a rounded FADD; n8 tiles wholly past the visited
//   keys are skipped. A step's reduction index t is column 2t and t + 4
//   column 2t + 1, so a lane's two values are one 64-bit load.
// - Softmax once a row: after a barrier each warp sums two rows' eight
//   parts in warp order (one score a lane) and masks them. When all of a
//   row tile's key tiles fit the ring (the served prefill and decode), the
//   scores wait in shared memory until the last tile, and p = exp(s - m) is
//   formed against the row's max, as the plain version forms it (over a
//   bf16 latent p is rounded there); else the softmax runs online over the
//   row's 16 lanes a tile at a time. Over a bf16 latent with a row's keys in
//   one chunk, a first pass over its key tiles (S only) takes the row's max,
//   so that the online pass forms and rounds p against the row's max too (a
//   running max rounds p elsewhere, and that moved reduced deepseek-v2's
//   bf16 gradients past the train-step limits at S 128). p and the rescale
//   go to shared memory, so every warp's P.V sees the same p, m and l
//   bitwise.
// - P.V: the output accumulator is 16 x (r / NCS) fp32; each warp owns an
//   eighth of the block's columns (8 n8 tiles at full width and NCS 1: 32
//   registers a lane). fp32: split-TF32, three MMAs per step, four n8
//   tiles' chains interleaved, each tile's two k8 steps into a zeroed
//   fragment. bf16 latent: p is rounded to bf16 (as the reference rounds
//   it) and the values are bf16, so P.V runs on the bf16 tensor cores
//   (m16n8k16, B fragments by ldmatrix.trans), one MMA per n8 tile.
// - Keys: a ring of 16-key tiles [c_kv ; k_rope], three slots at fp32 (112
//   KB) and four over a bf16 latent (73 KB); 194 / 158 KB a block with the
//   q tiles and the exchange; staged by cp.async a ring's length ahead. A
//   slot remembers its tile, so a block whose row tiles see at most 48 (64)
//   keys (the served prefill: all positions share keys 0 .. 31) stages
//   each key once. A key row is read
//   once for both products: the keys of Q.K^T and, its first r columns, the
//   values of P.V. Rows are padded so fragment loads are conflict-free: fp32
//   to 8 (mod 32) words, bf16 to 4 (mod 32) words.
// - Key-split combine (nks > 1): each chunk writes its unnormalised fp32
//   accumulator, its m and its l to a workspace the wrapper allocates;
//   `flash_mla_combine_kernel` takes M = max m_j, L = sum_j exp(m_j - M)
//   l_j and out = sum_j exp(m_j - M) acc_j / max(L, 1e-30), over j in
//   order (no atomics: repeats are bitwise), and rounds a bf16 out once.
// - Masks and skips: a row tile visits keys [0, kend), kend its last
//   visible key + 1 (kv_len, the causal diagonal), taken only when every
//   row of the tile sees key 0; else all Sk keys (a row that sees none
//   averages them all). Keys at or past kend score -inf (p = 0); keys are
//   staged up to the block's kend and zero-filled past it; rows past
//   Sq * H compute on zeros and write nothing. Operands off 16-byte
//   alignment are staged by plain loads.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, raise the kernel's dynamic shared-memory
// limit once per device, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using smemio::ldmatrix_x4_trans;

constexpr float kNeg = -1e30f;
constexpr int kRows = 16;   // (position, head) rows per tile: one m16 tile
constexpr int kKeys = 16;   // keys per ring tile: two n8 tiles of S
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSP = kKeys;      // floats per row of a warp's partial score tile


struct MlaParams {
  int h, sq, sk, rows, tiles;    // tiles: row tiles per batch element
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  int nrt, nks, nb;              // row tiles a block, key chunks, batch
  float scale;
  int vec;  // q rows, c_kv and k_rope rows 16-byte aligned
  long long q_sb, q_ss, q_sh;
  long long c_sb, c_ss;
  long long r_sb, r_ss;
  long long o_sb, o_ss, o_sh;
};

// KT: the latent's element type (float, or uint16_t holding bf16 bits);
// NCS: column slices of the output.
template <typename KT, int R, int DR, int NCS>
struct MlaGeom {
  static constexpr bool kBf16 = !std::is_same<KT, float>::value;
  static constexpr int DK = R + DR;                         // key width
  static constexpr int KS = DK / 8;                         // k8 steps of S
  static constexpr int QS = (KS + kWarps - 1) / kWarps;     // of them a warp's
  static constexpr int SU = QS % 3 == 0 ? 3 : 1;            // of a warp's, in flight at once
  // elements per shared key row: fp32 8 (mod 32) words, bf16 4 (mod 32)
  static constexpr int KP = kBf16 ? DK + 8 : (DK + 23) / 32 * 32 + 8;
  static constexpr int QP = (DK + 23) / 32 * 32 + 8;        // words per shared q row
  static constexpr int SL = kBf16 ? 4 : 3;                  // key ring slots: tile i in slot i % SL
  static constexpr int PP = kKeys * SL + 4;                 // floats per row of the score / p tile
  static constexpr int NC = R / NCS;                        // columns a block owns
  static constexpr int OP = (NC + 23) / 32 * 32 + 8;        // words per staged out row
  // n8 tiles of out a warp owns (at r = 32 warps 4 .. 7 own none)
  static constexpr int NW = NC >= 8 * kWarps ? NC / (8 * kWarps) : 1;
  static constexpr int NU = NW % 4 ? NW : 4;                // of them in flight at once
  static constexpr int E = 16 / (int)sizeof(KT);            // elements per 16-byte copy
  static constexpr int kTileBytes = kKeys * KP * (int)sizeof(KT);
  static constexpr int kQBytes = kRows * QP * 4;            // one q tile (or out tile)
  static constexpr int kSmemBytes =
      SL * kTileBytes + 2 * kQBytes + (kWarps * kRows * kSP + kRows * PP + 2 * kRows) * 4;
  static_assert(DK % 8 == 0 && R % E == 0 && DR % E == 0, "copies must tile a key row");
  static_assert(NC % (8 * NW) == 0 && QS % SU == 0 && NW % NU == 0, "warp tiles");
  static_assert((KP * (int)sizeof(KT)) % 16 == 0, "key rows must stay 16-byte aligned");
  static_assert(OP <= QP && NC % E == 0, "an out tile is staged in a q tile's place");
  static_assert(kSmemBytes <= 232448, "past the 227 KB a block may use");
};

// The key range [0, kend) the rows at positions [s_first, s_last] visit: the
// exact skip, taken only when every row sees key 0.
__device__ __forceinline__ int visit_end(const MlaParams& p, int s_first, int s_last) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  int kend = p.sk;
  if (kv_lim > 0 && (!p.causal || p.q_offset + s_first >= 0)) {
    kend = kv_lim;
    if (p.causal) kend = min(kend, p.q_offset + s_last + 1);
  }
  return kend;
}

// Stage keys key0 .. key0 + 15 as rows [c_kv ; k_rope] of a ring tile, rows
// at or past `kclip` zero-filled, by all the block's threads.
template <typename KT, int R, int DR, int NCS>
__device__ __forceinline__ void stage_keys(KT* dst, const KT* __restrict__ ckv,
                                           const KT* __restrict__ krope, long long cb,
                                           long long rb, int key0, int kclip, const MlaParams& p,
                                           int tid) {
  using G = MlaGeom<KT, R, DR, NCS>;
  if (p.vec) {
    constexpr int CR = R / G::E, C = CR + DR / G::E;  // 16-byte copies per key row
    for (int i = tid; i < kKeys * C; i += kThreads) {
      const int r = i / C, c = i - r * C, pos = key0 + r;
      const bool ok = pos < kclip;
      const KT* src = c < CR ? ckv + cb + (long long)pos * p.c_ss + c * G::E
                             : krope + rb + (long long)pos * p.r_ss + (c - CR) * G::E;
      cp_async16(smem_addr(dst + r * G::KP + c * G::E), ok ? src : ckv, ok);
    }
  } else {
    for (int i = tid; i < kKeys * G::DK; i += kThreads) {
      const int r = i / G::DK, d = i - r * G::DK, pos = key0 + r;
      KT x = KT(0);
      if (pos < kclip)
        x = d < R ? ckv[cb + (long long)pos * p.c_ss + d] : krope[rb + (long long)pos * p.r_ss + d - R];
      dst[r * G::KP + d] = x;
    }
  }
}

// Stage row tile `rt`'s q (16 rows of Dk fp32, unscaled; rows past Sq * H
// zero-filled), by all the block's threads.
template <typename KT, int R, int DR, int NCS>
__device__ __forceinline__ void stage_q(float* dst, const float* __restrict__ q, int b, int rt,
                                        const MlaParams& p, int tid) {
  using G = MlaGeom<KT, R, DR, NCS>;
  constexpr int C = G::DK / 4;  // 16-byte copies per row
  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i - r * C, row = rt * kRows + r;
    const int s = row / p.h, hh = row - s * p.h;
    const float* src = q + b * p.q_sb + s * p.q_ss + hh * p.q_sh + 4 * c;
    if (p.vec) {
      cp_async16(smem_addr(dst + r * G::QP + 4 * c), row < p.rows ? src : q, row < p.rows);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < p.rows) x = make_float4(src[0], src[1], src[2], src[3]);
      *reinterpret_cast<float4*>(dst + r * G::QP + 4 * c) = x;
    }
  }
}

// Four adjacent output values of a row: fp32, or rounded to bf16 (to
// nearest, ties to even) and packed: one 16- or 8-byte store.
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(uint16_t* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// The key index (0 .. 15 in its tile) of lane quad position t's i-th score
// of a row, in the A-fragment layout P.V takes: m16n8k8 TF32 (fp32 latent)
// t, t + 4, 8 + t, 12 + t; m16n8k16 bf16 2t, 2t + 1, 8 + 2t, 9 + 2t.
template <bool kBf16>
__device__ __forceinline__ int p_key(int i, int t) {
  return kBf16 ? (i >> 1) * 8 + 2 * t + (i & 1) : (i >> 1) * 8 + (i & 1) * 4 + t;
}

// out / ws_*: with nks == 1 the normalised out and m, l; else the chunk's
// unnormalised fp32 accumulator ws (nks, B, rows, r) and its m, l (nks, B,
// rows) in ws_m, ws_l, combined by flash_mla_combine_kernel.
template <typename KT, int R, int DR, int NCS>
__global__ void __launch_bounds__(kThreads, 1)
flash_mla_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                 const KT* __restrict__ krope, KT* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ ws, float* __restrict__ ws_m,
                 float* __restrict__ ws_l, MlaParams p) {
  using G = MlaGeom<KT, R, DR, NCS>;
  constexpr int KP = G::KP, QP = G::QP, OP = G::OP, NW = G::NW, QS = G::QS, SL = G::SL;
  constexpr int PP = G::PP;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* const ring = reinterpret_cast<KT*>(smem);  // SL x [kKeys][KP]
  float* const qbuf = reinterpret_cast<float*>(smem + SL * G::kTileBytes);  // 2 x [16][QP]
  float* const part = qbuf + 2 * kRows * QP;       // [8][16][kSP]: each warp's part of S
  float* const ptile = part + kWarps * kRows * kSP;  // [16][PP]: scores, then p
  float* const alpha = ptile + kRows * PP;           // [16]: each row's rescale
  float* const inv = alpha + kRows;                  // [16]: each row's 1 / l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rr = 2 * warp + (lane >> 4), kk = lane & 15;  // the score this lane reduces
  const int b = blockIdx.y;
  int bx = blockIdx.x;
  const int kc = bx % p.nks;  // this block's key chunk
  bx /= p.nks;
  const int cs = bx % NCS;  // its column slice
  // its row tiles rblk, rblk + nrb, ...: spread over the positions, so that
  // the blocks of a causal prefill see as many keys each
  const int nrb = (p.tiles + p.nrt - 1) / p.nrt, rblk = bx / NCS;
  const int rlast = rblk + (p.tiles - 1 - rblk) / nrb * nrb;
  const long long cb = b * p.c_sb, rb = b * p.r_sb;
  const bool owns = warp * 8 * NW < G::NC;  // this warp owns output columns
  const int cw = warp * 8 * NW;             // its first one in the block's slice
  const int c0 = cs * G::NC + cw;
  // keys past the last one any row of the block visits are zero-filled
  const int kclip = visit_end(p, rblk * kRows / p.h, (min(rlast * kRows + kRows, p.rows) - 1) / p.h);
  // the key tile each ring slot holds (-1: none)
  int held[SL];
#pragma unroll
  for (int s = 0; s < SL; ++s) held[s] = -1;
  // stage tile `tile` into slot tile % SL unless it is there; always commit
  // one cp.async group, so that the groups in flight count tiles
  auto stage = [&](int tile, bool want) {
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      if (want && tile % SL == s && held[s] != tile) {
        stage_keys<KT, R, DR, NCS>(ring + s * kKeys * KP, ckv, krope, cb, rb, tile * kKeys,
                                   kclip, p, tid);
        held[s] = tile;
      }
    }
    cp_async_commit();
  };

  stage_q<KT, R, DR, NCS>(qbuf, q, b, rblk, p, tid);
  cp_async_commit();

  for (int k = 0, rt = rblk; rt < p.tiles; ++k, rt += nrb) {
    float* const qt = qbuf + (k & 1) * kRows * QP;  // this row tile's q, then its out
    const int r0 = rt * kRows;
    const int kend = visit_end(p, r0 / p.h, (min(r0 + kRows, p.rows) - 1) / p.h);
    const int nt = (kend + kKeys - 1) / kKeys;  // >= 1: kend >= 1
    int t0 = 0, t1 = nt;
    if (p.nks > 1) {
      const int per = (nt + p.nks - 1) / p.nks;
      t0 = min(kc * per, nt);
      t1 = min(t0 + per, nt);
    }
    __syncthreads();  // the previous row tile is done with the ring; its out is written
    // cp.async groups: tiles t0 .. t0 + SL - 2, the next row tile's q (into
    // the other buffer: it lands while this row tile computes), then one a
    // tile; this row tile's q, older, lands meanwhile
#pragma unroll
    for (int d = 0; d < SL - 1; ++d) stage(t0 + d, t0 + d < t1);
    if (rt + nrb < p.tiles)
      stage_q<KT, R, DR, NCS>(qbuf + ((k + 1) & 1) * kRows * QP, q, b, rt + nrb, p, tid);
    cp_async_commit();
    cp_async_wait<SL>();  // this row tile's q landed
    __syncthreads();      // ... for every thread

    // this warp's A fragments of Q, scaled as the plain version scales them:
    // qf[i][hf] holds columns 2t, 2t + 1 of step warp + 8i for row g + 8hf
    float2 qf[QS][2];
#pragma unroll
    for (int i = 0; i < QS; ++i) {
      const int ks = min(warp + kWarps * i, G::KS - 1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 x = *reinterpret_cast<const float2*>(qt + (g + 8 * hf) * QP + 8 * ks + 2 * t);
        qf[i][hf] = make_float2(x.x * p.scale, x.y * p.scale);
      }
    }
    // the softmax state of row rr, held by the 16 lanes that reduce it
    const int qpos = p.q_offset + (r0 + rr) / p.h;
    float mrow = kNeg, lrow = 0.f;
    float acc[NW][4];
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    // p for P.V from the score / p tile at column `pc`, rows g and g + 8
    auto pv_tile = [&](const KT* kt, int key0, int pc) {
      float pv[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[hf][i] = ptile[(g + 8 * hf) * PP + pc + p_key<G::kBf16>(i, t)];
      if constexpr (G::kBf16) {
        // p rounded to bf16 (exact in the MMA), values bf16: m16n8k16, one
        // MMA per n8 tile; ldmatrix.trans gives (keys 2t, 2t + 1 | 2t + 8,
        // 2t + 9) of column g for two n8 tiles at once
        const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]), pack_bf16(pv[1][0], pv[1][1]),
                                pack_bf16(pv[0][2], pv[0][3]), pack_bf16(pv[1][2], pv[1][3])};
        const int mi = lane >> 3;
#pragma unroll
        for (int n = 0; n < NW; n += 2) {
          const int n2 = n + 1 < NW ? 1 : 0;  // an odd last tile loads itself twice
          uint32_t bm[4];
          ldmatrix_x4_trans(bm, smem_addr(kt + ((mi & 1) * 8 + (lane & 7)) * KP + c0 +
                                          8 * (n + (mi >> 1) * n2)));
          float ca[4] = {0.f, 0.f, 0.f, 0.f}, cb2[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(ca, pa, bm[0], bm[1]);
          mma_bf16(cb2, pa, bm[2], bm[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += ca[e];
          if (n + 1 < NW) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n + 1][e] += cb2[e];
          }
        }
      } else {
        // split-TF32: step j's reduction index t is key 8j + t, t + 4 key
        // 8j + t + 4 (pv[hf][2j], pv[hf][2j + 1]); NU n8 tiles' chains
        // interleaved, each tile's two steps into a zeroed fragment
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          split(pv[0][2 * j], ph[j][0], pl[j][0]);
          split(pv[1][2 * j], ph[j][1], pl[j][1]);
          split(pv[0][2 * j + 1], ph[j][2], pl[j][2]);
          split(pv[1][2 * j + 1], ph[j][3], pl[j][3]);
        }
        const int nj = (kend - key0) > 8 ? 2 : 1;  // k8 steps with keys below kend
        constexpr int NU = G::NU;
#pragma unroll
        for (int n0 = 0; n0 < NW; n0 += NU) {
          float c[NU][4];
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[u][e] = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j >= nj) break;
            uint32_t bh[NU][2], bl[NU][2];
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              const float* v0 = kt + (8 * j + t) * KP + c0 + 8 * (n0 + u) + g;
              split(v0[0], bh[u][0], bl[u][0]);
              split(v0[4 * KP], bh[u][1], bl[u][1]);
            }
#pragma unroll
            for (int u = 0; u < NU; ++u) mma_tf32(c[u], pl[j], bh[u][0], bh[u][1]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma_tf32(c[u], ph[j], bl[u][0], bl[u][1]);
#pragma unroll
            for (int u = 0; u < NU; ++u) mma_tf32(c[u], ph[j], bh[u][0], bh[u][1]);
          }
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n0 + u][e] += c[u][e];
        }
      }
    };

    // all of this row tile's key tiles fit the ring: its softmax runs once,
    // over all of them (p against the row's max, as the plain version forms
    // it); else online, a tile at a time. Over a bf16 latent with the row's
    // keys in one chunk, a first pass over the tiles takes the row's max, so
    // that the online pass forms and rounds p against it, as the plain
    // version does (its rescales are then exp(0) = 1)
    const bool whole = t1 - t0 <= SL;
    const bool premax = G::kBf16 && !whole && p.nks == 1;
    for (int pass = premax ? 0 : 1; pass < 2; ++pass) {
      if (pass == 1 && premax) {
        __syncthreads();  // every warp is done with the first pass's tiles and parts
#pragma unroll
        for (int d = 0; d < SL - 1; ++d) stage(t0 + d, t0 + d < t1);
      }
      for (int it = t0; it < t1; ++it) {
        // tile `it` landed: behind it in flight may be the tiles up to it + SL
        // - 2 and, for the first SL - 1 of the first pass, the next q
        if (it < t0 + SL - 1 && !(premax && pass == 1))
          cp_async_wait<SL - 1>();
        else
          cp_async_wait<SL - 2>();
        __syncthreads();  // ... for every thread; every warp is done with tile it - 1
        stage(it + SL - 1, it + SL - 1 < t1);  // into tile it - 1's slot
        const KT* const kt = ring + (it % SL) * kKeys * KP;
        const int key0 = it * kKeys;

        // this warp's part of S over its k8 steps and the NV n8 tiles with keys
        // below kend, SU steps' MMA chains interleaved (each step's products
        // into a zeroed fragment), into the partial tile: rows g (e = 0, 1) and
        // g + 8 (e = 2, 3), keys 8n + 2t + e % 2
        auto s_part = [&](auto nv) {
          constexpr int NV = decltype(nv)::value;
          float sp[NV][4];
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sp[n][e] = 0.f;
#pragma unroll
          for (int i0 = 0; i0 < QS; i0 += G::SU) {
            if (G::KS % kWarps != 0 && warp + kWarps * i0 >= G::KS) break;
            uint32_t ah[G::SU][4], al[G::SU][4], bh[G::SU][NV][2], bl[G::SU][NV][2];
            float c[G::SU][NV][4];
#pragma unroll
            for (int u = 0; u < G::SU; ++u) {
              const int i = i0 + u, ks = warp + kWarps * i;
              split(qf[i][0].x, ah[u][0], al[u][0]);
              split(qf[i][1].x, ah[u][1], al[u][1]);
              split(qf[i][0].y, ah[u][2], al[u][2]);
              split(qf[i][1].y, ah[u][3], al[u][3]);
#pragma unroll
              for (int n = 0; n < NV; ++n) {
                const KT* kr = kt + (8 * n + g) * KP + 8 * ks + 2 * t;
                if constexpr (G::kBf16) {  // keys exact in TF32: q's two parts only
                  const uint32_t w = *reinterpret_cast<const uint32_t*>(kr);
                  bh[u][n][0] = w << 16;
                  bh[u][n][1] = w & 0xffff0000u;
                } else {
                  const float2 kv = *reinterpret_cast<const float2*>(kr);
                  split(kv.x, bh[u][n][0], bl[u][n][0]);
                  split(kv.y, bh[u][n][1], bl[u][n][1]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) c[u][n][e] = 0.f;
              }
            }
            // tf32_mma.cuh's mma_split order per chain: lo * hi, hi * lo, hi * hi
#pragma unroll
            for (int u = 0; u < G::SU; ++u)
#pragma unroll
              for (int n = 0; n < NV; ++n) mma_tf32(c[u][n], al[u], bh[u][n][0], bh[u][n][1]);
            if constexpr (!G::kBf16) {
#pragma unroll
              for (int u = 0; u < G::SU; ++u)
#pragma unroll
                for (int n = 0; n < NV; ++n) mma_tf32(c[u][n], ah[u], bl[u][n][0], bl[u][n][1]);
            }
#pragma unroll
            for (int u = 0; u < G::SU; ++u)
#pragma unroll
              for (int n = 0; n < NV; ++n) mma_tf32(c[u][n], ah[u], bh[u][n][0], bh[u][n][1]);
#pragma unroll
            for (int u = 0; u < G::SU; ++u)
#pragma unroll
              for (int n = 0; n < NV; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) sp[n][e] += c[u][n][e];
          }
          float* const mine = part + warp * kRows * kSP;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            *reinterpret_cast<float2*>(mine + g * kSP + 8 * n + 2 * t) =
                make_float2(sp[n][0], sp[n][1]);
            *reinterpret_cast<float2*>(mine + (g + 8) * kSP + 8 * n + 2 * t) =
                make_float2(sp[n][2], sp[n][3]);
          }
        };
        if (kend - key0 > 8)
          s_part(std::integral_constant<int, 2>{});
        else
          s_part(std::integral_constant<int, 1>{});
        __syncthreads();  // every warp's part landed

        // this lane's score (row rr, key kk), summed over the parts in warp
        // order and masked, and the row's max over its 16 lanes
        const int kpos = key0 + kk;
        float x = part[rr * kSP + kk];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) x += part[(w * kRows + rr) * kSP + kk];
        if (kpos >= kend)
          x = -INFINITY;  // past the visited keys: no part in the softmax
        else if ((p.causal && qpos < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len))
          x = kNeg;
        float mx = x;
#pragma unroll
        for (int d = 1; d < 16; d *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
        const float mnew = fmaxf(mrow, mx);
        if (whole || pass == 0) {  // keep the score (P.V after the last tile), or the max
          if (whole) ptile[rr * PP + kKeys * (it - t0) + kk] = x;
          mrow = mnew;
          continue;
        }
        // the online softmax: p and the row's rescale to shared memory
        const float a = expf(mrow - mnew), pe = expf(x - mnew);
        float ps = pe;
#pragma unroll
        for (int d = 1; d < 16; d *= 2) ps += __shfl_xor_sync(0xffffffffu, ps, d);
        lrow = lrow * a + ps;
        mrow = mnew;
        ptile[rr * PP + kk] = pe;
        if (kk == 0) alpha[rr] = a;
        __syncthreads();  // p and the rescale landed
        if (!owns) continue;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float sc = alpha[g + 8 * hf];
#pragma unroll
          for (int n = 0; n < NW; ++n) {
            acc[n][2 * hf] *= sc;
            acc[n][2 * hf + 1] *= sc;
          }
        }
        pv_tile(kt, key0, 0);
      }
    }
    if (whole && t0 < t1) {
      // p = exp(score - the row's max) for every key the row tile visits,
      // l their sum; then P.V over the resident tiles
      float ps = 0.f;
      for (int j = 0; j < t1 - t0; ++j) {
        float* const sc = ptile + rr * PP + kKeys * j + kk;
        *sc = expf(*sc - mrow);
        ps += *sc;
      }
#pragma unroll
      for (int d = 1; d < 16; d *= 2) ps += __shfl_xor_sync(0xffffffffu, ps, d);
      lrow = ps;
      __syncthreads();  // p landed
      if (owns)
        for (int it = t0; it < t1; ++it)
          pv_tile(ring + (it % SL) * kKeys * KP, it * kKeys, kKeys * (it - t0));
    }

    // m, l and 1 / l of row rr from its lanes; then out (normalised; a
    // chunk's part unnormalised) staged in this row tile's q buffer, which
    // every warp has read, and written as 16-byte stores of whole rows
    const bool chunk = p.nks > 1;
    if (kk == 0) {
      inv[rr] = chunk ? 1.f : 1.f / fmaxf(lrow, 1e-30f);
      const int row = r0 + rr;
      if (row < p.rows && cs == 0) {
        const long long mi = (long long)b * p.rows + row;
        if (chunk) {
          ws_m[kc * (long long)p.nb * p.rows + mi] = mrow;
          ws_l[kc * (long long)p.nb * p.rows + mi] = lrow;
        } else {
          m_out[mi] = mrow;
          l_out[mi] = fmaxf(lrow, 1e-30f);
        }
      }
    }
    __syncthreads();  // 1 / l landed; every warp is done with the q tile
    if (owns) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s = inv[g + 8 * hf];
#pragma unroll
        for (int n = 0; n < NW; ++n)
          *reinterpret_cast<float2*>(qt + (g + 8 * hf) * OP + cw + 8 * n + 2 * t) =
              make_float2(acc[n][2 * hf] * s, acc[n][2 * hf + 1] * s);
      }
    }
    __syncthreads();  // the out tile is staged
    {
      constexpr int C4 = G::NC / 4;  // float4s of a staged row
      for (int i = tid; i < kRows * C4; i += kThreads) {
        const int r = i / C4, c = (i - r * C4) * 4, row = r0 + r;
        if (row >= p.rows) continue;
        const float4 x = *reinterpret_cast<const float4*>(qt + r * OP + c);
        const int col = cs * G::NC + c;
        if (chunk) {
          *reinterpret_cast<float4*>(ws + (((long long)kc * p.nb + b) * p.rows + row) * R + col) = x;
        } else {
          const int s = row / p.h, hh = row - s * p.h;
          store4(o + b * p.o_sb + s * p.o_ss + hh * p.o_sh + col, x);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// The key chunks' parts -> out, m, l: one thread per (row, 4 columns), the
// chunks in order.
template <typename KT, int R>
__global__ void __launch_bounds__(kThreads)
flash_mla_combine_kernel(const float* __restrict__ ws, const float* __restrict__ ws_m,
                         const float* __restrict__ ws_l, KT* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, MlaParams p) {
  const long long n_rows = (long long)p.nb * p.rows;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows * (R / 4)) return;
  const long long ri = i / (R / 4);  // b * rows + row
  const int col = (int)(i - ri * (R / 4)) * 4;
  float mx = kNeg;
  for (int j = 0; j < p.nks; ++j) mx = fmaxf(mx, ws_m[j * n_rows + ri]);
  float l = 0.f;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < p.nks; ++j) {
    const float w = expf(ws_m[j * n_rows + ri] - mx);
    l += w * ws_l[j * n_rows + ri];
    const float4 a = *reinterpret_cast<const float4*>(ws + (j * n_rows + ri) * R + col);
    s.x += w * a.x;
    s.y += w * a.y;
    s.z += w * a.z;
    s.w += w * a.w;
  }
  l = fmaxf(l, 1e-30f);
  const int b = (int)(ri / p.rows), row = (int)(ri - (long long)b * p.rows);
  const int sq = row / p.h, hh = row - sq * p.h;
  store4(o + b * p.o_sb + sq * p.o_ss + hh * p.o_sh + col,
         make_float4(s.x / l, s.y / l, s.z / l, s.w / l));
  if (col == 0) {
    m_out[ri] = mx;
    l_out[ri] = l;
  }
}

template <typename KT, int R, int DR, int NCS>
int launch_mla(const float* q, const KT* ckv, const KT* krope, KT* o, float* m, float* l,
               float* ws, const MlaParams& p, cudaStream_t stream) {
  using G = MlaGeom<KT, R, DR, NCS>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)flash_mla_kernel<KT, R, DR, NCS>,
                                   G::kSmemBytes, allowed);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((p.tiles + p.nrt - 1) / p.nrt) * NCS * p.nks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)p.nb * p.rows;
  float* ws_m = ws + (long long)p.nks * n_rows * R;
  float* ws_l = ws_m + (long long)p.nks * n_rows;
  flash_mla_kernel<KT, R, DR, NCS><<<dim3((unsigned)blocks, p.nb), kThreads, G::kSmemBytes,
                                     stream>>>(q, ckv, krope, o, m, l, ws, ws_m, ws_l, p);
  if (p.nks > 1) {
    const long long threads = n_rows * (R / 4);
    flash_mla_combine_kernel<KT, R><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                                      0, stream>>>(ws, ws_m, ws_l, o, m, l, p);
  }
  return (int)cudaGetLastError();
}

// dims: b, h, sq, sk, r, dr, causal, q_offset, kv_len (< 0: none), then the
// split (kernels/cuda.py::mla_fwd_split): row tiles a block, column slices
// (1, or 4 at r = 512), key chunks
// strides (elements): q b,s,h; c_kv b,s; k_rope b,s; out b,s,h
// ws: nks * B * Sq * H * (r + 2) fp32 of workspace when nks > 1, else unused
template <typename KT>
int run(const float* q, const KT* ckv, const KT* krope, KT* out, float* m, float* l,
        float* ws, const int* dims, const long long* st, float scale, void* stream) {
  MlaParams p;
  p.nb = dims[0];
  const int r = dims[4], dr = dims[5], ncs = dims[10];
  p.h = dims[1];
  p.sq = dims[2];
  p.sk = dims[3];
  p.causal = dims[6];
  p.q_offset = dims[7];
  p.kv_len = dims[8];
  p.nrt = dims[9];
  p.nks = dims[11];
  p.scale = scale;
  if (p.nb < 1 || p.nb > 65535 || p.h < 1 || p.sq < 1 || p.sk < 1 || p.nrt < 1 || p.nks < 1 ||
      (long long)p.sq * p.h > 0x7fffffffLL - kRows || (p.nks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  p.rows = p.sq * p.h;
  p.tiles = (p.rows + kRows - 1) / kRows;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.c_sb = st[3]; p.c_ss = st[4];
  p.r_sb = st[5]; p.r_ss = st[6];
  p.o_sb = st[7]; p.o_ss = st[8]; p.o_sh = st[9];
  // out takes stores of 4 elements (16 or 8 bytes): its base and strides
  // must keep them aligned (the wrapper allocates it contiguous)
  if ((uintptr_t)out % (4 * sizeof(KT)) || (p.o_sb | p.o_ss | p.o_sh) % 4)
    return (int)cudaErrorInvalidValue;
  const int per16 = 16 / (int)sizeof(KT);
  p.vec = ((uintptr_t)q % 16 == 0) && (p.q_sb % 4 == 0) && (p.q_ss % 4 == 0) &&
          (p.q_sh % 4 == 0) && ((uintptr_t)ckv % 16 == 0) && ((uintptr_t)krope % 16 == 0) &&
          (p.c_sb % per16 == 0) && (p.c_ss % per16 == 0) && (p.r_sb % per16 == 0) &&
          (p.r_ss % per16 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (r == 32 && dr == 16 && ncs == 1)
    return launch_mla<KT, 32, 16, 1>(q, ckv, krope, out, m, l, ws, p, s);
  if (r == 512 && dr == 64 && ncs == 1)
    return launch_mla<KT, 512, 64, 1>(q, ckv, krope, out, m, l, ws, p, s);
  if (r == 512 && dr == 64 && ncs == 4)
    return launch_mla<KT, 512, 64, 4>(q, ckv, krope, out, m, l, ws, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// fp32 q over an fp32 latent -> fp32 out (B, Sq, H, r), m and l (B, Sq * H).
int repro_flash_fwd_mla_f32(const float* q, const float* ckv, const float* krope, float* out,
                            float* m, float* l, float* ws, const int* dims,
                            const long long* strides, float scale, void* stream) {
  return run<float>(q, ckv, krope, out, m, l, ws, dims, strides, scale, stream);
}

// fp32 q over a bf16 latent -> bf16 out (B, Sq, H, r), fp32 m and l.
int repro_flash_fwd_mla_bf16kv(const float* q, const uint16_t* ckv, const uint16_t* krope,
                               uint16_t* out, float* m, float* l, float* ws, const int* dims,
                               const long long* strides, float scale, void* stream) {
  return run<uint16_t>(q, ckv, krope, out, m, l, ws, dims, strides, scale, stream);
}

}  // extern "C"
