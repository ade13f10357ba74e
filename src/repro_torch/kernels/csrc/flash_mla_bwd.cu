// MLA attention backward for Hopper (sm_90a): the gradients of
// deepseek-v2's absorbed multi-head latent attention (flash_mla.cu's
// function), one latent kv head under H query heads.
//
// Replaces no pallas_call site. The reference differentiates its chunked
// jnp `flash_attention` (repro/models/attention.py:336, in `mla_attention`)
// with JAX's autodiff; its Pallas flash backward (`flash_bwd_pallas`,
// repro/kernels/flash_attention/kernel.py:263) cannot take MLA's shape (keys
// of width Dk = r + dr, values of width Dv = r), and the port's GQA
// backward kernels (flash_attention_bwd.cu) need Dk = Dv <= 256. Entry
// points:
//   repro_flash_bwd_mla_dq_f32 / _bf16    the dq pass
//   repro_flash_bwd_mla_dkv_f32 / _bf16   the dc_kv / dk_rope pass
// _f32: fp32 q, c_kv, k_rope, do; _bf16: the fp32 q over a bf16 latent
// and a bf16 do, outputs in bf16 (the training path at bf16 hands in q
// already multiplied by the scale and rounded to bf16, as the reference's
// `q * scale` rounds it, with scale 1).
//
// What it computes, for every batch b and row (s, h), row = s * H + h, with
// qs = q * scale, keys K = [c_kv ; k_rope], qpos = q_offset + s and the
// forward's m and l (B, Sq * H) and delta = rowsum(do * out) (B, Sq * H):
//   masked(k) = (causal and qpos < k) or k >= kv_len,
//   s_k  = qs . K_k (NEG = -1e30 where masked), p_k = exp(s_k - m) / l,
//   dp_k = do . c_kv_k, ds_k = masked(k) ? 0 : p_k * (dp_k - delta),
//   dq   = dscale * sum_k ds_k K_k                       (dq pass)
//   dc_kv_k = sum_rows ds_k qs[:r] + p_k do, dk_rope_k = sum_rows ds_k qs[r:]
//                                                         (dkv pass)
// Keys past Sk take no part. A row that sees no key has m = NEG and p = 1 / l
// on every key: its out is the mean of c_kv, so c_kv gets p do from it, and
// ds is 0 there, as the reference's `where` passes no gradient to masked
// scores. A bf16 output is rounded once (to nearest, ties to even). Limits
// against the plain version (`flash_bwd_mla_plain`): fp32 1e-4 * max|plain|
// + 1e-5 * min(1, max|plain|) + 8 * 2^-24 * S * max|plain| at scores up to S
// (the scores are recomputed in another order than the forward's m took
// them); bf16 2^-7 * max|plain|.
//
// Layout: q (B, Sq, H, r + dr), do (B, Sq, H, r), c_kv (B, Sk, r), k_rope
// (B, Sk, dr), all contiguous, so row s * H + h of batch b is row b * Sq * H
// + s * H + h of q and do; m, l, delta (B, Sq * H). Outputs dq in q's shape,
// dc_kv and dk_rope in the latents' shapes, contiguous. Instantiated at (r,
// dr) = (512, 64) (full width) and (32, 16) (reduced), for any H.
//
// What bounds it on this card (3.35 TB/s; 165 TFLOP/s of split-TF32):
// operations. Full-width deepseek-v2's sublayer at B 2, S 128, H 128,
// causal: 2.1 M visible (row, key) pairs; the dq pass does 2 (Dk + Dv + Dk)
// = 3,328 operations a pair (s, dp, ds.K) and the dkv pass 2 (Dk + Dv + 2
// Dv + dr) = 4,352 (s, dp, ds^T qs, p^T do): 7.0 and 9.2 GFLOP against 75
// MB of q and 34 MB of do (at bf16). Past the bound, what limits the design
// is shared memory: at Dk 576 fp32 a tile of 16 rows of q and do is 70 KB
// and one of 32 keys 74 KB, so one block of 8 warps runs on an SM.
//
// Design (the products on the TF32 tensor cores, mma.sync m16n8k8,
// tf32_mma.cuh; 8 warps a block):
// - Each pass stages one operand side once and streams the other through a
//   two-stage cp.async ring (the next tile in flight while one is used):
//   a dq block owns 32 rows (q and do resident; at H 128 one position's
//   heads, which share every key and the causal bound) and walks the
//   visible keys in ring tiles of 16; a dkv block owns 32 keys ([c_kv ;
//   k_rope] resident) and walks one chunk of its batch element's rows in
//   ring tiles of 16, skipping a tile none of whose rows sees its keys (and
//   every row of which sees some key), so each staged q / do tile serves
//   32 keys. Shared memory per block at (512, 64): 227,200 bytes fp32,
//   157,568 bf16.
// - S and dP of a 32 x 16 (dq) or 16 x 32 (dkv) tile: each warp computes a
//   16 x 16 block of S (warps 0-3) or dP (warps 4-7) over half the
//   contraction (288 of S's 576 columns, 256 of dP's 512), four k8 steps'
//   MMA chains interleaved in zeroed fragments, fp32 fragments by ldmatrix;
//   the halves land in shared memory and every thread adds them in a fixed
//   order, forms p and ds for two pairs, and writes them split into TF32 hi
//   + lo over the halves' space.
// - dq += ds K (dq pass) and dc_kv | dk_rope += ds^T qs + p^T do (dkv
//   pass): the warps split the 576 output columns in n8 tiles (warp w takes
//   tiles w + 8j: at full width 9, the dkv pass's 8 of c_kv and 1 of
//   k_rope), each a 32-row (dq: rows; dkv: keys) by 8-column fp32
//   accumulator in registers (72 registers a lane). A tile's products go
//   into zeroed fragments, then into the running sum with a rounded FADD:
//   the MMA's accumulation truncates, and a dkv sum runs over up to Sq * H
//   rows (32,768 at B 1 x S 256 x H 128).
// - The reduction index of ds K and ds^T qs is renamed (t -> key or row
//   2t, t + 4 -> 2t + 1), so that A fragments load as 64-bit pairs and B
//   fragments without bank conflicts (rows padded to Dk + 4 words, or Dk +
//   8 bf16 elements).
// - Operands: fp32 values split into TF32 hi + lo (three MMAs per step,
//   lo * lo dropped); a bf16 latent or do value is exact in TF32 (no
//   split): S two MMAs (q split), dP one, ds K two, p^T do two, ds^T qs
//   three. At bf16 a block checks whether the q it staged is exact in TF32
//   (a bf16 q, prescaled, is), and then leaves out q's lo products (zero):
//   S one MMA, ds^T qs two, the same sums bitwise.
// - The scale: s = scale * (q . K) and the dkv pass adds (scale ds)^T q, so
//   q is staged as it is, by cp.async; dq is dscale * (ds K).
// - dkv row chunks: the wrapper splits each batch element's row tiles into
//   nc chunks (`mla_dkv_chunks`); the block of a chunk whose rows cannot
//   touch its keys exits at once, the others write fp32 partial sums (nc,
//   B, Sk, Dk), and `mla_bwd_dkv_reduce` adds the live chunks in chunk
//   order and writes dc_kv and dk_rope: no atomics, so a repeat is bitwise
//   the same. dq blocks start from the last rows, whose causal key range is
//   longest.
// - Masks and skips: a dq block stops after the last key some row of it can
//   see (kv_len, the causal diagonal), taken only when every row sees key
//   0; keys past Sk and rows past Sq * H are zero-filled and give p = ds =
//   0. Operands off 16-byte alignment are staged by plain loads.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing (the wrapper allocates the outputs and the
// dkv partials), raise the kernels' dynamic shared-memory limit once per
// device, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDqRows = 32;  // rows a dq block owns
constexpr int kDqKeys = 16;  // keys of a dq ring tile
constexpr int kKvKeys = 32;  // keys a dkv block owns
constexpr int kKvRows = 16;  // rows of a dkv ring tile

struct BwdParams {
  int h, sq, sk, rows;           // rows = sq * h per batch element
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale, dscale;
  int nc, tiles_per_chunk;  // dkv: row chunks, 16-row tiles per chunk
  int vec;                  // q, c_kv, k_rope, do 16-byte aligned: cp.async
};

// k8 steps (or n8 tiles) handled at once: their MMA chains interleave
__host__ __device__ constexpr int unroll_of(int n) {
  return n % 4 == 0 ? 4 : n % 3 == 0 ? 3 : n % 2 == 0 ? 2 : 1;
}

template <typename KT, int R, int DR>
struct Geom {
  static constexpr bool kBf16 = !std::is_same<KT, float>::value;
  static constexpr int DK = R + DR;
  static constexpr int QP = DK + 4;                   // floats per shared q row
  static constexpr int KP = kBf16 ? DK + 8 : DK + 4;  // elements per shared key row
  static constexpr int OP = kBf16 ? R + 8 : R + 4;    // elements per shared do row
  static constexpr int NT = DK / 8;                   // n8 tiles of dq, dc_kv | dk_rope
  static constexpr int NCV = R / 8;                   // of them c_kv's
  static constexpr int NJ = (NT + kWarps - 1) / kWarps;  // n8 tiles a warp owns
  static constexpr int JU = unroll_of(NJ) > 3 ? 3 : unroll_of(NJ);
  static constexpr int KS_S = DK / 16;  // k8 steps of S in half the columns
  static constexpr int KS_P = R / 16;   // k8 steps of dP in half the columns
  static constexpr int kQRow = QP * 4, kKRow = KP * (int)sizeof(KT), kORow = OP * (int)sizeof(KT);
  static_assert(R % 16 == 0 && DR % 16 == 0, "rows split into k8 halves and 16-byte copies");
  static_assert(NT % kWarps == 0 || NJ == 1, "a warp's n8 tiles all exist, or it has one");
};

// dq block: q [32][QP] | do [32][OP] | 2 key tiles [16][KP] | halves of S
// and dP [2][2][32][PS], then ds hi, lo [2][32][PS] in their place | m, l,
// delta [3][32]
template <typename KT, int R, int DR>
struct DqSmem {
  using G = Geom<KT, R, DR>;
  static constexpr int PS = kDqKeys + 8;  // words per row of a pair tile
  static constexpr int kQ = kDqRows * G::kQRow;
  static constexpr int kDo = kDqRows * G::kORow;
  static constexpr int kTile = kDqKeys * G::kKRow;
  static constexpr int kPart = 4 * kDqRows * PS * 4;
  static constexpr int kBytes = kQ + kDo + 2 * kTile + kPart + 3 * kDqRows * 4;
  static_assert(kBytes <= 232448, "past the 227 KB a block may use");
};

// dkv block: keys [32][KP] | 2 ring stages {q [16][QP], do [16][OP], m, l,
// delta [3][16]} | halves of S and dP [2][2][16][PS], then ds and p hi,
// lo transposed [4][32][TS] in their place
template <typename KT, int R, int DR>
struct KvSmem {
  using G = Geom<KT, R, DR>;
  static constexpr int PS = kKvKeys + 8;  // words per row of a partial tile
  static constexpr int TS = kKvRows + 8;  // words per key row of a transposed tile
  static constexpr int kKeys = kKvKeys * G::kKRow;
  static constexpr int kStage = kKvRows * (G::kQRow + G::kORow) + 3 * kKvRows * 4;
  static constexpr int kPart = (4 * kKvRows * PS > 4 * kKvKeys * TS ? 4 * kKvRows * PS
                                                                     : 4 * kKvKeys * TS) * 4;
  static constexpr int kBytes = kKeys + 2 * kStage + kPart;
  static_assert(kBytes <= 232448, "past the 227 KB a block may use");
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// An operand value as the MMA's TF32 parts: hi + lo (split-TF32) for fp32
// data, the value alone for bf16 data (exact in TF32; lo 0 and unused).
template <bool kExact>
__device__ __forceinline__ void parts(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split(x, hi, lo);
  }
}

// Two adjacent output values of a row: fp32, or rounded to bf16 (to
// nearest, ties to even) and packed.
__device__ __forceinline__ void store2(float* dst, float x0, float x1) {
  *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(uint16_t* dst, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(dst) = bf16mma::pack_bf16(x0, x1);
}
__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(uint16_t* dst, float x) {  // to nearest, ties to even
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  *dst = (uint16_t)(u >> 16);
}

// The key range [0, kend) rows at positions [s_first, s_last] must visit:
// the forward's exact skip, taken only when every row sees key 0.
__device__ __forceinline__ int visit_end(const BwdParams& p, int s_first, int s_last) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  int kend = p.sk;
  if (kv_lim > 0 && (!p.causal || p.q_offset + s_first >= 0)) {
    kend = kv_lim;
    if (p.causal) kend = min(kend, p.q_offset + s_last + 1);
  }
  return kend;
}

// True when no row at positions [s_first, s_last] can take any gradient
// from the keys from k0 on: every row sees some key (so p is 0 exactly on
// the masked ones) and none sees key k0 (so none sees a later one).
__device__ __forceinline__ bool rows_blind(const BwdParams& p, int s_first, int s_last, int k0) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  if (kv_lim == 0 || (p.causal && p.q_offset + s_first < 0)) return false;
  return k0 >= kv_lim || (p.causal && k0 > p.q_offset + s_last);
}

// The dkv pass's 16-row tile `tile` against the keys from k0.
__device__ __forceinline__ bool tile_blind(const BwdParams& p, int tile, int k0) {
  const int r0 = tile * kKvRows;
  return rows_blind(p, r0 / p.h, (min(r0 + kKvRows, p.rows) - 1) / p.h, k0);
}

// Every tile of row chunk `chunk` blind to the keys from k0 (rows_blind is
// monotone in s_first and in s_last, so the chunk's first and last rows
// decide); an empty chunk is blind.
__device__ __forceinline__ bool chunk_blind(const BwdParams& p, int chunk, int k0) {
  const int n_tiles = (p.rows + kKvRows - 1) / kKvRows;
  const int tb = chunk * p.tiles_per_chunk, te = min(tb + p.tiles_per_chunk, n_tiles);
  if (tb >= te) return true;
  return rows_blind(p, tb * kKvRows / p.h, (min(te * kKvRows, p.rows) - 1) / p.h, k0);
}

// `n` rows of W elements from `src` (rows of W, from row0; `valid` of them
// real, the rest zero-filled) into rows of DP elements at `dst`.
template <typename T, int W, int DP>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long row0,
                                           int n, int valid, bool vec) {
  constexpr int E = 16 / (int)sizeof(T), C = W / E;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const bool ok = r < valid;
    const T* s = src + (row0 + (ok ? r : 0)) * W + c * E;
    T* d = dst + r * DP + c * E;
    if (vec) {
      cp_async16(smem_addr(d), s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = ok ? s[e] : T(0);
    }
  }
}

// Keys key0 .. key0 + NK - 1 of batch element b as rows [c_kv ; k_rope]
// (zero past Sk).
template <typename KT, int R, int DR, int NK>
__device__ __forceinline__ void stage_keys(KT* dst, const KT* __restrict__ ckv,
                                           const KT* __restrict__ krope, int b, int key0,
                                           const BwdParams& p) {
  using G = Geom<KT, R, DR>;
  constexpr int E = 16 / (int)sizeof(KT), CR = R / E, C = CR + DR / E;
  for (int i = threadIdx.x; i < NK * C; i += kThreads) {
    const int k = i / C, c = i - k * C, key = key0 + k;
    const bool ok = key < p.sk;
    const long long kb = (long long)b * p.sk + (ok ? key : 0);
    const KT* s = c < CR ? ckv + kb * R + c * E : krope + kb * DR + (c - CR) * E;
    KT* d = dst + k * G::KP + c * E;
    if (p.vec) {
      cp_async16(smem_addr(d), s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = ok ? s[e] : KT(0);
    }
  }
}

// m, l, delta of rows r0 .. r0 + n - 1 as [3][n] (`valid` real, the rest 0).
__device__ __forceinline__ void stage_stats(float* st, int n, const float* __restrict__ m,
                                            const float* __restrict__ l,
                                            const float* __restrict__ delta, long long row0,
                                            int valid) {
  for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
    const int w = i / n, r = i - w * n;
    const bool ok = r < valid;
    const float* src = (w == 0 ? m : w == 1 ? l : delta) + row0 + (ok ? r : 0);
    cp_async4(smem_addr(st + i), src, ok);
  }
}

// Nonzero if a value of q this thread staged (`n` rows at `sq`, chunk by
// chunk as stage_rows copies them, its own copies visible to it once it has
// waited for them) is not exact in TF32: then q needs its lo part.
template <int DK, int QP>
__device__ __forceinline__ int staged_inexact(const float* sq, int n) {
  constexpr int C = DK / 4;
  uint32_t bits = 0u;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const uint4 v = *reinterpret_cast<const uint4*>(sq + r * QP + 4 * c);
    bits |= v.x | v.y | v.z | v.w;
  }
  return (bits & 0x1fffu) != 0u;
}

// One warp's half of a 16-row x 16-key block of S or dP: out[n][.] (key n8
// tile n, C fragment layout) = the sum over k8 steps ks0 .. ks0 + NKS - 1
// of A (rows at `a`, AP elements apart) times the keys (at `kt`, KP
// apart). SU steps at a time, each chain in its own zeroed fragment, the
// chains added in order at the end. kSplitA false: A (fp32) is exact in
// TF32, its lo part 0 and its MMAs left out (the sum is the same, bitwise).
// fp32 operands load by ldmatrix (8 rows x 4 fp32 are an 8 x 8 b16 matrix,
// and a lane receives word t of row g: a fragment's element): one x4 gives
// A's fragment, one both key tiles'; bf16 operands load element by element.
template <int NKS, int AP, int KP, bool kSplitA, typename TA, typename TB>
__device__ __forceinline__ void block_products(float (&out)[2][4], const TA* __restrict__ a,
                                               const TB* __restrict__ kt, int ks0) {
  constexpr bool AF = std::is_same<TA, float>::value, BF = std::is_same<TB, float>::value;
  constexpr bool AX = !AF || !kSplitA, BX = !BF;
  constexpr int SU = unroll_of(NKS);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // the ldmatrix row this lane addresses
  const TA* ar = a + g * AP + 8 * ks0 + t;
  const TB* br = kt + g * KP + 8 * ks0 + t;
  // A's matrices: rows 0-7 | 8-15 (mat & 1) x columns 0-3 | 4-7 (mat >> 1);
  // the keys': keys 0-7 | 8-15 (mat >> 1) x columns 0-3 | 4-7 (mat & 1)
  const uint32_t am = smem_addr(a + (mrow + 8 * (mat & 1)) * AP + 8 * ks0 + 4 * (mat >> 1));
  const uint32_t bm = smem_addr(kt + (mrow + 8 * (mat >> 1)) * KP + 8 * ks0 + 4 * (mat & 1));
  float c[SU][2][4];
#pragma unroll
  for (int u = 0; u < SU; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[u][n][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < NKS; k0 += SU) {
    uint32_t ah[SU][4], al[SU][4], bh[SU][2][2], bl[SU][2][2];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int o = 8 * (k0 + u);
      if constexpr (AF) {
        uint32_t r[4];
        ldmatrix_x4(r, am + 4 * o);
#pragma unroll
        for (int i = 0; i < 4; ++i) parts<AX>(__uint_as_float(r[i]), ah[u][i], al[u][i]);
      } else {
        parts<AX>(widen(ar[o]), ah[u][0], al[u][0]);
        parts<AX>(widen(ar[o + 8 * AP]), ah[u][1], al[u][1]);
        parts<AX>(widen(ar[o + 4]), ah[u][2], al[u][2]);
        parts<AX>(widen(ar[o + 8 * AP + 4]), ah[u][3], al[u][3]);
      }
      if constexpr (BF) {
        uint32_t r[4];
        ldmatrix_x4(r, bm + 4 * o);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          parts<BX>(__uint_as_float(r[2 * n]), bh[u][n][0], bl[u][n][0]);
          parts<BX>(__uint_as_float(r[2 * n + 1]), bh[u][n][1], bl[u][n][1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          parts<BX>(widen(br[8 * n * KP + o]), bh[u][n][0], bl[u][n][0]);
          parts<BX>(widen(br[8 * n * KP + o + 4]), bh[u][n][1], bl[u][n][1]);
        }
      }
    }
    // tf32_mma.cuh's mma_split order per chain: lo * hi, hi * lo, hi * hi
    if constexpr (!AX) {
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(c[u][n], al[u], bh[u][n][0], bh[u][n][1]);
    }
    if constexpr (!BX) {
#pragma unroll
      for (int u = 0; u < SU; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_tf32(c[u][n], ah[u], bl[u][n][0], bl[u][n][1]);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n) mma_tf32(c[u][n], ah[u], bh[u][n][0], bh[u][n][1]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = c[0][n][e];
#pragma unroll
      for (int u = 1; u < SU; ++u) s += c[u][n][e];
      out[n][e] = s;
    }
}

// A warp's S (warps 0-3) or dP (warps 4-7) half-block into its partial
// tile [half][role][rows][PS]: rows row0 + (0..15) of A over keys key0 +
// (0..15), the half `kh` of the contraction; `q_split` false: the staged q
// is exact in TF32 (at bf16, a q already rounded to bf16).
template <typename KT, int R, int DR, int PS, int NROWS>
__device__ __forceinline__ void phase_one(float* part, const float* sq, const KT* sdo,
                                          const KT* keys, int row0, int key0, int kh,
                                          bool q_split) {
  using G = Geom<KT, R, DR>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int role = warp >> 2;
  float c[2][4];
  const float* qa = sq + row0 * G::QP;
  const KT* kb = keys + key0 * G::KP;
  if (role == 1)
    block_products<G::KS_P, G::OP, G::KP, true>(c, sdo + row0 * G::OP, kb, kh * G::KS_P);
  else if (G::kBf16 && !q_split)
    block_products<G::KS_S, G::QP, G::KP, false>(c, qa, kb, kh * G::KS_S);
  else
    block_products<G::KS_S, G::QP, G::KP, true>(c, qa, kb, kh * G::KS_S);
  float* dst = part + ((kh * 2 + role) * NROWS + row0) * PS + key0 + 2 * t;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(dst + (g + 8 * hf) * PS + 8 * n) =
          make_float2(c[n][2 * hf], c[n][2 * hf + 1]);
}

// p and ds of the pairs (row, key0 + e), e = 0, 1, from the two halves of
// s and dp (s unscaled) and the row's m, l, delta.
__device__ __forceinline__ void pair_grads(const BwdParams& p, int row, int key0, float2 sa,
                                           float2 sb, float2 da, float2 db, float mr, float lr,
                                           float dr, float (&pv)[2], float (&dsv)[2]) {
  const bool row_ok = row < p.rows;
  const int qpos = p.q_offset + row / p.h;
  const float s[2] = {(sa.x + sb.x) * p.scale, (sa.y + sb.y) * p.scale};
  const float dp[2] = {da.x + db.x, da.y + db.y};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = key0 + e;
    const bool valid = row_ok && key < p.sk;
    const bool masked = (p.causal && qpos < key) || (p.kv_len >= 0 && key >= p.kv_len);
    const float x = expf((masked ? kNeg : s[e]) - mr) / fmaxf(lr, 1e-30f);
    pv[e] = valid ? x : 0.f;
    dsv[e] = valid && !masked ? x * (dp[e] - dr) : 0.f;
  }
}

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads, 1)
mla_bwd_dq_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                  const KT* __restrict__ krope, const KT* __restrict__ dout,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ delta, KT* __restrict__ dq, BwdParams p) {
  using G = Geom<KT, R, DR>;
  using S = DqSmem<KT, R, DR>;
  constexpr int PS = S::PS, KP = G::KP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const sq = reinterpret_cast<float*>(smem);                    // [32][QP]
  KT* const sdo = reinterpret_cast<KT*>(smem + S::kQ);                 // [32][OP]
  KT* const ring = reinterpret_cast<KT*>(smem + S::kQ + S::kDo);       // 2 x [16][KP]
  float* const part = reinterpret_cast<float*>(smem + S::kQ + S::kDo + 2 * S::kTile);
  float* const st = part + S::kPart / 4;                               // [3][32]
  uint32_t* const dsh = reinterpret_cast<uint32_t*>(part);             // [32][PS]
  uint32_t* const dsl = dsh + kDqRows * PS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // the longest key ranges first
  const int valid = min(kDqRows, p.rows - r0);
  const long long rb = (long long)b * p.rows;
  const int kend = visit_end(p, r0 / p.h, (r0 + valid - 1) / p.h);
  const int n_tiles = (kend + kDqKeys - 1) / kDqKeys;  // >= 1: kend >= 1

  stage_rows<float, G::DK, G::QP>(sq, q, rb + r0, kDqRows, valid, p.vec);
  stage_rows<KT, R, G::OP>(sdo, dout, rb + r0, kDqRows, valid, p.vec);
  stage_stats(st, kDqRows, m, l, delta, rb + r0, valid);
  stage_keys<KT, R, DR, kDqKeys>(ring, ckv, krope, b, 0, p);
  cp_async_commit();
  bool q_split = true;

  float acc[2][G::NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    // tile `it` (at it = 0 the rows too) landed for every thread, and every warp is
    // done with tile it - 1: its slot and ds are free; at it = 0, at bf16, whether
    // any staged q value needs its lo part
    if (G::kBf16 && it == 0)
      q_split = __syncthreads_or(staged_inexact<G::DK, G::QP>(sq, kDqRows));
    else
      __syncthreads();
    const KT* const kt = ring + (it & 1) * kDqKeys * KP;
    const int key0 = it * kDqKeys;
    if (it + 1 < n_tiles)
      stage_keys<KT, R, DR, kDqKeys>(ring + ((it + 1) & 1) * kDqKeys * KP, ckv, krope, b,
                                     key0 + kDqKeys, p);
    cp_async_commit();

    // S and dP: warp (role, mi, kh) takes rows 16 mi .. + 15, half kh
    phase_one<KT, R, DR, PS, kDqRows>(part, sq, sdo, kt, 16 * (warp & 1), 0, (warp >> 1) & 1,
                                      q_split);
    __syncthreads();

    // ds of rows er, keys kk, kk + 1, split over the halves' space
    {
      const int er = tid >> 3, kk = 2 * (tid & 7);
      const float* pr = part + er * PS + kk;
      constexpr int SL = kDqRows * PS;  // one [half][role] slot
      const float2 sa = *reinterpret_cast<const float2*>(pr);
      const float2 da = *reinterpret_cast<const float2*>(pr + SL);
      const float2 sb = *reinterpret_cast<const float2*>(pr + 2 * SL);
      const float2 db = *reinterpret_cast<const float2*>(pr + 3 * SL);
      __syncthreads();  // every half read: ds takes their place
      float pv[2], dsv[2];
      pair_grads(p, r0 + er, key0 + kk, sa, sb, da, db, st[er], st[kDqRows + er],
                 st[2 * kDqRows + er], pv, dsv);
      uint32_t h0, l0, h1, l1;
      split(dsv[0], h0, l0);
      split(dsv[1], h1, l1);
      *reinterpret_cast<uint2*>(dsh + er * PS + kk) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(dsl + er * PS + kk) = make_uint2(l0, l1);
    }
    __syncthreads();

    // dq += ds K over this warp's n8 tiles: A = ds (rows x keys, key 2t and
    // 2t + 1 as reduction indices t and t + 4), B = the keys' columns
    uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int o = (16 * mi + g) * PS + 8 * ks + 2 * t;
        const uint2 xh = *reinterpret_cast<const uint2*>(dsh + o);
        const uint2 yh = *reinterpret_cast<const uint2*>(dsh + o + 8 * PS);
        const uint2 xl = *reinterpret_cast<const uint2*>(dsl + o);
        const uint2 yl = *reinterpret_cast<const uint2*>(dsl + o + 8 * PS);
        ah[mi][ks][0] = xh.x; ah[mi][ks][1] = yh.x; ah[mi][ks][2] = xh.y; ah[mi][ks][3] = yh.y;
        al[mi][ks][0] = xl.x; al[mi][ks][1] = yl.x; al[mi][ks][2] = xl.y; al[mi][ks][3] = yl.y;
      }
    constexpr int JU = G::JU;
    constexpr bool BX = G::kBf16;
#pragma unroll
    for (int j0 = 0; j0 < G::NJ; j0 += JU) {
      if (warp + 8 * j0 >= G::NT) break;  // reduced width: warps past the tiles
      float c[JU][2][4];
      uint32_t bh[JU][2][2], bl[JU][2][2];
#pragma unroll
      for (int u = 0; u < JU; ++u) {
        const KT* kb = kt + 2 * t * KP + 8 * (warp + 8 * (j0 + u)) + g;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          parts<BX>(widen(kb[8 * ks * KP]), bh[u][ks][0], bl[u][ks][0]);
          parts<BX>(widen(kb[8 * ks * KP + KP]), bh[u][ks][1], bl[u][ks][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[u][mi][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int u = 0; u < JU; ++u)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_tf32(c[u][mi], al[mi][ks], bh[u][ks][0], bh[u][ks][1]);
        if constexpr (!BX) {
#pragma unroll
          for (int u = 0; u < JU; ++u)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              mma_tf32(c[u][mi], ah[mi][ks], bl[u][ks][0], bl[u][ks][1]);
        }
#pragma unroll
        for (int u = 0; u < JU; ++u)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_tf32(c[u][mi], ah[mi][ks], bh[u][ks][0], bh[u][ks][1]);
      }
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j0 + u][e] += c[u][mi][e];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const int n = warp + 8 * j;
    if (n >= G::NT) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mi + g + 8 * hf;
        if (r < valid)
          store2(dq + (rb + r0 + r) * G::DK + 8 * n + 2 * t, acc[mi][j][2 * hf] * p.dscale,
                 acc[mi][j][2 * hf + 1] * p.dscale);
      }
  }
}

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads, 1)
mla_bwd_dkv_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                   const KT* __restrict__ krope, const KT* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ delta, float* __restrict__ part_out, BwdParams p) {
  using G = Geom<KT, R, DR>;
  using S = KvSmem<KT, R, DR>;
  constexpr int PS = S::PS, TS = S::TS;
  extern __shared__ __align__(16) unsigned char smem[];
  KT* const keys = reinterpret_cast<KT*>(smem);  // [32][KP]
  unsigned char* const ring = smem + S::kKeys;   // 2 stages
  float* const part = reinterpret_cast<float*>(smem + S::kKeys + 2 * S::kStage);
  uint32_t* const tr = reinterpret_cast<uint32_t*>(part);  // ds hi, ds lo, p hi, p lo
  constexpr int TA = kKvKeys * TS;                         // [32][TS] each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kKvKeys, b = blockIdx.y, chunk = blockIdx.z;
  if (chunk_blind(p, chunk, k0)) return;  // the reduce skips this chunk
  const long long rb = (long long)b * p.rows;
  const int n_tiles = (p.rows + kKvRows - 1) / kKvRows;
  const int t_end = min((chunk + 1) * p.tiles_per_chunk, n_tiles);
  auto next_tile = [&](int tile) {
    while (tile < t_end && tile_blind(p, tile, k0)) ++tile;
    return tile;
  };
  auto stage = [&](int slot, int tile) {
    unsigned char* base = ring + slot * S::kStage;
    const int r0 = tile * kKvRows, valid = min(kKvRows, p.rows - r0);
    stage_rows<float, G::DK, G::QP>(reinterpret_cast<float*>(base), q, rb + r0, kKvRows, valid,
                                    p.vec);
    stage_rows<KT, R, G::OP>(reinterpret_cast<KT*>(base + kKvRows * G::kQRow), dout, rb + r0,
                             kKvRows, valid, p.vec);
    stage_stats(reinterpret_cast<float*>(base + kKvRows * (G::kQRow + G::kORow)), kKvRows, m,
                l, delta, rb + r0, valid);
  };

  int cur = next_tile(chunk * p.tiles_per_chunk);  // < t_end: the chunk is not blind
  stage_keys<KT, R, DR, kKvKeys>(keys, ckv, krope, b, k0, p);
  stage(0, cur);
  cp_async_commit();

  float acc[2][G::NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  for (int slot = 0; cur < t_end; slot ^= 1) {
    cp_async_wait<0>();
    const unsigned char* base = ring + slot * S::kStage;
    const float* const sq = reinterpret_cast<const float*>(base);
    // tile `cur` (first: the keys too) landed for every thread, and every warp is done
    // with the previous tile: its slot and the pair tiles are free; at bf16, whether
    // any of the tile's q values needs its lo part
    bool q_split = true;
    if (G::kBf16)
      q_split = __syncthreads_or(staged_inexact<G::DK, G::QP>(sq, kKvRows));
    else
      __syncthreads();
    const int nxt = next_tile(cur + 1);
    if (nxt < t_end) stage(slot ^ 1, nxt);
    cp_async_commit();
    const KT* const sdo = reinterpret_cast<const KT*>(base + kKvRows * G::kQRow);
    const float* const st = reinterpret_cast<const float*>(base + kKvRows * (G::kQRow + G::kORow));
    const int r0 = cur * kKvRows;

    // S and dP: warp (role, ng, kh) takes keys 16 ng .. + 15, half kh
    phase_one<KT, R, DR, PS, kKvRows>(part, sq, sdo, keys, 0, 16 * (warp & 1), (warp >> 1) & 1,
                                      q_split);
    __syncthreads();

    // p and (scale ds) of row er, keys kk, kk + 1, split and transposed
    // (key-major) over the halves' space
    {
      const int er = tid & 15, kk = 2 * (tid >> 4);
      const float* pr = part + er * PS + kk;
      constexpr int SL = kKvRows * PS;
      const float2 sa = *reinterpret_cast<const float2*>(pr);
      const float2 da = *reinterpret_cast<const float2*>(pr + SL);
      const float2 sb = *reinterpret_cast<const float2*>(pr + 2 * SL);
      const float2 db = *reinterpret_cast<const float2*>(pr + 3 * SL);
      __syncthreads();  // every half read: the split tiles take their place
      float pv[2], dsv[2];
      pair_grads(p, r0 + er, k0 + kk, sa, sb, da, db, st[er], st[kKvRows + er],
                 st[2 * kKvRows + er], pv, dsv);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = (kk + e) * TS + er;
        split(dsv[e] * p.scale, tr[o], tr[TA + o]);
        split(pv[e], tr[2 * TA + o], tr[3 * TA + o]);
      }
    }
    __syncthreads();

    // dc_kv | dk_rope += (scale ds)^T q (+ p^T do for c_kv's tiles) over
    // this warp's n8 tiles: A = the transposed tiles (keys x rows, row 2t
    // and 2t + 1 as reduction indices t and t + 4), B = q's and do's columns
    constexpr int JU = G::JU;
    constexpr bool BX = G::kBf16;
#pragma unroll
    for (int j0 = 0; j0 < G::NJ; j0 += JU) {
      if (warp + 8 * j0 >= G::NT) break;  // reduced width: warps past the tiles
      float c[JU][2][4];
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[u][mi][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4][2][4];  // ds hi, ds lo, p hi, p lo x mi
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int o = w * TA + (16 * mi + g) * TS + 8 * ks + 2 * t;
            const uint2 x = *reinterpret_cast<const uint2*>(tr + o);
            const uint2 y = *reinterpret_cast<const uint2*>(tr + o + 8 * TS);
            a[w][mi][0] = x.x; a[w][mi][1] = y.x; a[w][mi][2] = x.y; a[w][mi][3] = y.y;
          }
        uint32_t qh[JU][2], ql[JU][2], oh[JU][2], ol[JU][2];
        bool cv[JU];
#pragma unroll
        for (int u = 0; u < JU; ++u) {
          const int n = warp + 8 * (j0 + u);
          cv[u] = n < G::NCV;
          const int row = 8 * ks + 2 * t;
          const float* qb = sq + row * G::QP + 8 * n + g;
          split(qb[0], qh[u][0], ql[u][0]);
          split(qb[G::QP], qh[u][1], ql[u][1]);
          const KT* ob = sdo + row * G::OP + 8 * (cv[u] ? n : 0) + g;
          parts<BX>(widen(ob[0]), oh[u][0], ol[u][0]);
          parts<BX>(widen(ob[G::OP]), oh[u][1], ol[u][1]);
        }
        // the small terms first, then hi * hi
#pragma unroll
        for (int u = 0; u < JU; ++u)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(c[u][mi], a[1][mi], qh[u][0], qh[u][1]);
            if (!G::kBf16 || q_split) mma_tf32(c[u][mi], a[0][mi], ql[u][0], ql[u][1]);
            if (cv[u]) {
              mma_tf32(c[u][mi], a[3][mi], oh[u][0], oh[u][1]);
              if constexpr (!BX) mma_tf32(c[u][mi], a[2][mi], ol[u][0], ol[u][1]);
            }
          }
#pragma unroll
        for (int u = 0; u < JU; ++u)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(c[u][mi], a[0][mi], qh[u][0], qh[u][1]);
            if (cv[u]) mma_tf32(c[u][mi], a[2][mi], oh[u][0], oh[u][1]);
          }
      }
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j0 + u][e] += c[u][mi][e];
    }
    cur = nxt;
  }
  cp_async_wait<0>();

  const long long base = ((long long)chunk * gridDim.y + b) * p.sk;
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const int n = warp + 8 * j;
    if (n >= G::NT) break;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = k0 + 16 * mi + g + 8 * hf;
        if (key < p.sk)
          *reinterpret_cast<float2*>(part_out + (base + key) * G::DK + 8 * n + 2 * t) =
              make_float2(acc[mi][j][2 * hf], acc[mi][j][2 * hf + 1]);
      }
  }
}

// dc_kv and dk_rope: the live chunks' partial sums added in chunk order.
// Block (x, y) takes elements 256 y .. of key block x % n_kb (32 keys x Dk)
// of batch element x / n_kb; which chunks are live for the key block is
// decided once a block, 256 chunks at a time.
template <typename KT, int R, int DR>
__global__ void __launch_bounds__(256)
mla_bwd_dkv_reduce(const float* __restrict__ part, KT* __restrict__ dckv,
                   KT* __restrict__ dkrope, BwdParams p, int nb) {
  constexpr int DK = R + DR;
  __shared__ int live[256];
  const int n_kb = gridDim.x / nb, b = blockIdx.x / n_kb, k0 = (blockIdx.x % n_kb) * kKvKeys;
  const int e = blockIdx.y * 256 + threadIdx.x;
  const int key = k0 + e / DK, d = e % DK;
  const bool ok = e < kKvKeys * DK && key < p.sk;
  const long long stride = (long long)nb * p.sk * DK;  // one chunk's partials
  const float* src = part + ((long long)b * p.sk + key) * DK + d;
  float s = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += 256) {
    __syncthreads();  // the previous window's flags are read
    live[threadIdx.x] = c0 + (int)threadIdx.x < p.nc && !chunk_blind(p, c0 + threadIdx.x, k0);
    __syncthreads();
    const int n = min(256, p.nc - c0);
    if (ok)
      for (int j = 0; j < n; ++j)
        if (live[j]) s += src[(c0 + j) * stride];
  }
  if (!ok) return;
  const long long bk = (long long)b * p.sk + key;
  if (d < R)
    put(dckv + bk * R + d, s);
  else
    put(dkrope + bk * DR + d - R, s);
}

template <typename KT, int R, int DR>
int launch_dq(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
              const float* l, const float* delta, KT* dq, const BwdParams& p, int nb,
              cudaStream_t stream) {
  using S = DqSmem<KT, R, DR>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)mla_bwd_dq_kernel<KT, R, DR>, S::kBytes,
                                   allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.rows + kDqRows - 1) / kDqRows), nb);
  mla_bwd_dq_kernel<KT, R, DR><<<grid, kThreads, S::kBytes, stream>>>(q, ckv, krope, dout, m,
                                                                     l, delta, dq, p);
  return (int)cudaGetLastError();
}

template <typename KT, int R, int DR>
int launch_dkv(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
               const float* l, const float* delta, float* part, KT* dckv, KT* dkrope,
               const BwdParams& p, int nb, cudaStream_t stream) {
  using S = KvSmem<KT, R, DR>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)mla_bwd_dkv_kernel<KT, R, DR>, S::kBytes,
                                   allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.sk + kKvKeys - 1) / kKvKeys), nb, p.nc);
  mla_bwd_dkv_kernel<KT, R, DR><<<grid, kThreads, S::kBytes, stream>>>(q, ckv, krope, dout, m,
                                                                      l, delta, part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_kb = (p.sk + kKvKeys - 1) / kKvKeys;
  dim3 rgrid((unsigned)(nb * n_kb), (unsigned)((kKvKeys * (R + DR) + 255) / 256));
  mla_bwd_dkv_reduce<KT, R, DR><<<rgrid, 256, 0, stream>>>(part, dckv, dkrope, p, nb);
  return (int)cudaGetLastError();
}

// dims: b, h, sq, sk, r, dr, causal, q_offset, kv_len (< 0: none), nc
bool parse(const int* dims, float scale, float dscale, BwdParams& p, int& nb, int& r,
           int& dr) {
  nb = dims[0];
  r = dims[4];
  dr = dims[5];
  p.h = dims[1];
  p.sq = dims[2];
  p.sk = dims[3];
  p.causal = dims[6];
  p.q_offset = dims[7];
  p.kv_len = dims[8];
  p.nc = dims[9];
  p.scale = scale;
  p.dscale = dscale;
  if (nb < 1 || nb > 65535 || p.h < 1 || p.sq < 1 || p.sk < 1 || p.nc < 1 || p.nc > 65535 ||
      (long long)p.sq * p.h > 0x7fffffffLL - kDqRows ||
      (long long)nb * ((p.sk + kKvKeys - 1) / kKvKeys) > 0x7fffffffLL)
    return false;
  p.rows = p.sq * p.h;
  const int n_tiles = (p.rows + kKvRows - 1) / kKvRows;
  p.tiles_per_chunk = (n_tiles + p.nc - 1) / p.nc;
  return true;
}

// cp.async needs every operand's rows on 16-byte boundaries: each row is a
// multiple of 16 bytes, so the base pointers decide.
bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 16 == 0;
}

template <typename KT>
int run_dq(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
           const float* l, const float* delta, KT* dq, const int* dims, float scale,
           float dscale, void* stream) {
  BwdParams p;
  int nb, r, dr;
  if (!parse(dims, scale, dscale, p, nb, r, dr)) return (int)cudaErrorInvalidValue;
  p.vec = aligned16(q, ckv, krope, dout);
  const cudaStream_t s = (cudaStream_t)stream;
  if (r == 32 && dr == 16)
    return launch_dq<KT, 32, 16>(q, ckv, krope, dout, m, l, delta, dq, p, nb, s);
  if (r == 512 && dr == 64)
    return launch_dq<KT, 512, 64>(q, ckv, krope, dout, m, l, delta, dq, p, nb, s);
  return (int)cudaErrorInvalidValue;
}

template <typename KT>
int run_dkv(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
            const float* l, const float* delta, float* part, KT* dckv, KT* dkrope,
            const int* dims, float scale, void* stream) {
  BwdParams p;
  int nb, r, dr;
  if (!parse(dims, scale, 1.f, p, nb, r, dr)) return (int)cudaErrorInvalidValue;
  p.vec = aligned16(q, ckv, krope, dout);
  const cudaStream_t s = (cudaStream_t)stream;
  if (r == 32 && dr == 16)
    return launch_dkv<KT, 32, 16>(q, ckv, krope, dout, m, l, delta, part, dckv, dkrope, p, nb,
                                  s);
  if (r == 512 && dr == 64)
    return launch_dkv<KT, 512, 64>(q, ckv, krope, dout, m, l, delta, part, dckv, dkrope, p,
                                   nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dq (B, Sq, H, r + dr) = dscale * sum_k ds K, fp32.
int repro_flash_bwd_mla_dq_f32(const float* q, const float* ckv, const float* krope,
                               const float* dout, const float* m, const float* l,
                               const float* delta, float* dq, const int* dims, float scale,
                               float dscale, void* stream) {
  return run_dq<float>(q, ckv, krope, dout, m, l, delta, dq, dims, scale, dscale, stream);
}

// The same over a bf16 latent and a bf16 do -> bf16 dq.
int repro_flash_bwd_mla_dq_bf16(const float* q, const uint16_t* ckv, const uint16_t* krope,
                                const uint16_t* dout, const float* m, const float* l,
                                const float* delta, uint16_t* dq, const int* dims, float scale,
                                float dscale, void* stream) {
  return run_dq<uint16_t>(q, ckv, krope, dout, m, l, delta, dq, dims, scale, dscale, stream);
}

// dc_kv (B, Sk, r) and dk_rope (B, Sk, dr), fp32; part: (nc, B, Sk, r + dr)
// fp32 scratch.
int repro_flash_bwd_mla_dkv_f32(const float* q, const float* ckv, const float* krope,
                                const float* dout, const float* m, const float* l,
                                const float* delta, float* part, float* dckv, float* dkrope,
                                const int* dims, float scale, void* stream) {
  return run_dkv<float>(q, ckv, krope, dout, m, l, delta, part, dckv, dkrope, dims, scale,
                        stream);
}

// The same over a bf16 latent and a bf16 do -> bf16 dc_kv and dk_rope.
int repro_flash_bwd_mla_dkv_bf16(const float* q, const uint16_t* ckv, const uint16_t* krope,
                                 const uint16_t* dout, const float* m, const float* l,
                                 const float* delta, float* part, uint16_t* dckv,
                                 uint16_t* dkrope, const int* dims, float scale, void* stream) {
  return run_dkv<uint16_t>(q, ckv, krope, dout, m, l, delta, part, dckv, dkrope, dims, scale,
                           stream);
}

}  // extern "C"
