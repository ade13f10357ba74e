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
// What bounds it on this card (3.35 TB/s; 165 TFLOP/s of split-TF32): at the
// served prefill (B4, Sq 32, H 128, causal over 32 keys) q_eff and out are
// 37.7 + 33.5 MB against 0.59 GFLOP: bytes, ~21 us. A decode step (Sq 1,
// <= 64 keys) moves ~2.7 MB: a few us of latency, not bytes or operations.
//
// Design (a first kernel that is right; ROADMAP queue 2 lists its
// redesign):
// - A block owns 16 flattened (position, head) rows, row = s * H + h, one
//   m16 tile: decode (Sq 1, H 128) is 8 tiles per sequence, the served
//   prefill 256. Its 4 warps share one pass over the visible keys in tiles
//   of 32, staged by cp.async into a two-stage ring, the next tile in
//   flight while the current one is used.
// - A key tile is read once for both products: its rows are [c_kv ;
//   k_rope], the keys of Q.K^T, and their first r columns are the values of
//   P.V.
// - S = Q K^T: warp w computes the scores of keys 8w .. 8w + 7 over all r +
//   dr columns (one n8 tile) and writes them, masked, into a shared 16 x 32
//   score tile. Each k8 step's MMAs go into a zeroed fragment that is added
//   to the running sum with a rounded FADD: a chain of 72 steps into one
//   truncating accumulator would drift past the limit of m. Four steps'
//   fragments are in flight at once, their MMAs interleaved, so that a
//   step's dependent MMAs do not wait on each other back to back.
// - The output accumulator is 16 x r fp32, 32 KB at r = 512. The warps
//   split its columns (r / 4 each: 16 n8 tiles, 64 registers a lane); each
//   warp reads the whole score tile, runs the same online softmax (so m and
//   l agree bitwise across warps), rescales its columns and adds P V for
//   them, each n8 tile's four k8 steps into a zeroed fragment first, four
//   n8 tiles in flight at once.
// - P enters P.V from the score tile read in the A fragment's layout, with
//   the reduction indices t and t + 4 of a k8 step renamed to keys 2t and
//   2t + 1, matched by reading V's rows 2t and 2t + 1 for B: with rows
//   padded to Dk + 4 words (fp32) or Dk + 8 elements (bf16) every fragment
//   load is conflict-free.
// - Tensor cores: mma.sync m16n8k8 TF32. fp32 entry: split-TF32 (tf32_mma.cuh)
//   for both products, three MMAs per step. bf16 entry: a bf16 key or value
//   is exact in TF32 (8 significant bits of TF32's 11), so only q is split
//   (two MMAs for S), and p, rounded to bf16 first, is exact too: P.V is one
//   MMA per step.
// - Masks and skips as the GQA forward: a block stops after the last key
//   some row of it can see (kv_len, the causal diagonal), taken only when
//   every row sees key 0; keys past Sk take no part (score -inf, rows
//   zero-filled); rows past Sq * H compute on zeros and write nothing.
//   Operands off 16-byte alignment are staged by plain loads.
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
using bf16mma::round_bf16;

constexpr float kNeg = -1e30f;
constexpr int kRows = 16;   // (position, head) rows per block: one m16 tile
constexpr int kKeys = 32;   // keys per ring tile: one n8 tile of S per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSP = kKeys + 8;  // floats per row of the shared score tile
constexpr int kQLoads = 6;      // float4 loads of Q a thread keeps in flight

struct MlaParams {
  int h, sq, sk;
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale;
  int vec;  // q rows, c_kv and k_rope rows 16-byte aligned
  long long q_sb, q_ss, q_sh;
  long long c_sb, c_ss;
  long long r_sb, r_ss;
  long long o_sb, o_ss, o_sh;
};

// KT: the latent's element type (float, or uint16_t holding bf16 bits).
template <typename KT, int R, int DR>
struct MlaGeom {
  static constexpr bool kBf16 = !std::is_same<KT, float>::value;
  static constexpr int DK = R + DR;                    // key width
  static constexpr int QP = DK + 4;                    // words per shared Q row (hi, lo)
  static constexpr int KP = kBf16 ? DK + 8 : DK + 4;   // elements per shared key row
  static constexpr int KS = DK / 8;                    // k8 steps of S
  static constexpr int NW = R / 32;                    // n8 tiles of out per warp
  static constexpr int E = 16 / (int)sizeof(KT);       // elements per 16-byte copy
  static constexpr int SU = KS % 4 ? 2 : 4;            // k8 steps of S in flight
  static constexpr int NU = NW % 4 ? NW : 4;           // n8 tiles of P.V in flight
  static constexpr int kQVecs = kRows * DK / 4;        // float4s of a block's Q
  static constexpr int kQBytes = 2 * kRows * QP * 4;
  static constexpr int kTileBytes = kKeys * KP * (int)sizeof(KT);
  static constexpr int kSmemBytes = kQBytes + 2 * kTileBytes + kRows * kSP * 4;
  static_assert(R % 32 == 0 && DR % 8 == 0 && KS % SU == 0 && NW % NU == 0,
                "r must split into 4 warps of n8 tiles");
  static_assert(kSmemBytes <= 232448, "past the 227 KB a block may use");
};

// The key range [0, kend) a block of rows at positions [s_first, s_last]
// must visit: the exact skip, taken only when every row sees key 0.
__device__ __forceinline__ int visit_end(const MlaParams& p, int s_first, int s_last) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  int kend = p.sk;
  if (kv_lim > 0 && (!p.causal || p.q_offset + s_first >= 0)) {
    kend = kv_lim;
    if (p.causal) kend = min(kend, p.q_offset + s_last + 1);
  }
  return kend;
}

// A latent element as an fp32 value, exactly (bf16 bits widen exactly).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// Stage keys key0 .. key0 + 31 as rows [c_kv ; k_rope] of a ring tile (rows
// past Sk zero-filled), by all the block's threads.
template <typename KT, int R, int DR>
__device__ __forceinline__ void stage_keys(KT* dst, const KT* __restrict__ ckv,
                                           const KT* __restrict__ krope, long long cb,
                                           long long rb, int key0, const MlaParams& p, int tid) {
  using G = MlaGeom<KT, R, DR>;
  if (p.vec) {
    constexpr int CR = R / G::E, C = CR + DR / G::E;  // 16-byte copies per key row
    for (int i = tid; i < kKeys * C; i += kThreads) {
      const int r = i / C, c = i - r * C, pos = key0 + r;
      const bool ok = pos < p.sk;
      const KT* src = c < CR ? ckv + cb + (long long)pos * p.c_ss + c * G::E
                             : krope + rb + (long long)pos * p.r_ss + (c - CR) * G::E;
      cp_async16(smem_addr(dst + r * G::KP + c * G::E), ok ? src : ckv, ok);
    }
  } else {
    for (int i = tid; i < kKeys * G::DK; i += kThreads) {
      const int r = i / G::DK, d = i - r * G::DK, pos = key0 + r;
      KT x = KT(0);
      if (pos < p.sk)
        x = d < R ? ckv[cb + (long long)pos * p.c_ss + d] : krope[rb + (long long)pos * p.r_ss + d - R];
      dst[r * G::KP + d] = x;
    }
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

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads)
flash_mla_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                 const KT* __restrict__ krope, KT* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, MlaParams p) {
  using G = MlaGeom<KT, R, DR>;
  constexpr int QP = G::QP, KP = G::KP;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* const qhi = reinterpret_cast<uint32_t*>(smem);  // [16][QP]
  uint32_t* const qlo = qhi + kRows * QP;
  KT* const ring = reinterpret_cast<KT*>(smem + G::kQBytes);  // 2 x [32][KP]
  float* const sbuf = reinterpret_cast<float*>(smem + G::kQBytes + 2 * G::kTileBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int rows = p.sq * p.h;
  const int r0 = blockIdx.x * kRows;
  const long long cb = b * p.c_sb, rb = b * p.r_sb;
  const int kend = visit_end(p, r0 / p.h, (min(r0 + kRows, rows) - 1) / p.h);
  const int n_tiles = (kend + kKeys - 1) / kKeys;  // >= 1: kend >= 1

  // the first key tile loads while Q is staged
  stage_keys<KT, R, DR>(ring, ckv, krope, cb, rb, 0, p, tid);
  cp_async_commit();

  // Q, scaled as the plain version scales it, split into hi and lo; each
  // thread keeps kQLoads float4 loads in flight before it splits them
  for (int i0 = 0; i0 < G::kQVecs; i0 += kQLoads * kThreads) {
    float4 x[kQLoads];
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int r = i / (G::DK / 4), d = (i - r * (G::DK / 4)) * 4, row = r0 + r;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < G::kQVecs && row < rows) {
        const int s = row / p.h, hh = row - s * p.h;
        const float* src = q + b * p.q_sb + s * p.q_ss + hh * p.q_sh + d;
        x[u] = p.vec ? *reinterpret_cast<const float4*>(src)
                     : make_float4(src[0], src[1], src[2], src[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kQLoads; ++u) {
      const int i = i0 + u * kThreads + tid;
      if (i >= G::kQVecs) break;
      const int r = i / (G::DK / 4), d = (i - r * (G::DK / 4)) * 4, o4 = r * QP + d;
      split(x[u].x * p.scale, qhi[o4], qlo[o4]);
      split(x[u].y * p.scale, qhi[o4 + 1], qlo[o4 + 1]);
      split(x[u].z * p.scale, qhi[o4 + 2], qlo[o4 + 2]);
      split(x[u].w * p.scale, qhi[o4 + 3], qlo[o4 + 3]);
    }
  }

  int qpos[2];  // rows g and g + 8 of the tile
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) qpos[hf] = p.q_offset + (r0 + g + 8 * hf) / p.h;
  const int n0 = warp * (R / 4);  // this warp's first output column

  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
  float acc[G::NW][4];
#pragma unroll
  for (int n = 0; n < G::NW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const KT* const kt = ring + (it & 1) * kKeys * KP;
    if (it + 1 < n_tiles)
      stage_keys<KT, R, DR>(ring + ((it + 1) & 1) * kKeys * KP, ckv, krope, cb, rb,
                            (it + 1) * kKeys, p, tid);
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` landed (the next one may be in flight)
    __syncthreads();     // ... for every thread; at it = 0 Q too

    // S for this warp's keys 8 * warp .. + 7 over all Dk columns, SU k8
    // steps at a time, their MMA chains interleaved
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const KT* kr = kt + (8 * warp + g) * KP + t;
      constexpr int SU = G::SU;
#pragma unroll 2
      for (int ks0 = 0; ks0 < G::KS; ks0 += SU) {
        uint32_t ah[SU][4], al[SU][4], bh[SU][2], bl[SU][2];
        float c[SU][4];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int ks = ks0 + u, qo = g * QP + 8 * ks + t;
          ah[u][0] = qhi[qo]; ah[u][1] = qhi[qo + 8 * QP];
          ah[u][2] = qhi[qo + 4]; ah[u][3] = qhi[qo + 8 * QP + 4];
          al[u][0] = qlo[qo]; al[u][1] = qlo[qo + 8 * QP];
          al[u][2] = qlo[qo + 4]; al[u][3] = qlo[qo + 8 * QP + 4];
          if constexpr (G::kBf16) {  // keys exact in TF32: q's two parts only
            bh[u][0] = __float_as_uint(widen(kr[8 * ks]));
            bh[u][1] = __float_as_uint(widen(kr[8 * ks + 4]));
          } else {
            split(widen(kr[8 * ks]), bh[u][0], bl[u][0]);
            split(widen(kr[8 * ks + 4]), bh[u][1], bl[u][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) c[u][e] = 0.f;
        }
        // tf32_mma.cuh's mma_split order per chain: lo * hi, hi * lo, hi * hi
#pragma unroll
        for (int u = 0; u < SU; ++u) mma_tf32(c[u], al[u], bh[u][0], bh[u][1]);
        if constexpr (!G::kBf16) {
#pragma unroll
          for (int u = 0; u < SU; ++u) mma_tf32(c[u], ah[u], bl[u][0], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) mma_tf32(c[u], ah[u], bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < SU; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[e] += c[u][e];
      }
    }
    // masked into the score tile: a lane holds keys 2t, 2t + 1 of its n8
    // tile, rows g (hf = 0) and g + 8 (hf = 1)
    const int key0 = it * kKeys;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = key0 + 8 * warp + 2 * t + e;
        x[e] = sacc[2 * hf + e];
        if (kpos >= p.sk)
          x[e] = -INFINITY;  // past the keys: no part in the softmax
        else if ((p.causal && qpos[hf] < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len))
          x[e] = kNeg;
      }
      *reinterpret_cast<float2*>(sbuf + (g + 8 * hf) * kSP + 8 * warp + 2 * t) =
          make_float2(x[0], x[1]);
    }
    __syncthreads();

    // the online softmax over the tile's 32 keys, the same in every warp:
    // pv[hf][j][e] is row g + 8hf, key 8j + 2t + e
    float pv[2][4][2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(sbuf + (g + 8 * hf) * kSP + 8 * j + 2 * t);
        pv[hf][j][0] = v.x;
        pv[hf][j][1] = v.y;
        mx = fmaxf(mx, fmaxf(v.x, v.y));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(mrow[hf], mx);
      const float alpha = expf(mrow[hf] - mnew);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pv[hf][j][e] = expf(pv[hf][j][e] - mnew);
          ps += pv[hf][j][e];
        }
      lrow[hf] = lrow[hf] * alpha + ps;  // this lane's keys; the quad sums at the end
      mrow[hf] = mnew;
#pragma unroll
      for (int n = 0; n < G::NW; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }

    // O += P V over this warp's columns: step j's reduction index t is key
    // 8j + 2t, t + 4 key 8j + 2t + 1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a[4] = {pv[0][j][0], pv[1][j][0], pv[0][j][1], pv[1][j][1]};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (G::kBf16) {
          ph[j][u] = __float_as_uint(round_bf16(a[u]));  // exact in TF32
          pl[j][u] = 0u;
        } else {
          split(a[u], ph[j][u], pl[j][u]);
        }
      }
    }
    // NU n8 tiles at a time, their MMA chains interleaved
    constexpr int NU = G::NU;
#pragma unroll
    for (int nb = 0; nb < G::NW; nb += NU) {
      float c[NU][4];
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[NU][2], bl[NU][2];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const KT* v0 = kt + (8 * j + 2 * t) * KP + n0 + 8 * (nb + u) + g;
          if constexpr (G::kBf16) {  // values and the rounded p exact in TF32
            bh[u][0] = __float_as_uint(widen(v0[0]));
            bh[u][1] = __float_as_uint(widen(v0[KP]));
          } else {
            split(widen(v0[0]), bh[u][0], bl[u][0]);
            split(widen(v0[KP]), bh[u][1], bl[u][1]);
          }
        }
        if constexpr (G::kBf16) {
#pragma unroll
          for (int u = 0; u < NU; ++u) mma_tf32(c[u], ph[j], bh[u][0], bh[u][1]);
        } else {
#pragma unroll
          for (int u = 0; u < NU; ++u) mma_tf32(c[u], pl[j], bh[u][0], bh[u][1]);
#pragma unroll
          for (int u = 0; u < NU; ++u) mma_tf32(c[u], ph[j], bl[u][0], bl[u][1]);
#pragma unroll
          for (int u = 0; u < NU; ++u) mma_tf32(c[u], ph[j], bh[u][0], bh[u][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb + u][e] += c[u][e];
    }
    __syncthreads();  // every warp is done with this tile and the score tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 1);
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 2);
    const int row = r0 + g + 8 * hf;
    if (row >= rows) continue;
    const float l = fmaxf(lrow[hf], 1e-30f);
    const int s = row / p.h, hh = row - s * p.h;
    KT* dst = o + b * p.o_sb + s * p.o_ss + hh * p.o_sh + n0 + 2 * t;
#pragma unroll
    for (int n = 0; n < G::NW; ++n) store2(dst + 8 * n, acc[n][2 * hf] / l, acc[n][2 * hf + 1] / l);
    if (warp == 0 && t == 0) {
      const long long mi = (long long)b * rows + row;
      m_out[mi] = mrow[hf];
      l_out[mi] = l;
    }
  }
}

template <typename KT, int R, int DR>
int launch_mla(const float* q, const KT* ckv, const KT* krope, KT* o, float* m, float* l,
               const MlaParams& p, int nb, cudaStream_t stream) {
  using G = MlaGeom<KT, R, DR>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)flash_mla_kernel<KT, R, DR>, G::kSmemBytes,
                                   allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.sq * p.h + kRows - 1) / kRows), nb);
  flash_mla_kernel<KT, R, DR><<<grid, kThreads, G::kSmemBytes, stream>>>(q, ckv, krope, o, m,
                                                                        l, p);
  return (int)cudaGetLastError();
}

// dims: b, h, sq, sk, r, dr, causal, q_offset, kv_len (< 0: none)
// strides (elements): q b,s,h; c_kv b,s; k_rope b,s; out b,s,h
template <typename KT>
int run(const float* q, const KT* ckv, const KT* krope, KT* out, float* m, float* l,
        const int* dims, const long long* st, float scale, void* stream) {
  MlaParams p;
  const int nb = dims[0], r = dims[4], dr = dims[5];
  p.h = dims[1];
  p.sq = dims[2];
  p.sk = dims[3];
  p.causal = dims[6];
  p.q_offset = dims[7];
  p.kv_len = dims[8];
  p.scale = scale;
  if (nb < 1 || nb > 65535 || p.h < 1 || p.sq < 1 || p.sk < 1 ||
      (long long)p.sq * p.h > 0x7fffffffLL - kRows)
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.c_sb = st[3]; p.c_ss = st[4];
  p.r_sb = st[5]; p.r_ss = st[6];
  p.o_sb = st[7]; p.o_ss = st[8]; p.o_sh = st[9];
  // out takes paired stores (8 or 4 bytes): its base and strides must keep
  // them aligned (the wrapper allocates it contiguous)
  if ((uintptr_t)out % (2 * sizeof(KT)) || (p.o_sb | p.o_ss | p.o_sh) % 2)
    return (int)cudaErrorInvalidValue;
  const int per16 = 16 / (int)sizeof(KT);
  p.vec = ((uintptr_t)q % 16 == 0) && (p.q_sb % 4 == 0) && (p.q_ss % 4 == 0) &&
          (p.q_sh % 4 == 0) && ((uintptr_t)ckv % 16 == 0) && ((uintptr_t)krope % 16 == 0) &&
          (p.c_sb % per16 == 0) && (p.c_ss % per16 == 0) && (p.r_sb % per16 == 0) &&
          (p.r_ss % per16 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (r == 32 && dr == 16) return launch_mla<KT, 32, 16>(q, ckv, krope, out, m, l, p, nb, s);
  if (r == 512 && dr == 64) return launch_mla<KT, 512, 64>(q, ckv, krope, out, m, l, p, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// fp32 q over an fp32 latent -> fp32 out (B, Sq, H, r), m and l (B, Sq * H).
int repro_flash_fwd_mla_f32(const float* q, const float* ckv, const float* krope, float* out,
                            float* m, float* l, const int* dims, const long long* strides,
                            float scale, void* stream) {
  return run<float>(q, ckv, krope, out, m, l, dims, strides, scale, stream);
}

// fp32 q over a bf16 latent -> bf16 out (B, Sq, H, r), fp32 m and l.
int repro_flash_fwd_mla_bf16kv(const float* q, const uint16_t* ckv, const uint16_t* krope,
                               uint16_t* out, float* m, float* l, const int* dims,
                               const long long* strides, float scale, void* stream) {
  return run<uint16_t>(q, ckv, krope, out, m, l, dims, strides, scale, stream);
}

}  // extern "C"
