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
// scores. All sums are fp32 FMAs on the CUDA cores; a bf16 output is
// rounded once (to nearest, ties to even). Limits against the plain
// version (`flash_bwd_mla_plain`): fp32 1e-4 * max|plain| + 1e-5 * min(1,
// max|plain|) + 8 * 2^-24 * S * max|plain| at scores up to S (the scores
// are recomputed in another order than the forward's m took them); bf16
// 2^-7 * max|plain|.
//
// Layout: q (B, Sq, H, r + dr), do (B, Sq, H, r), c_kv (B, Sk, r), k_rope
// (B, Sk, dr), all contiguous, so row s * H + h of batch b is row b * Sq * H
// + s * H + h of q and do; m, l, delta (B, Sq * H). Outputs dq in q's shape,
// dc_kv and dk_rope in the latents' shapes, contiguous. Instantiated at
// (r, dr) = (512, 64) (full width) and (32, 16) (reduced), for any H.
//
// What bounds it on this card (67 TFLOP/s fp32 on the CUDA cores; 3.35
// TB/s): operations. Full-width deepseek-v2's sublayer at B 2, S 128, H 128,
// causal: 2.1 M visible (row, key) pairs; the dq pass does 2 (Dk + Dv + Dk)
// = 3,328 operations a pair (s, dp, ds.K) and the dkv pass 2 (Dk + Dv + 2
// Dv + dr) = 4,352 (s, dp, ds^T qs, p^T do): 7.0 and 9.2 GFLOP against 75
// MB of q and 34 MB of do.
//
// Design (a first kernel that is right; ROADMAP queue 2 lists its
// redesign onto the tensor cores):
// - Both passes work on 16 x 16 tiles of (row, key) pairs, one pair per
//   thread of a 256-thread block: a thread takes its pair's score and dp as
//   two dot products over the shared q (scaled), do and key rows, read as
//   float4 (rows padded to a multiple of 4 floats so that a quarter warp's
//   eight keys hit 32 distinct banks), four partial sums each.
// - dq pass: a block owns 16 rows, keeps their q and do in shared memory,
//   and walks the visible key tiles (the forward's exact skip); ds goes to
//   a shared tile, then each thread adds ds . K to its columns of the
//   16 x Dk accumulator (Dk / 256 columns, 16 rows: 48 registers at full
//   width).
// - dkv pass: a block owns 16 keys and one chunk of the row tiles of its
//   batch element and sums over them (all H heads: one latent kv head); it
//   skips a row tile none of whose rows sees its keys (and every row of
//   which sees some key). The chunks' fp32 partial sums (nc, B, Sk, Dk) are
//   added in chunk order by a second kernel, which writes dc_kv and dk_rope:
//   no atomics, so a repeat is bitwise the same. The wrapper picks nc so
//   that about two blocks run on each SM: at full width 16 (B 2, 8 key
//   tiles, 64 row tiles a chunk).
// - Shared memory per block: q and key tiles 16 x (Dk + 4) fp32 each, do
//   16 x (r + 4): 108 KB at full width (two blocks an SM).
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing (the wrapper allocates the outputs and the
// dkv partials), raise the kernels' dynamic shared-memory limit once per
// device, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "smem_io.cuh"

namespace {

using smemio::allow_smem;
using smemio::kMaxDevices;

constexpr float kNeg = -1e30f;
constexpr int kRows = 16;      // rows of a tile
constexpr int kKeys = 16;      // keys of a tile
constexpr int kThreads = 256;  // one (row, key) pair of a tile per thread

struct BwdParams {
  int h, sq, sk, rows;  // rows = sq * h per batch element
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale, dscale;
  int nc, tiles_per_chunk;  // dkv: row chunks, row tiles per chunk
};

template <int R, int DR>
struct Geom {
  static constexpr int DK = R + DR;
  static constexpr int QP = DK + 4;  // floats per shared q or key row
  static constexpr int OP = R + 4;   // floats per shared do row
  static constexpr int NCOL = (DK + kThreads - 1) / kThreads;  // columns per thread
  static constexpr int kSmemFloats = 2 * 16 * QP + 16 * OP + 3 * 16 + 2 * 16 * 16;
  static constexpr int kSmemBytes = 4 * kSmemFloats;
  static_assert(R % 4 == 0 && DR % 4 == 0, "rows are read as float4");
  static_assert(kSmemBytes <= 232448, "past the 227 KB a block may use");
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }
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

// True when no row of the tile at r0 can take any gradient from the keys at
// k0: every row sees some key (so p is 0 exactly on the masked ones) and
// none sees these.
__device__ __forceinline__ bool tile_blind(const BwdParams& p, int r0, int k0) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  const int s_first = r0 / p.h, s_last = (min(r0 + kRows, p.rows) - 1) / p.h;
  if (kv_lim == 0 || (p.causal && p.q_offset + s_first < 0)) return false;
  return k0 >= kv_lim || (p.causal && k0 > p.q_offset + s_last);
}

// Rows r0 .. r0 + 15 of batch element b: q times the scale and do, widened,
// and their m, l, delta (zeros past the rows; l 1).
template <typename KT, int R, int DR>
__device__ void stage_rows(float* qs, float* dos, float* st, const float* __restrict__ q,
                           const KT* __restrict__ dout, const float* __restrict__ m,
                           const float* __restrict__ l, const float* __restrict__ delta,
                           long long rb, int r0, const BwdParams& p) {
  using G = Geom<R, DR>;
  for (int i = threadIdx.x; i < kRows * G::DK; i += kThreads) {
    const int r = i / G::DK, d = i - r * G::DK, row = r0 + r;
    qs[r * G::QP + d] = row < p.rows ? q[(rb + row) * G::DK + d] * p.scale : 0.f;
  }
  for (int i = threadIdx.x; i < kRows * R; i += kThreads) {
    const int r = i / R, d = i - r * R, row = r0 + r;
    dos[r * G::OP + d] = row < p.rows ? widen(dout[(rb + row) * R + d]) : 0.f;
  }
  if (threadIdx.x < kRows) {
    const int row = r0 + threadIdx.x;
    const bool ok = row < p.rows;
    st[threadIdx.x] = ok ? m[rb + row] : 0.f;
    st[kRows + threadIdx.x] = ok ? l[rb + row] : 1.f;
    st[2 * kRows + threadIdx.x] = ok ? delta[rb + row] : 0.f;
  }
}

// Keys k0 .. k0 + 15 of batch element b as rows [c_kv ; k_rope], widened
// (zeros past Sk).
template <typename KT, int R, int DR>
__device__ void stage_keys(float* kt, const KT* __restrict__ ckv, const KT* __restrict__ krope,
                           int b, int k0, const BwdParams& p) {
  using G = Geom<R, DR>;
  for (int i = threadIdx.x; i < kKeys * G::DK; i += kThreads) {
    const int k = i / G::DK, d = i - k * G::DK, key = k0 + k;
    float x = 0.f;
    if (key < p.sk) {
      const long long kb = (long long)b * p.sk + key;
      x = d < R ? widen(ckv[kb * R + d]) : widen(krope[kb * DR + d - R]);
    }
    kt[k * G::QP + d] = x;
  }
}

// p and ds of the pair (row r0 + r, key k0 + k) from the staged tiles.
template <int R, int DR>
__device__ __forceinline__ void pair_grad(const float* qs, const float* dos, const float* kt,
                                          const float* st, int r, int k, int r0, int k0,
                                          const BwdParams& p, float& pv, float& dsv) {
  using G = Geom<R, DR>;
  pv = 0.f;
  dsv = 0.f;
  const int row = r0 + r, key = k0 + k;
  if (row >= p.rows || key >= p.sk) return;
  const float4* qa = reinterpret_cast<const float4*>(qs + r * G::QP);
  const float4* ka = reinterpret_cast<const float4*>(kt + k * G::QP);
  const float4* oa = reinterpret_cast<const float4*>(dos + r * G::OP);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < G::DK / 4; ++i) {
    const float4 a = qa[i], c = ka[i];
    s0 = fmaf(a.x, c.x, s0);
    s1 = fmaf(a.y, c.y, s1);
    s2 = fmaf(a.z, c.z, s2);
    s3 = fmaf(a.w, c.w, s3);
  }
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < R / 4; ++i) {
    const float4 a = oa[i], c = ka[i];
    d0 = fmaf(a.x, c.x, d0);
    d1 = fmaf(a.y, c.y, d1);
    d2 = fmaf(a.z, c.z, d2);
    d3 = fmaf(a.w, c.w, d3);
  }
  const float s = (s0 + s1) + (s2 + s3), dp = (d0 + d1) + (d2 + d3);
  const int qpos = p.q_offset + row / p.h;
  const bool masked = (p.causal && qpos < key) || (p.kv_len >= 0 && key >= p.kv_len);
  pv = expf((masked ? kNeg : s) - st[r]) / st[kRows + r];
  dsv = masked ? 0.f : pv * (dp - st[2 * kRows + r]);
}

// 16 values of a shared tile row, read as four float4s (a broadcast).
__device__ __forceinline__ void load16(float (&v)[16], const float* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads)
mla_bwd_dq_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                  const KT* __restrict__ krope, const KT* __restrict__ dout,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ delta, KT* __restrict__ dq, BwdParams p) {
  using G = Geom<R, DR>;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                   // [16][QP]
  float* const kt = qs + kRows * G::QP;     // [16][QP]
  float* const dos = kt + kKeys * G::QP;    // [16][OP]
  float* const st = dos + kRows * G::OP;    // m, l, delta [3][16]
  float* const dsT = st + 3 * kRows;        // [16 keys][16 rows]
  const int tid = threadIdx.x, b = blockIdx.y, r0 = blockIdx.x * kRows;
  const long long rb = (long long)b * p.rows;
  const int pr = tid / kKeys, pk = tid % kKeys;
  stage_rows<KT, R, DR>(qs, dos, st, q, dout, m, l, delta, rb, r0, p);
  const int kend = visit_end(p, r0 / p.h, (min(r0 + kRows, p.rows) - 1) / p.h);

  float acc[kRows][G::NCOL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < G::NCOL; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    __syncthreads();  // the previous tile's keys and ds are no longer read
    stage_keys<KT, R, DR>(kt, ckv, krope, b, k0, p);
    __syncthreads();  // ... and at k0 = 0 the rows too
    float pv, dsv;
    pair_grad<R, DR>(qs, dos, kt, st, pr, pk, r0, k0, p, pv, dsv);
    dsT[pk * kRows + pr] = dsv;
    __syncthreads();
    for (int k = 0; k < kKeys; ++k) {
      float ds[kRows];
      load16(ds, dsT + k * kRows);
#pragma unroll
      for (int j = 0; j < G::NCOL; ++j) {
        const int c = tid + j * kThreads;
        if (c < G::DK) {
          const float kv = kt[k * G::QP + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(ds[r], kv, acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < G::NCOL; ++j) {
    const int c = tid + j * kThreads;
    if (c >= G::DK) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < p.rows) put(dq + (rb + r0 + r) * G::DK + c, acc[r][j] * p.dscale);
  }
}

template <typename KT, int R, int DR>
__global__ void __launch_bounds__(kThreads)
mla_bwd_dkv_kernel(const float* __restrict__ q, const KT* __restrict__ ckv,
                   const KT* __restrict__ krope, const KT* __restrict__ dout,
                   const float* __restrict__ m, const float* __restrict__ l,
                   const float* __restrict__ delta, float* __restrict__ part, BwdParams p) {
  using G = Geom<R, DR>;
  extern __shared__ __align__(16) float smem[];
  float* const kt = smem;                   // [16][QP]
  float* const qs = kt + kKeys * G::QP;     // [16][QP]
  float* const dos = qs + kRows * G::QP;    // [16][OP]
  float* const st = dos + kRows * G::OP;    // m, l, delta [3][16]
  float* const dsb = st + 3 * kRows;        // [16 rows][16 keys]
  float* const pb = dsb + kRows * kKeys;    // [16 rows][16 keys]
  const int tid = threadIdx.x, k0 = blockIdx.x * kKeys, b = blockIdx.y, chunk = blockIdx.z;
  const long long rb = (long long)b * p.rows;
  const int pr = tid / kKeys, pk = tid % kKeys;
  stage_keys<KT, R, DR>(kt, ckv, krope, b, k0, p);

  float acc[kKeys][G::NCOL];
#pragma unroll
  for (int k = 0; k < kKeys; ++k)
#pragma unroll
    for (int j = 0; j < G::NCOL; ++j) acc[k][j] = 0.f;

  const int n_tiles = (p.rows + kRows - 1) / kRows;
  const int t_begin = chunk * p.tiles_per_chunk;
  const int t_end = min(t_begin + p.tiles_per_chunk, n_tiles);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int r0 = tile * kRows;
    if (tile_blind(p, r0, k0)) continue;  // the same in every thread
    __syncthreads();  // the previous tile's rows, ds and p are no longer read
    stage_rows<KT, R, DR>(qs, dos, st, q, dout, m, l, delta, rb, r0, p);
    __syncthreads();  // ... and at the first tile the keys too
    float pv, dsv;
    pair_grad<R, DR>(qs, dos, kt, st, pr, pk, r0, k0, p, pv, dsv);
    dsb[pr * kKeys + pk] = dsv;
    pb[pr * kKeys + pk] = pv;
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      float ds[kKeys], pp[kKeys];
      load16(ds, dsb + r * kKeys);
      load16(pp, pb + r * kKeys);
#pragma unroll
      for (int j = 0; j < G::NCOL; ++j) {
        const int c = tid + j * kThreads;
        if (c < G::DK) {
          const float qv = qs[r * G::QP + c];
          const float dv = c < R ? dos[r * G::OP + c] : 0.f;
#pragma unroll
          for (int k = 0; k < kKeys; ++k) acc[k][j] = fmaf(ds[k], qv, fmaf(pp[k], dv, acc[k][j]));
        }
      }
    }
  }
  const long long base = ((long long)chunk * gridDim.y + b) * p.sk;
#pragma unroll
  for (int j = 0; j < G::NCOL; ++j) {
    const int c = tid + j * kThreads;
    if (c >= G::DK) continue;
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
      if (k0 + k < p.sk) part[(base + k0 + k) * G::DK + c] = acc[k][j];
  }
}

// dc_kv and dk_rope: the chunks' partial sums added in chunk order.
template <typename KT, int R, int DR>
__global__ void mla_bwd_dkv_reduce(const float* __restrict__ part, KT* __restrict__ dckv,
                                   KT* __restrict__ dkrope, int nc, long long n) {
  constexpr int DK = R + DR;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < nc; ++c) s += part[c * n + i];
  const long long key = i / DK;
  const int d = (int)(i - key * DK);
  if (d < R)
    put(dckv + key * R + d, s);
  else
    put(dkrope + key * DR + d - R, s);
}

template <typename KT, int R, int DR>
int launch_dq(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
              const float* l, const float* delta, KT* dq, const BwdParams& p, int nb,
              cudaStream_t stream) {
  using G = Geom<R, DR>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)mla_bwd_dq_kernel<KT, R, DR>, G::kSmemBytes,
                                   allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.rows + kRows - 1) / kRows), nb);
  mla_bwd_dq_kernel<KT, R, DR><<<grid, kThreads, G::kSmemBytes, stream>>>(q, ckv, krope, dout,
                                                                         m, l, delta, dq, p);
  return (int)cudaGetLastError();
}

template <typename KT, int R, int DR>
int launch_dkv(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
               const float* l, const float* delta, float* part, KT* dckv, KT* dkrope,
               const BwdParams& p, int nb, cudaStream_t stream) {
  using G = Geom<R, DR>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)mla_bwd_dkv_kernel<KT, R, DR>, G::kSmemBytes,
                                   allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((p.sk + kKeys - 1) / kKeys), nb, p.nc);
  mla_bwd_dkv_kernel<KT, R, DR><<<grid, kThreads, G::kSmemBytes, stream>>>(q, ckv, krope, dout,
                                                                          m, l, delta, part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nb * p.sk * G::DK;
  mla_bwd_dkv_reduce<KT, R, DR><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dckv, dkrope, p.nc, n);
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
      (long long)p.sq * p.h > 0x7fffffffLL - kRows)
    return false;
  p.rows = p.sq * p.h;
  const int n_tiles = (p.rows + kRows - 1) / kRows;
  p.tiles_per_chunk = (n_tiles + p.nc - 1) / p.nc;
  return true;
}

template <typename KT>
int run_dq(const float* q, const KT* ckv, const KT* krope, const KT* dout, const float* m,
           const float* l, const float* delta, KT* dq, const int* dims, float scale,
           float dscale, void* stream) {
  BwdParams p;
  int nb, r, dr;
  if (!parse(dims, scale, dscale, p, nb, r, dr)) return (int)cudaErrorInvalidValue;
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
