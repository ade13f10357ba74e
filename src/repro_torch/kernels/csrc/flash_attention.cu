// GQA flash-attention forward for Hopper (sm_90a), over an fp32 or an int8
// K/V cache, or on bf16 operands.
//
// Replaces the TPU kernels
//   repro/kernels/flash_attention/kernel.py flash_fwd_pallas    -> repro_flash_fwd_f32
//                                                                  repro_flash_fwd_bf16
//   repro/kernels/flash_attention/kernel.py flash_fwd_q8_pallas -> repro_flash_fwd_q8
// with one device body on the TF32 tensor cores in split-TF32, instantiated
// as `flash_fwd_kernel<D>` for fp32 K/V and `flash_fwd_q8_kernel<D>` for int8
// K/V with per-position fp32 scales, dequantized as they are staged,
// (float)k_q8 * k_scale[pos] (the product `_dequantize_kv` forms at fp32).
//
// The bf16 entry point (the training step at the reference's default
// bfloat16) is `flash_fwd_bf16_kernel<D>` further down, in FlashAttention-2's
// layout on the bf16 tensor cores (mma.sync m16n8k16, fp32 accumulation):
// a warp owns 16 rows for the whole walk over K/V tiles that a block-shared
// cp.async ring stages, with ldmatrix fragments and no cross-warp merge. It
// rounds where the reference does (p before P.V, out), scales the scores by
// the scale rounded to bf16, and keeps m and l fp32; within 2^-7 *
// max|plain| of out and 1e-5 * max|plain| of m and l.
//
// What it computes (the Pallas kernels' function): for every kv head bkv,
// group g and query position s, with qpos = q_offset + s,
//   scores[k] = (q[bkv,g,s,:] * scale) . k[bkv,k,:]      for k < Sk,
//   masked to NEG = -1e30 where (causal and qpos < k) or k >= kv_len,
//   m = max_k scores, l = sum_k exp(scores - m),
//   out = sum_k exp(scores - m) v[bkv,k,:] / max(l, 1e-30),
// and m and l = max(l, 1e-30) (the fp32 entry point; the training slice's
// backward reads them). A fully masked row gets the reference's answer (the
// mean of v over all Sk keys, m = NEG), because the mask is -1e30, not -inf.
// fp32 within the port's limit of a plain fp32 sum (1e-4 * max|plain| +
// 1e-5 * min(1, max|plain|)) for out, m and l.
//
// Layout: the kernels read q, k, v, the scales and write out through element
// strides, with the bkv axis split as bkv = b * nh + h. The wrapper passes
// nh = 1 for the (BKV, G, Sq, D) / (BKV, Sk, D) layout of the Pallas kernels,
// and nh = KV for the model's (B, Sq, KV, G, D) queries over the cache's
// (B, S_max, KV, D) keys, so the decode path reads the cache in place with no
// transpose. m and l are (BKV, G, Sq), contiguous.
//
// Head dims: the fp32 and int8 K/V forwards are instantiated at D = 8, 16,
// 32, 64, 128, 160 (stablelm-12b: d_model 5120 over 32 heads) and 256; the
// body needs only 8 | D (k8 steps, float4 rows). The bf16 forward keeps
// 8 ... 256 without 160.
//
// What bounds the kernel on this card: at the shapes it runs (served
// prefill B4 Sq32 Sk64 and decode Sq1 kv_len <= 64 at KV 8, G 2, D 128; the
// trained forward B8 Sq = Sk = 128) neither bytes (a few MB) nor operations
// (a few hundred MFLOP) but latency and filling 132 SMs: the load of a K/V
// tile, the chain of dependent MMAs and the softmax exchanges.
//
// Design:
// - The Pallas grid (bkv, g, q-tile, kv-tile) runs its kv axis in order,
//   carrying m, l and acc in VMEM scratch. Here one block owns 16 rows (one
//   m16 tile) of the (position, group) rows of one kv head, flattened as
//   row = s * G + g, so decode pads its G = 2 live rows to 16, not 64, and
//   the served prefill (64 rows per kv head) runs 4 x 32 = 128 blocks, the
//   trained forward 16 x 64 = 1024. All G groups of a kv head share its K/V
//   reads, as the Pallas GQA layout intends.
// - Its 4 warps split the keys, not the rows: warp w takes the 16-key chunks
//   c = w, w + 4, ... and runs its own online softmax over them (m, l and its
//   16 x D output accumulator in registers), with no barrier until the end;
//   there the block combines the four partial softmaxes (m = max m_w,
//   out = sum exp(m_w - m) O_w / sum exp(m_w - m) l_w) through shared memory.
//   A warp staging its own chunks with cp.async needs only __syncwarp; the
//   next chunk's K loads under this chunk's softmax and P.V, its V under the
//   next Q.K^T.
// - Q.K^T and P.V on mma.sync m16n8k8 TF32 in split-TF32 (tf32_mma.cuh's
//   split: hi = x rounded to TF32, lo = x - hi truncated by the MMA;
//   three products lo*hi + hi*lo + hi*hi per multiply-add). One TF32
//   product per multiply-add misses the fp32 limit on the scores at D = 128
//   (the host emulation in tests/test_torch_kernels.py); split it holds. Q
//   is scaled, split and staged once per block (hi and lo); K and V are
//   split as their fragments load, each value once.
// - P needs no trip through shared memory: in a score tile a lane holds keys
//   2t and 2t + 1 of rows g and g + 8, and feeding them to P.V as reduction
//   indices t and t + 4 is only a renaming of the 8 keys of an MMA step,
//   matched by reading V's rows 2t and 2t + 1 for B.
// - Shared rows are padded to D + 4 floats, which makes the Q and K fragment
//   loads (rows g, columns t) and the V fragment loads (rows 2t, 2t + 1,
//   column g) conflict-free.
// - The exact skip of the first design stays: the chunks stop after the last
//   key some row of the block can see (kv_len, and the causal diagonal).
//   Once a row has seen one visible key its running max is real, so a fully
//   masked chunk or a warp's masked partial adds exp(-1e30 - m) = 0. The
//   skip is taken only when every row of the block sees key 0 (kv_len >= 1
//   and, under the causal mask, q_offset + first position >= 0); otherwise
//   the chunks cover all Sk keys, as the reference does.
// - Ragged edges: keys past Sk take no part (score -inf, p = 0, K/V rows
//   zero-filled); rows past Sq * G compute on zeros and write nothing. With
//   16-byte aligned operands and strides, K/V rows are staged by 16-byte
//   cp.async and Q read as float4; otherwise (a view off alignment) by
//   4-byte cp.async and scalar loads, with the same results.
// - int8 K/V: the same body; a warp stages its chunk by plain 4-byte loads,
//   dequantized into the same fp32 [16][D+4] layout (no cp.async: the
//   product is formed in registers).
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, raise a kernel's dynamic shared-memory
// limit once per device, and return cudaGetLastError().

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

constexpr float kNeg = -1e30f;

struct FlashParams {
  int nh, g, sq, sk;
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale;
  int vec;  // rows 16-byte (fp32 K/V) or 4-byte (int8 K/V) aligned, q and out 16
  long long q_sb, q_sh, q_sg, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long s_sb, s_sh, s_ss;  // k_scale / v_scale (int8 K/V only)
  long long o_sb, o_sh, o_sg, o_ss;
};

// The key range [0, kend) a block of rows [s_first, s_last] must visit: the
// exact skip, taken only when every row sees key 0.
__device__ __forceinline__ int visit_end(const FlashParams& p, int s_first, int s_last) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  int kend = p.sk;
  if (kv_lim > 0 && (!p.causal || p.q_offset + s_first >= 0)) {
    kend = kv_lim;
    if (p.causal) kend = min(kend, p.q_offset + s_last + 1);
  }
  return kend;
}

constexpr int kTileRows = 16;  // query rows per block (one m16 tile)
constexpr int kChunk = 16;     // keys per warp step (two n8 tiles)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Shared floats: Q hi and lo [16][D+4], per warp a K and a V chunk
// [16][D+4], and the warps' m and l [2][kWarps][16]: 85 KB at D = 128.
template <int D>
constexpr int fwd_smem_floats() {
  return 2 * kTileRows * (D + 4) + kWarps * 2 * kChunk * (D + 4) + 2 * kWarps * kTileRows;
}

// Stage keys pos0 .. pos0 + 15 of one K or V head into a [16][D+4] chunk
// (rows past Sk zero-filled), by this warp's lanes: fp32 by cp.async.
template <int D>
__device__ __forceinline__ void stage_chunk(float* dst, const float* __restrict__ src,
                                            const float*, long long base, long long ss,
                                            long long, int pos0, const FlashParams& p,
                                            int lane) {
  constexpr int DP = D + 4;
  if (p.vec) {
    constexpr int kC = D / 4;
#pragma unroll
    for (int i = lane; i < kChunk * kC; i += 32) {
      const int r = i / kC, c = i - r * kC, pos = pos0 + r;
      const bool ok = pos < p.sk;
      cp_async16(smem_addr(dst + r * DP + 4 * c), ok ? src + base + pos * ss + 4 * c : src, ok);
    }
  } else {
    for (int i = lane; i < kChunk * D; i += 32) {
      const int r = i / D, d = i - r * D, pos = pos0 + r;
      const bool ok = pos < p.sk;
      cp_async4(smem_addr(dst + r * DP + d), ok ? src + base + pos * ss + d : src, ok);
    }
  }
}

// The same from int8 K or V with its per-position fp32 scales, dequantized
// on the way as (float)x * scale[pos] (`_dequantize_kv`'s product): 4 values
// per load where the rows keep 4-byte alignment.
template <int D>
__device__ __forceinline__ void stage_chunk(float* dst, const int8_t* __restrict__ src,
                                            const float* __restrict__ sc, long long base,
                                            long long ss, long long sbase, int pos0,
                                            const FlashParams& p, int lane) {
  constexpr int DP = D + 4;
  constexpr int kC = D / 4;
#pragma unroll
  for (int j = 0; j < (kChunk * kC + 31) / 32; ++j) {  // a constant trip count, so
    const int i = lane + 32 * j;                        // the loads go out together
    if (i >= kChunk * kC) break;
    const int r = i / kC, d = 4 * (i - r * kC), pos = pos0 + r;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < p.sk) {
      const int8_t* x = src + base + pos * ss + d;
      const float s = sc[sbase + pos * p.s_ss];
      if (p.vec) {
        const char4 c4 = *reinterpret_cast<const char4*>(x);
        f = make_float4((float)c4.x * s, (float)c4.y * s, (float)c4.z * s, (float)c4.w * s);
      } else {
        f = make_float4((float)x[0] * s, (float)x[1] * s, (float)x[2] * s, (float)x[3] * s);
      }
    }
    *reinterpret_cast<float4*>(dst + r * DP + d) = f;
  }
}

// KT: K/V element type (float, or int8_t with scales ks / vs); m_out and
// l_out only for fp32.
template <typename KT, int D>
__device__ __forceinline__ void flash_fwd_body(const float* __restrict__ q,
                                               const KT* __restrict__ k,
                                               const KT* __restrict__ v,
                                               const float* __restrict__ ks,
                                               const float* __restrict__ vs,
                                               float* __restrict__ o, float* __restrict__ m_out,
                                               float* __restrict__ l_out, const FlashParams& p) {
  constexpr int DP = D + 4;
  constexpr int NT = D / 8;  // k8 steps of Q.K^T, n8 tiles of P.V
  extern __shared__ __align__(16) float smem[];
  uint32_t* const qhi = reinterpret_cast<uint32_t*>(smem);  // [16][DP]
  uint32_t* const qlo = qhi + kTileRows * DP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* const kc = smem + 2 * kTileRows * DP + warp * 2 * kChunk * DP;  // this warp's K
  float* const vc = kc + kChunk * DP;                                   // and V chunk
  float* const xm = smem + 2 * kTileRows * DP + kWarps * 2 * kChunk * DP;  // [warp][row]
  float* const xl = xm + kWarps * kTileRows;

  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int rows = p.sq * p.g;  // (position, group) rows of this kv head
  const int r0 = blockIdx.x * kTileRows;
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long kb = b * p.k_sb + h * p.k_sh;
  const long long vb = b * p.v_sb + h * p.v_sh;
  const long long sb = b * p.s_sb + h * p.s_sh;
  const int kend = visit_end(p, r0 / p.g, (min(r0 + kTileRows, rows) - 1) / p.g);
  const int n_chunks = (kend + kChunk - 1) / kChunk;

  // this warp's first chunk loads while Q is staged
  int c = warp;
  if (c < n_chunks) stage_chunk<D>(kc, k, ks, kb, p.k_ss, sb, c * kChunk, p, lane);
  cp_async_commit();
  if (c < n_chunks) stage_chunk<D>(vc, v, vs, vb, p.v_ss, sb, c * kChunk, p, lane);
  cp_async_commit();

  // Q, scaled as the plain version scales it, split into hi and lo
  for (int i = tid; i < kTileRows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4, row = r0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows) {
      const int s = row / p.g;
      const float* src = q + qb + (row - s * p.g) * p.q_sg + s * p.q_ss + d;
      if (p.vec) {
        const float4 f = *reinterpret_cast<const float4*>(src);
        x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = src[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(x[e] * p.scale, qhi[r * DP + d + e], qlo[r * DP + d + e]);
  }
  __syncthreads();

  int qpos[2];  // rows g and g + 8 of the tile
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) qpos[hf] = p.q_offset + (r0 + g + 8 * hf) / p.g;

  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (; c < n_chunks; c += kWarps) {
    const int key0 = c * kChunk;
    const bool next = c + kWarps < n_chunks;
    cp_async_wait<1>();  // K(c) landed (V(c) may still be in flight)
    __syncwarp();

    // S = Q K^T over two n8 tiles of keys, two accumulator chains per tile
    float sacc[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[a][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const int qo = g * DP + 8 * ks + t;
      const uint32_t ah[4] = {qhi[qo], qhi[qo + 8 * DP], qhi[qo + 4], qhi[qo + 8 * DP + 4]};
      const uint32_t al[4] = {qlo[qo], qlo[qo + 8 * DP], qlo[qo + 4], qlo[qo + 8 * DP + 4]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* kr = kc + (8 * j + g) * DP + 8 * ks + t;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma_split(sacc[ks & 1][j], ah, al, bh, bl);
      }
    }
    __syncwarp();  // every lane is done with K(c)
    if (next) stage_chunk<D>(kc, k, ks, kb, p.k_ss, sb, (c + kWarps) * kChunk, p, lane);
    cp_async_commit();

    // masks and the online softmax: a lane holds keys 8j + 2t + e of rows
    // g (hf = 0) and g + 8 (hf = 1)
    float pr[2][2][2];  // [hf][j][e]
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = key0 + 8 * j + 2 * t + e;
          float x = sacc[0][j][2 * hf + e] + sacc[1][j][2 * hf + e];
          if (kpos >= p.sk)
            x = -INFINITY;  // past the keys: no part in the softmax
          else if ((p.causal && qpos[hf] < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len))
            x = kNeg;
          pr[hf][j][e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(mrow[hf], mx);
      const float alpha = expf(mrow[hf] - mnew);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pr[hf][j][e] = expf(pr[hf][j][e] - mnew);
          ps += pr[hf][j][e];
        }
      lrow[hf] = lrow[hf] * alpha + ps;  // this lane's keys; the quad sums at the end
      mrow[hf] = mnew;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }

    cp_async_wait<1>();  // V(c) landed (K(c + 4) may still be in flight)
    __syncwarp();
    // O += P V: step j's reduction index t is key 8j + 2t, t + 4 key 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ph[4], pl[4];
      split(pr[0][j][0], ph[0], pl[0]);
      split(pr[1][j][0], ph[1], pl[1]);
      split(pr[0][j][1], ph[2], pl[2]);
      split(pr[1][j][1], ph[3], pl[3]);
      const float* vr = vc + (8 * j + 2 * t) * DP + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh[2], bl[2];
        split(vr[8 * n], bh[0], bl[0]);
        split(vr[8 * n + DP], bh[1], bl[1]);
        mma_split(acc[n], ph, pl, bh, bl);
      }
    }
    __syncwarp();  // every lane is done with V(c)
    if (next) stage_chunk<D>(vc, v, vs, vb, p.v_ss, sb, (c + kWarps) * kChunk, p, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // combine the warps' partial softmaxes: m = max m_w, each warp's output
  // scaled by exp(m_w - m) into its K chunk's space, then summed
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 1);
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 2);
    if (t == 0) {
      xm[warp * kTileRows + g + 8 * hf] = mrow[hf];
      xl[warp * kTileRows + g + 8 * hf] = lrow[hf];
    }
  }
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mall = xm[g + 8 * hf];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mall = fmaxf(mall, xm[w * kTileRows + g + 8 * hf]);
    const float f = expf(mrow[hf] - mall);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(kc + (g + 8 * hf) * DP + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hf] * f, acc[n][2 * hf + 1] * f);
  }
  __syncthreads();
  const float* part = smem + 2 * kTileRows * DP;  // warp w's output at w * 2 * kChunk * DP
  for (int i = tid; i < kTileRows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4, row = r0 + r;
    if (row >= rows) continue;
    float mall = xm[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mall = fmaxf(mall, xm[w * kTileRows + r]);
    float lsum = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lsum += expf(xm[w * kTileRows + r] - mall) * xl[w * kTileRows + r];
      const float4 x = *reinterpret_cast<const float4*>(part + w * 2 * kChunk * DP + r * DP + d);
      sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
    }
    const float l = fmaxf(lsum, 1e-30f);
    const int s = row / p.g, gg = row - s * p.g;
    float* dst = o + b * p.o_sb + h * p.o_sh + gg * p.o_sg + s * p.o_ss + d;
    const float4 y = make_float4(sum.x / l, sum.y / l, sum.z / l, sum.w / l);
    if (p.vec) {
      *reinterpret_cast<float4*>(dst) = y;
    } else {
      dst[0] = y.x; dst[1] = y.y; dst[2] = y.z; dst[3] = y.w;
    }
    if (m_out != nullptr && d == 0) {
      const long long idx = ((long long)bkv * p.g + gg) * p.sq + s;
      m_out[idx] = mall;
      l_out[idx] = l;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, FlashParams p) {
  flash_fwd_body<float, D>(q, k, v, nullptr, nullptr, o, m_out, l_out, p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_q8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                    const int8_t* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, float* __restrict__ o, FlashParams p) {
  flash_fwd_body<int8_t, D>(q, k, v, ks, vs, o, nullptr, nullptr, p);
}

// ---------------------------------------------------------------------------
// bf16 operands on the bf16 tensor cores (repro_flash_fwd_bf16)
// ---------------------------------------------------------------------------
//
// The function and rounding points are the reference's, on m16n8k16 bf16
// MMAs with fp32 accumulators: S = Q K^T from the raw bf16 operands, times
// the scale rounded to bf16 (p.scale) in fp32; p = exp2((x - m) log2 e) by
// the MUFU's ex2.approx (within 2^-22 of exact, against the 2^-8 of the bf16
// rounding that follows), rounded to bf16 as it packs into P.V's A fragment;
// l sums the unrounded p; out = O / max(l, 1e-30), rounded to bf16 once; m
// and l fp32. Within 2^-7 * max|plain| of out and 1e-5 * max|plain| of m
// and l. S adds each k16 step's MMA, made into a zeroed fragment, with a
// rounded FADD (rows_product's kFresh): a chain of MMAs into one accumulator
// truncates at every step and drifts past the limit of m and l.
//
// What bounds it on this card (989 TFLOP/s of bf16, 3.35 TB/s): at the
// trained shape (qwen3-0.6b layer 0, B8, S128, KV 8, G 2, D 128, causal) it
// moves about 12.7 MB (0.0038 ms) against 0.0005 ms of operations: bytes
// on paper, and in practice latency, since each block walks one or two key
// tiles. At the long shape (B4, 2048^2 causal) 0.070 ms of operations
// against 0.030 ms of bytes: operations.
//
// Geometry: FlashAttention-2's layout on mma.sync, the bf16 dq pass's walk
// (flash_attention_bwd.cu) with an online softmax in place of dP.
// - A block owns BM flattened (position, group) rows of one kv head, a warp
//   16 of them, and every warp walks the same KN-key tiles of the block's
//   visible range. A warp keeps its rows' m, l and 16 x D fp32 O in
//   registers for the whole walk and writes out (times 1 / l, rounded to
//   bf16) and m and l from them: no partial crosses warps, and the fixed
//   order of steps repeats bitwise.
// - K and V pass through a two-stage ring in shared memory, copied once per
//   block by cp.async (16 bytes, 8 threads a row), the next tile in flight
//   while the current one is used, one barrier per tile. The block's Q is
//   copied by cp.async ahead of the first ring tile. Keys past the last one
//   a row of the block can see are zero-filled, not read.
// - Fragments by ldmatrix: .x4 for K (two n8 key tiles of a k16 step per
//   instruction), .x4.trans for V. Q's A fragments stay in registers across
//   tiles at D <= 128; at D = 256 they are read at each step. Shared rows
//   are D + 8 elements, so every ldmatrix row address is 16-byte aligned and
//   the 8 rows of a phase fall on 8 distinct bank quads.
// - Causal: a block stops after its last visible key tile, and the blocks
//   with the last rows (the most keys) launch first. A tile whose rows and
//   keys are all live and visible skips the masks. Exact skip and fully
//   masked rows (the mean of V over all Sk keys) as the fp32 body.
// - Head dims 8 and 16 contract over k16: the pad columns of D = 8 are
//   zeroed once, before any copy. A view whose strides are not multiples of
//   8 elements is staged by element copies in a rolled loop.

// The bf16 forward's geometry at head dim D, measured against the others
// by scripts/flash_fwd_bf16_tiles.py (PERF.md §6): 64 rows a block (128
// lost at the trained shape), 64-key ring tiles (32 at D = 256, where S
// unrolls 4 of its 16 k steps per trip so that no register spills), and
// the registers held to 3 blocks per SM at D <= 64 (11% at D = 64; shared
// memory allows 2 blocks at D = 128 and 256, 4 or more below).
template <int D>
struct Bf16Fwd {
  static constexpr int DP = Bf16Rows<D>::DP;       // elements per shared row
  static constexpr int KS = Bf16Rows<D>::DK / 16;  // k16 steps of S over the head dim
  static constexpr int NT = D / 8;                 // n8 tiles of an out row
  static constexpr int BM = 64;                    // rows a block owns, a warp per 16
  static constexpr int KN = D == 256 ? 32 : 64;    // keys per ring tile
  static constexpr int NS = 2;                     // ring stages
  static constexpr bool kRegs = D <= 128;          // Q's A fragments kept in registers
  static constexpr int SU = D == 256 ? 4 : KS;     // k16 steps of S per unrolled trip
  static constexpr int kMinBlocks = D <= 64 ? 3 : 2;  // per SM the registers must allow
  static constexpr int kThreads = 2 * BM;
  static constexpr int kSmemBytes = (BM + 2 * NS * KN) * DP * 2;  // Q, then NS K and V stages
};

template <int D>
__global__ void __launch_bounds__(Bf16Fwd<D>::kThreads, Bf16Fwd<D>::kMinBlocks)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, FlashParams p) {
  using Gm = Bf16Fwd<D>;
  constexpr int DP = Gm::DP, KS = Gm::KS, NT = Gm::NT, BM = Gm::BM, KN = Gm::KN, NS = Gm::NS;
  constexpr int NA = NT < 2 ? 2 : NT;
  constexpr int kT = Gm::kThreads;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint16_t* const qs = reinterpret_cast<uint16_t*>(smem_bytes);  // Q [BM][DP]
  uint16_t* const ring = qs + BM * DP;  // stage s: K [KN][DP] at 2 s KN DP, V after it

  const int rows = p.sq * p.g;
  const int n_tiles = (rows + BM - 1) / BM;
  if (tile_order() >= n_tiles) return;
  const int r0 = (n_tiles - 1 - tile_order()) * BM;  // the last rows (most keys) first
  const int bkv = blockIdx.x;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const DivG divg(p.g);
  if (D < 16) {
    zero_smem<kT>(smem_bytes, Gm::kSmemBytes);
    __syncthreads();
  }
  const int kend = visit_end(p, divg(r0), divg(min(r0 + BM, rows) - 1));
  const int n_kt = (kend + KN - 1) / KN;

  // Q (its two halves as the row pair of one copy), then the first key
  // tiles, all by cp.async
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long kb = b * p.k_sb + h * p.k_sh, vb = b * p.v_sb + h * p.v_sh;
  const auto q_row = [&](int row) -> long long {
    if (row >= rows) return -1;
    const int s = divg(row);
    return qb + (row - s * p.g) * p.q_sg + (long long)s * p.q_ss;
  };
  copy_rows_bf16<D, BM / 2, kT>(qs, q, qs + BM / 2 * DP, q, [&](int r) -> RowPair {
    return {q_row(r0 + r), q_row(r0 + BM / 2 + r)};
  }, p.vec);
  cp_async_commit();
  const auto stage_keys = [&](int kt) {
    uint16_t* const kd = ring + (kt % NS) * 2 * KN * DP;
    const int key0 = kt * KN;
    copy_rows_bf16<D, KN, kT>(kd, k, kd + KN * DP, v, [&](int r) -> RowPair {
      const int key = key0 + r;
      if (key >= kend) return {-1, -1};  // past Sk, or seen by no row of the block
      return {kb + (long long)key * p.k_ss, vb + (long long)key * p.v_ss};
    }, p.vec);
  };
#pragma unroll
  for (int kt = 0; kt < NS - 1; ++kt) {  // the first NS - 1 key tiles, a group each
    if (kt < n_kt) stage_keys(kt);
    cp_async_commit();
  }

  // the positions of this lane's rows g and g + 8 of the warp's 16
  int qpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) qpos[hf] = p.q_offset + divg(r0 + 16 * warp + g + 8 * hf);
  // the keys below warp_lim are live and visible to all 16 rows of the warp
  // (0: some row is past Sq * G, or sees no key)
  int warp_lim = 0;
  if (r0 + 16 * warp + 16 <= rows) {
    warp_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
    if (p.causal) warp_lim = min(warp_lim, p.q_offset + divg(r0 + 16 * warp) + 1);
  }

  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int la = lane_a(lane, DP), lb = lane_b(lane, DP);
  const uint32_t qa = smem_addr(qs + 16 * warp * DP + la);
  constexpr int KR = Gm::kRegs ? KS : 1;
  uint32_t qf[KR][4];  // the warp's Q A fragments, if kept
  cp_async_wait<NS - 1>();  // Q landed (the first key tiles may be in flight)
  __syncthreads();
  if (Gm::kRegs) {
#pragma unroll
    for (int ks = 0; ks < KR; ++ks) ldmatrix_x4(qf[ks], qa + 32 * ks);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // key tile kt landed; every warp is done with tile kt - 1's stage
    if (kt + NS - 1 < n_kt) stage_keys(kt + NS - 1);
    cp_async_commit();
    const uint16_t* const kst = ring + (kt % NS) * 2 * KN * DP;
    const uint32_t kbase = smem_addr(kst), vbase = smem_addr(kst + KN * DP);

    // S = Q K^T, each k16 step into a fresh fragment
    float sc[KN / 8][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    rows_product<D, KN / 8, KR, true, Gm::SU>(sc, qf, qa, kbase + 2 * lb);

    // x = S * scale and the masks: a lane holds keys 8j + 2t + (e & 1) of
    // rows g (e < 2) and g + 8
    const int key0 = kt * KN;
    const auto scores = [&](auto whole) {
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * p.scale;
          if (!decltype(whole)::value) {
            const int kpos = key0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= p.sk)
              x = -INFINITY;  // past the keys: no part in the softmax
            else if ((p.causal && qpos[e >> 1] < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len))
              x = kNeg;
          }
          sc[j][e] = x;
        }
    };
    if (key0 + KN <= warp_lim)
      scores(std::true_type{});
    else
      scores(std::false_type{});

    // the online softmax: p = exp2((x - m) log2 e) against the running max,
    // O rescaled by alpha = exp2((m_old - m) log2 e)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(mrow[hf], mx);
      const float alpha = fast_exp2((mrow[hf] - mnew) * kLog2e);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          sc[j][e] = fast_exp2((sc[j][e] - mnew) * kLog2e);
          ps += sc[j][e];  // l sums p unrounded, as the reference does
        }
      lrow[hf] = lrow[hf] * alpha + ps;  // this lane's keys; the quad sums at the end
      mrow[hf] = mnew;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }

    // O += bf16(P) V, 16 keys per k step
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, sc[2 * kk], sc[2 * kk + 1]);
      cols_product<NT>(acc, a, vbase + 2 * (16 * kk * DP + la));
    }
  }
  cp_async_wait<0>();

  // out = O / l rounded to bf16 (element offsets oo; < 0: past Sq * G); m
  // and l by the quad's first lane
  long long oo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 1);
    lrow[hf] += __shfl_xor_sync(0xffffffffu, lrow[hf], 2);
    const float l = fmaxf(lrow[hf], 1e-30f), linv = 1.f / l;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][2 * hf] *= linv;
      acc[n][2 * hf + 1] *= linv;
    }
    const int row = r0 + 16 * warp + g + 8 * hf;
    const int s = divg(row), gg = row - s * p.g;
    oo[hf] = row < rows ? b * p.o_sb + h * p.o_sh + gg * p.o_sg + (long long)s * p.o_ss : -1;
    if (t == 0 && row < rows) {
      const long long mi = ((long long)bkv * p.g + gg) * p.sq + s;
      m_out[mi] = mrow[hf];
      l_out[mi] = l;
    }
  }
  store_rows_bf16<NT>(o, acc, oo, 1.f, t, p.vec);
}

template <int D>
int launch_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* o, float* m,
                float* l, const FlashParams& p, int nbkv, cudaStream_t stream) {
  using Gm = Bf16Fwd<D>;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem((const void*)flash_fwd_bf16_kernel<D>, Gm::kSmemBytes, allowed);
  if (e != cudaSuccess) return (int)e;
  if ((long long)p.sq * p.g > 0x7fffffffLL - Gm::BM) return (int)cudaErrorInvalidValue;
  const int n_tiles = (p.sq * p.g + Gm::BM - 1) / Gm::BM;
  flash_fwd_bf16_kernel<D><<<bf16_grid(nbkv, n_tiles), Gm::kThreads, Gm::kSmemBytes, stream>>>(
      q, k, v, o, m, l, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v, float* o, float* m, float* l,
               const FlashParams& p, int nbkv, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  const cudaError_t e = allow_smem((const void*)flash_fwd_kernel<D>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = ((long long)p.sq * p.g + kTileRows - 1) / kTileRows;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, nbkv);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, m, l, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_q8(const float* q, const int8_t* k, const int8_t* v, const float* ks,
              const float* vs, float* o, const FlashParams& p, int nbkv, cudaStream_t stream) {
  static std::atomic<int> allowed[kMaxDevices];
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  const cudaError_t e = allow_smem((const void*)flash_fwd_q8_kernel<D>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = ((long long)p.sq * p.g + kTileRows - 1) / kTileRows;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, nbkv);
  flash_fwd_q8_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, ks, vs, o, p);
  return (int)cudaGetLastError();
}

// dims: nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len (< 0: none)
// strides (elements): q b,h,g,s; k b,h,s; v b,h,s; scales b,h,s; out b,h,g,s
int read_params(FlashParams& p, int& nbkv, int& d, const int* dims, const long long* st,
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
  p.vec = 0;
  if (nbkv < 1 || nbkv > 65535 || p.nh < 1 || p.g < 1 || p.sq < 1 ||
      p.sk < 1)
    return (int)cudaErrorInvalidValue;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_sg = st[2]; p.q_ss = st[3];
  p.k_sb = st[4]; p.k_sh = st[5]; p.k_ss = st[6];
  p.v_sb = st[7]; p.v_sh = st[8]; p.v_ss = st[9];
  p.s_sb = st[10]; p.s_sh = st[11]; p.s_ss = st[12];
  p.o_sb = st[13]; p.o_sh = st[14]; p.o_sg = st[15]; p.o_ss = st[16];
  return 0;
}

// Whether 16-byte loads of q rows and stores of out (4 fp32 or 8 bf16
// elements; bf16 out stores 8 bytes), and kv_bytes-wide loads of K/V rows,
// keep their alignment: every base pointer, and every row stride (elements;
// the scales' strides aside) a multiple of `per16`, the elements in 16
// bytes of q (4 fp32, 8 bf16).
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const long long* st, unsigned kv_bytes, int per16 = 4) {
  bool ok = ((uintptr_t)q | (uintptr_t)out) % 16 == 0 &&
            ((uintptr_t)k | (uintptr_t)v) % kv_bytes == 0;
  for (int i = 0; i < 17; ++i) ok = ok && ((i >= 10 && i <= 12) || st[i] % per16 == 0);
  return ok;
}

}  // namespace

extern "C" {

// fp32 K/V -> out (q's layout), m and l (BKV, G, Sq).
int repro_flash_fwd_f32(const float* q, const float* k, const float* v, float* out,
                        float* m, float* l, const int* dims, const long long* strides,
                        float scale, void* stream) {
  FlashParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, strides, scale)) return e;
  p.vec = aligned(q, k, v, out, strides, 16);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8: return launch_f32<8>(q, k, v, out, m, l, p, nbkv, s);
    case 16: return launch_f32<16>(q, k, v, out, m, l, p, nbkv, s);
    case 32: return launch_f32<32>(q, k, v, out, m, l, p, nbkv, s);
    case 64: return launch_f32<64>(q, k, v, out, m, l, p, nbkv, s);
    case 128: return launch_f32<128>(q, k, v, out, m, l, p, nbkv, s);
    case 160: return launch_f32<160>(q, k, v, out, m, l, p, nbkv, s);
    case 256: return launch_f32<256>(q, k, v, out, m, l, p, nbkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 q, k, v -> bf16 out (q's layout), fp32 m and l (BKV, G, Sq); the
// scores are scaled by `scale` rounded to bf16, as the reference scales a
// bf16 q.
int repro_flash_fwd_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* out,
                         float* m, float* l, const int* dims, const long long* strides,
                         float scale, void* stream) {
  FlashParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, strides, bf16mma::round_bf16(scale))) return e;
  p.vec = aligned(q, k, v, out, strides, 16, 8);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8: return launch_bf16<8>(q, k, v, out, m, l, p, nbkv, s);
    case 16: return launch_bf16<16>(q, k, v, out, m, l, p, nbkv, s);
    case 32: return launch_bf16<32>(q, k, v, out, m, l, p, nbkv, s);
    case 64: return launch_bf16<64>(q, k, v, out, m, l, p, nbkv, s);
    case 128: return launch_bf16<128>(q, k, v, out, m, l, p, nbkv, s);
    case 256: return launch_bf16<256>(q, k, v, out, m, l, p, nbkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 K/V with fp32 per-position scales -> out (q's layout).
int repro_flash_fwd_q8(const float* q, const int8_t* k, const int8_t* v,
                       const float* k_scale, const float* v_scale, float* out,
                       const int* dims, const long long* strides, float scale,
                       void* stream) {
  FlashParams p;
  int nbkv = 0, d = 0;
  if (const int e = read_params(p, nbkv, d, dims, strides, scale)) return e;
  p.vec = aligned(q, k, v, out, strides, 4);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8: return launch_q8<8>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 16: return launch_q8<16>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 32: return launch_q8<32>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 64: return launch_q8<64>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 128: return launch_q8<128>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 160: return launch_q8<160>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    case 256: return launch_q8<256>(q, k, v, k_scale, v_scale, out, p, nbkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
