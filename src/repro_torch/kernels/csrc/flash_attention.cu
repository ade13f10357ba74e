// GQA flash-attention forward for Hopper (sm_90a), over an fp32 or an int8
// K/V cache.
//
// Replaces the TPU kernels
//   repro/kernels/flash_attention/kernel.py flash_fwd_pallas    -> repro_flash_fwd_f32
//   repro/kernels/flash_attention/kernel.py flash_fwd_q8_pallas -> repro_flash_fwd_q8
// with one device body instantiated for fp32 K/V and for int8 K/V with
// per-position fp32 scales, dequantized in the kernel as (float)k_q8 *
// k_scale[pos] (the product `_dequantize_kv` forms at fp32).
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
//
// Layout: the kernel reads q, k, v, the scales and writes out through element
// strides, with the bkv axis split as bkv = b * nh + h. The wrapper passes
// nh = 1 for the (BKV, G, Sq, D) / (BKV, Sk, D) layout of the Pallas kernels,
// and nh = KV for the model's (B, Sq, KV, G, D) queries over the cache's
// (B, S_max, KV, D) keys, so the decode path reads the cache in place with no
// transpose. m and l are (BKV, G, Sq), contiguous.
//
// Design for this card, and what bounds it:
// - The Pallas grid (bkv, g, q-tile, kv-tile) runs its kv axis in order,
//   carrying m, l and acc in VMEM scratch. Hopper blocks run in no order, so
//   one CUDA block owns one (bkv, q-tile) pair with ALL G groups of that kv
//   head inside (64 query rows = qt positions x G groups, qt = 64 / G), and
//   the kv axis is a loop inside the block; m, l and the output accumulator
//   live in registers. Each K/V tile is then read once per kv head and
//   q-tile, as the Pallas GQA layout intends, not once per group.
// - Skipping zero work is exact: the loop stops at the last tile holding a
//   key visible to some row of the block (kv_len, and the causal diagonal).
//   Once a row has seen one visible key its running max is a real score, so
//   a fully masked tile would add exp(-1e30 - m) = 0 and rescale by 1. The
//   skip is taken only when every row of the block sees key 0 (kv_len >= 1
//   and, under the causal mask, q_offset + first row >= 0); otherwise the
//   loop runs over all Sk keys as the reference does.
// - Ragged edges are masked here, for any Sq >= 1 and Sk >= 1: keys past Sk
//   take no part at all (score -inf, p = 0), query rows past Sq compute on
//   zeros and write nothing.
// - Shared memory: Q tile 64 x (D+4), K tile 64 x (D+4), V tile 64 x D and
//   the probability tile 64 x 80, fp32: 118 KB at D = 128, above the 48 KB
//   static limit, so it is dynamic shared memory raised with
//   cudaFuncSetAttribute. The +4 row padding makes the float4 reads of a
//   quarter warp conflict-free; the +16 on the probability tile puts the two
//   rows a warp writes in different banks.
// - 256 threads as 16 x 16: thread (ty, tx) owns query rows ty + 16i and key
//   columns tx + 16j (i, j < 4) of the score tile, and output columns
//   tx + 16j of its 4 rows. Row max and row sum reduce over the 16 lanes of
//   a half warp with xor shuffles, which leave every lane the same value.
// - One block per SM fits the shared memory at D = 128 anyway, so the
//   launch bounds ask for one resident block and leave ptxas all 255
//   registers a thread may have (with the default bound the int8 body at
//   D = 128 spilled).
// - fp32 FMA on CUDA cores (no TF32: the port holds fp32 parity), expf (no
//   fast math). At prefill the kernel is bound by the CUDA-core rate, far
//   below the card's 67 TFLOP/s fp32 peak; at decode (Sq = 1) a block holds
//   only G = 2 live rows of its 64 and the grid is B * KV blocks, so it is
//   bound by latency and underfills the card's 132 SMs. Splitting the kv axis
//   across blocks (flash-decoding) and wgmma/TMA tiles are later work.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows per block (qt positions x G groups)
constexpr int kKeys = 64;     // keys per tile
constexpr int kThreads = 256; // 16 x 16
constexpr int kPP = kKeys + 16;
constexpr float kNeg = -1e30f;

struct FlashParams {
  int nh, g, sq, sk, qt;
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale;
  long long q_sb, q_sh, q_sg, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long s_sb, s_sh, s_ss;  // k_scale / v_scale (int8 K/V only)
  long long o_sb, o_sh, o_sg, o_ss;
};

__device__ __forceinline__ float load_kv(const float* p, long long i, const float*,
                                         long long) {
  return p[i];
}
__device__ __forceinline__ float load_kv(const int8_t* p, long long i, const float* sc,
                                         long long si) {
  return (float)p[i] * sc[si];
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// KT: K/V element type (float, or int8_t with scales); D: head dim.
template <typename KT, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const KT* __restrict__ k,
                 const KT* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, FlashParams p) {
  constexpr int DP = D + 4;
  constexpr int NJ = (D + 15) / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kRows x DP
  float* Ks = Qs + kRows * DP;                  // kKeys x DP
  float* Vs = Ks + kKeys * DP;                  // kKeys x D
  float* Ps = Vs + kKeys * D;                   // kRows x kPP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int s0 = blockIdx.x * p.qt;
  const int rows = p.qt * p.g;
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long kb = b * p.k_sb + h * p.k_sh;
  const long long vb = b * p.v_sb + h * p.v_sh;
  const long long sb = b * p.s_sb + h * p.s_sh;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r / p.g, g = r % p.g;
    float x = 0.f;
    if (r < rows && s < p.sq) x = q[qb + g * p.q_sg + s * p.q_ss + d] * p.scale;
    Qs[r * DP + d] = x;
  }

  int qpos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = s0 + r / p.g;
    live[i] = r < rows && s < p.sq;
    qpos[i] = p.q_offset + s;
  }

  // the exact skip: stop after the last key some row of the block can see
  const int s_last = min(s0 + p.qt, p.sq) - 1;
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  int kend = p.sk;
  if (kv_lim > 0 && (!p.causal || p.q_offset + s0 >= 0)) {
    kend = kv_lim;
    if (p.causal) kend = min(kend, p.q_offset + s_last + 1);
  }
  const int ntiles = (kend + kKeys - 1) / kKeys;

  float mrow[4], lrow[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = kNeg;
    lrow[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the Q tile is written / the last tile's reads are done
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int pos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < p.sk) {
        kx = load_kv(k, kb + pos * p.k_ss + d, ks, sb + pos * p.s_ss);
        vx = load_kv(v, vb + pos * p.v_ss + d, vs, sb + pos * p.s_ss);
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qa[i].x, kf[j].x, a);
          a = fmaf(qa[i].y, kf[j].y, a);
          a = fmaf(qa[i].z, kf[j].z, a);
          a = fmaf(qa[i].w, kf[j].w, a);
          sc[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j];
        if (kpos >= p.sk)
          x = -INFINITY;  // past the keys: no part in the softmax
        else if ((p.causal && qpos[i] < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len))
          x = kNeg;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float mnew = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - mnew);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - mnew);
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = e;
        ps += e;
      }
      ps = half_warp_sum(ps);
      lrow[i] = lrow[i] * alpha + ps;
      mrow[i] = mnew;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int nk = min(kKeys, p.sk - k0);
    for (int c = 0; c < nk; ++c) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        vv[jj] = col < D ? Vs[c * D + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * kPP + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = ty + 16 * i;
    const int s = s0 + r / p.g, g = r % p.g;
    const float l = fmaxf(lrow[i], 1e-30f);
    const long long ob = b * p.o_sb + h * p.o_sh + g * p.o_sg + s * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < D) o[ob + col] = acc[i][jj] / l;
    }
    if (tx == 0 && m_out != nullptr) {
      const long long idx = ((long long)bkv * p.g + g) * p.sq + s;
      m_out[idx] = mrow[i];
      l_out[idx] = l;
    }
  }
}

template <typename KT, int D>
int launch_d(const float* q, const KT* k, const KT* v, const float* ks,
             const float* vs, float* o, float* m, float* l, const FlashParams& p,
             int nbkv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(kRows * (D + 4) + kKeys * (D + 4) + kKeys * D + kRows * kPP);
  // set on every launch: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<KT, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.sq + p.qt - 1) / p.qt, nbkv);
  flash_fwd_kernel<KT, D><<<grid, kThreads, smem, stream>>>(q, k, v, ks, vs, o, m, l, p);
  return (int)cudaGetLastError();
}

// dims: nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len (< 0: none)
// strides (elements): q b,h,g,s; k b,h,s; v b,h,s; scales b,h,s; out b,h,g,s
template <typename KT>
int launch(const float* q, const KT* k, const KT* v, const float* ks, const float* vs,
           float* o, float* m, float* l, const int* dims, const long long* st,
           float scale, cudaStream_t stream) {
  FlashParams p;
  const int nbkv = dims[0];
  p.nh = dims[1];
  p.g = dims[2];
  p.sq = dims[3];
  p.sk = dims[4];
  const int d = dims[5];
  p.causal = dims[6];
  p.q_offset = dims[7];
  p.kv_len = dims[8];
  p.scale = scale;
  if (nbkv < 1 || nbkv > 65535 || p.nh < 1 || p.g < 1 || p.g > kRows || p.sq < 1 ||
      p.sk < 1)
    return (int)cudaErrorInvalidValue;
  p.qt = kRows / p.g;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_sg = st[2]; p.q_ss = st[3];
  p.k_sb = st[4]; p.k_sh = st[5]; p.k_ss = st[6];
  p.v_sb = st[7]; p.v_sh = st[8]; p.v_ss = st[9];
  p.s_sb = st[10]; p.s_sh = st[11]; p.s_ss = st[12];
  p.o_sb = st[13]; p.o_sh = st[14]; p.o_sg = st[15]; p.o_ss = st[16];
  switch (d) {
    case 8: return launch_d<KT, 8>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    case 16: return launch_d<KT, 16>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    case 32: return launch_d<KT, 32>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    case 64: return launch_d<KT, 64>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    case 128: return launch_d<KT, 128>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    case 256: return launch_d<KT, 256>(q, k, v, ks, vs, o, m, l, p, nbkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fp32 K/V -> out (q's layout), m and l (BKV, G, Sq).
int repro_flash_fwd_f32(const float* q, const float* k, const float* v, float* out,
                        float* m, float* l, const int* dims, const long long* strides,
                        float scale, void* stream) {
  return launch<float>(q, k, v, nullptr, nullptr, out, m, l, dims, strides, scale,
                       (cudaStream_t)stream);
}

// int8 K/V with fp32 per-position scales -> out (q's layout).
int repro_flash_fwd_q8(const float* q, const int8_t* k, const int8_t* v,
                       const float* k_scale, const float* v_scale, float* out,
                       const int* dims, const long long* strides, float scale,
                       void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, nullptr, nullptr, dims, strides,
                        scale, (cudaStream_t)stream);
}

}  // extern "C"
