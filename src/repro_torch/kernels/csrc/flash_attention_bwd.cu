// GQA flash-attention backward for Hopper (sm_90a): the two passes of the
// reference's two-pass flash backward.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// flash_bwd_pallas, one entry point per pallas_call site:
//   :265 (_dq_kernel)  -> repro_flash_bwd_dq_f32
//   :284 (_dkv_kernel) -> repro_flash_bwd_dkv_f32
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
// reference, because the mask is -1e30 and not -inf.
//
// Layout: q, do and dq are read / written through (b, h, g, s) element
// strides, k, v, dk and dv through (b, h, s) strides, with bkv = b * nh + h
// (nh = 1 for the (BKV, G, Sq, D) / (BKV, Sk, D) layout of the Pallas kernels,
// nh = KV for the model's (B, Sq, KV, G, D) / (B, Sk, KV, D)); the head dim is
// contiguous. m, l and delta are (BKV, G, Sq), contiguous.
//
// Design for this card, and what bounds it:
// - The Pallas dq grid (bkv, g, q-tile, kv-tile) runs its kv axis in order
//   with dq accumulated in VMEM. Here one block owns one (bkv, 64 query rows)
//   pair with ALL G groups of the kv head inside (rows = qt positions x G
//   groups, qt = 64 / G), the kv loop runs inside the
//   block, and dq accumulates in registers; it is scaled once at the end.
// - The Pallas dk/dv grid (bkv, kv-tile, g, q-tile) accumulates over its last
//   two axes in order. Here one block owns one (bkv, key tile) pair and loops
//   over every query tile of all G groups itself, so its dk/dv tile has one
//   owner: no atomics, no second pass, and a deterministic sum order.
// - Exact skipping only. Once a row has seen one visible key its m is a real
//   score, so a masked key gives p = exp(-1e30 - m) = 0 and adds nothing to
//   any of dq, dk, dv. Tiles are skipped only when every row of the call sees
//   key 0 (kv_len >= 1 and, under the causal mask, the first row's qpos >= 0):
//   the dq pass stops after the last key its rows can see (kv_len, causal
//   diagonal), the dk/dv pass starts at the first query tile that can see
//   its key tile (causal) and writes zeros for a key tile wholly past kv_len.
//   Otherwise every tile is visited, as the reference does.
// - Ragged edges are masked here for any Sq >= 1 and Sk >= 1: keys past Sk
//   have p = 0, query rows past Sq compute on zeros and write nothing.
// - Shared memory (fp32, rows padded by 4 floats so that the float4 reads of
//   a quarter warp are conflict-free; p / ds tiles padded by 16 so the two
//   rows a warp writes fall in different banks): dq pass Q, dO (64 x D+4),
//   K, V (KK x D+4) and ds (64 x KK+16): 152 KB at D = 128; dk/dv pass K, V,
//   Q, dO, p and ds and the rows' m, l, delta: 172 KB at D = 128. At D = 256
//   both take a 32-key tile (KK = 32, a template parameter): 207 / 220 KB,
//   under the 227 KB a block may have. Dynamic shared memory, raised with
//   cudaFuncSetAttribute on every launch.
// - 256 threads as 16 x 16. Score-shaped tiles (64 rows x KK keys): thread
//   (ty, tx) owns rows ty + 16i and keys tx + 16j. dq: rows ty + 16i and
//   columns tx + 16j of D. dk/dv: keys ty + 16i and columns tx + 16j, summed
//   over the 64 rows of each query tile in turn.
// - fp32 FMA on CUDA cores (no TF32: the port holds fp32 parity), expf and a
//   true division (no fast math). Work is 6 (dq) and 8 (dk/dv) flops per
//   visible (q, k) pair and head-dim element, against a bound of 10 for the
//   whole backward; each inner step issues 8 shared 16-byte loads per 32
//   FMAs, so the kernels are bound by shared-memory bandwidth well below the
//   card's 67 TFLOP/s fp32 peak. wgmma / TMA tiles are later work.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // query rows per tile (qt positions x G groups)
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;

struct BwdParams {
  int nh, g, sq, sk, qt;
  int causal, q_offset, kv_len;  // kv_len < 0: no kv_len mask
  float scale;
  long long q_sb, q_sh, q_sg, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_sg, do_ss;
  long long dq_sb, dq_sh, dq_sg, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
};

// Key tile per head dim: 64 keys, 32 at D = 256 to fit shared memory.
template <int D>
struct KeyTile {
  static constexpr int value = D == 256 ? 32 : 64;
};

// rows [0, 64) of query tile s0 -> shared memory (pitch D + 4), times mul;
// rows past the tile's G * qt or past Sq are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long base,
                                          long long sg, long long ss, int s0,
                                          const BwdParams& p, float mul) {
  constexpr int DP = D + 4;
  const int rows = p.qt * p.g;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = s0 + r / p.g, g = r % p.g;
    float x = 0.f;
    if (r < rows && s < p.sq) x = src[base + g * sg + s * ss + d] * mul;
    dst[r * DP + d] = x;
  }
}

// keys [k0, k0 + KK) -> shared memory (pitch D + 4); keys past Sk are zero.
template <int D, int KK>
__device__ __forceinline__ void load_keys(float* dst, const float* src, long long base,
                                          long long ss, int k0, int sk) {
  constexpr int DP = D + 4;
  for (int i = threadIdx.x; i < KK * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const int pos = k0 + c;
    dst[c * DP + d] = pos < sk ? src[base + pos * ss + d] : 0.f;
  }
}

// acc[i][j] = A[ty + 16i, :] . B[tx + 16j, :] over D (both pitch D + 4).
template <int D, int NC>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ty, int tx,
                                         float (&acc)[4][NC]) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * DP + d]);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * DP + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        acc[i][j] = x;
      }
  }
}

// p for one (row, key): 0 past Sk or on a dead row, else exp(masked s - m) / l.
__device__ __forceinline__ float prob(float s, int qpos, int kpos, float m, float l,
                                      bool live, const BwdParams& p) {
  if (!live || kpos >= p.sk) return 0.f;
  if ((p.causal && qpos < kpos) || (p.kv_len >= 0 && kpos >= p.kv_len)) s = kNeg;
  return expf(s - m) / l;
}

// true when every row of the call sees key 0: the tile skips are then exact
__device__ __forceinline__ bool skip_is_exact(const BwdParams& p, int first_s) {
  const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
  return kv_lim > 0 && (!p.causal || p.q_offset + first_s >= 0);
}

// ---------------------------------------------------------------------------
// dq pass: one block per (bkv, 64 query rows), the kv loop inside
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    BwdParams p) {
  constexpr int KK = KeyTile<D>::value;
  constexpr int DP = D + 4;
  constexpr int NC = KK / 16;
  constexpr int NJ = (D + 15) / 16;
  constexpr int PP = KK + 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kRows x DP, pre-scaled q
  float* Ds = Qs + kRows * DP;                  // kRows x DP, do
  float* Ks = Ds + kRows * DP;                  // KK x DP
  float* Vs = Ks + KK * DP;                     // KK x DP
  float* Ss = Vs + KK * DP;                     // kRows x PP, ds

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int s0 = blockIdx.x * p.qt;
  const int rows = p.qt * p.g;
  const long long kb = b * p.k_sb + h * p.k_sh;
  const long long vb = b * p.v_sb + h * p.v_sh;

  load_rows<D>(Qs, q, b * p.q_sb + h * p.q_sh, p.q_sg, p.q_ss, s0, p, p.scale);
  load_rows<D>(Ds, dout, b * p.do_sb + h * p.do_sh, p.do_sg, p.do_ss, s0, p, 1.f);

  int qpos[4];
  bool live[4];
  float mrow[4], lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = s0 + r / p.g, g = r % p.g;
    live[i] = r < rows && s < p.sq;
    qpos[i] = p.q_offset + s;
    const long long idx = ((long long)bkv * p.g + g) * p.sq + s;
    mrow[i] = live[i] ? m_in[idx] : 0.f;
    lrow[i] = live[i] ? fmaxf(l_in[idx], 1e-30f) : 1.f;
    drow[i] = live[i] ? delta[idx] : 0.f;
  }

  // the exact skip: stop after the last key some row of the block can see
  int kend = p.sk;
  if (skip_is_exact(p, 0)) {
    const int s_last = min(s0 + p.qt, p.sq) - 1;
    kend = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
    if (p.causal) kend = max(0, min(kend, p.q_offset + s_last + 1));
  }
  const int ntiles = (kend + KK - 1) / KK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KK;
    __syncthreads();  // the Q / dO tiles are written; the last tile's reads are done
    load_keys<D, KK>(Ks, k, kb, p.k_ss, k0, p.sk);
    load_keys<D, KK>(Vs, v, vb, p.v_ss, k0, p.sk);
    __syncthreads();

    float sc[4][NC], dp[4][NC];
    tile_dot<D, NC>(Qs, Ks, ty, tx, sc);
    tile_dot<D, NC>(Ds, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float pr =
            prob(sc[i][j], qpos[i], k0 + tx + 16 * j, mrow[i], lrow[i], live[i], p);
        Ss[(ty + 16 * i) * PP + tx + 16 * j] = pr * (dp[i][j] - drow[i]);
      }
    __syncthreads();

    const int nk = min(KK, p.sk - k0);
    for (int c = 0; c < nk; ++c) {
      float kv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        kv[jj] = col < D ? Ks[c * DP + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(ds, kv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = ty + 16 * i;
    const int s = s0 + r / p.g, g = r % p.g;
    const long long ob = b * p.dq_sb + h * p.dq_sh + g * p.dq_sg + s * p.dq_ss;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < D) dq[ob + col] = acc[i][jj] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv pass: one block per (bkv, key tile), every group and query tile inside
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, BwdParams p) {
  constexpr int KK = KeyTile<D>::value;
  constexpr int DP = D + 4;
  constexpr int NC = KK / 16;  // keys per thread: score tiles, and dk/dv rows
  constexpr int NJ = (D + 15) / 16;
  constexpr int PP = KK + 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // KK x DP
  float* Vs = Ks + KK * DP;                     // KK x DP
  float* Qs = Vs + KK * DP;                     // kRows x DP, pre-scaled q
  float* Ds = Qs + kRows * DP;                  // kRows x DP, do
  float* Ps = Ds + kRows * DP;                  // kRows x PP, p
  float* Ss = Ps + kRows * PP;                  // kRows x PP, ds
  float* Ms = Ss + kRows * PP;                  // kRows: m, l, delta of the rows
  float* Ls = Ms + kRows;
  float* Dl = Ls + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y;
  const int b = bkv / p.nh, h = bkv % p.nh;
  const int k0 = blockIdx.x * KK;
  const int rows = p.qt * p.g;
  const long long qb = b * p.q_sb + h * p.q_sh;
  const long long dob = b * p.do_sb + h * p.do_sh;

  load_keys<D, KK>(Ks, k, b * p.k_sb + h * p.k_sh, p.k_ss, k0, p.sk);
  load_keys<D, KK>(Vs, v, b * p.v_sb + h * p.v_sh, p.v_ss, k0, p.sk);

  // the exact skip: from the first query tile that can see this key tile
  // (causal), none when the tile lies wholly past kv_len
  const int nqt = (p.sq + p.qt - 1) / p.qt;
  int t_begin = 0, t_end = nqt;
  if (skip_is_exact(p, 0)) {
    const int kv_lim = p.kv_len < 0 ? p.sk : min(p.kv_len, p.sk);
    if (k0 >= kv_lim)
      t_end = 0;
    else if (p.causal)
      t_begin = min(nqt, max(0, k0 - p.q_offset) / p.qt);
  }

  float dk_acc[NC][NJ], dv_acc[NC][NJ];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int s0 = t * p.qt;
    __syncthreads();  // K / V are written; the last query tile's reads are done
    load_rows<D>(Qs, q, qb, p.q_sg, p.q_ss, s0, p, p.scale);
    load_rows<D>(Ds, dout, dob, p.do_sg, p.do_ss, s0, p, 1.f);
    if (tid < kRows) {
      const int s = s0 + tid / p.g, g = tid % p.g;
      const bool lv = tid < rows && s < p.sq;
      const long long idx = ((long long)bkv * p.g + g) * p.sq + s;
      Ms[tid] = lv ? m_in[idx] : 0.f;
      Ls[tid] = lv ? fmaxf(l_in[idx], 1e-30f) : 1.f;
      Dl[tid] = lv ? delta[idx] : 0.f;
    }
    __syncthreads();

    float sc[4][NC], dp[4][NC];
    tile_dot<D, NC>(Qs, Ks, ty, tx, sc);
    tile_dot<D, NC>(Ds, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int s = s0 + r / p.g;
      const bool lv = r < rows && s < p.sq;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float pr = prob(sc[i][j], p.q_offset + s, k0 + tx + 16 * j, Ms[r], Ls[r],
                              lv, p);
        Ps[r * PP + tx + 16 * j] = pr;
        Ss[r * PP + tx + 16 * j] = pr * (dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      float qv[NJ], dov[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        qv[jj] = col < D ? Qs[r * DP + col] : 0.f;
        dov[jj] = col < D ? Ds[r * DP + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float pv = Ps[r * PP + ty + 16 * i];
        const float sv = Ss[r * PP + ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          dv_acc[i][jj] = fmaf(pv, dov[jj], dv_acc[i][jj]);
          dk_acc[i][jj] = fmaf(sv, qv[jj], dk_acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int pos = k0 + ty + 16 * i;
    if (pos >= p.sk) continue;
    const long long kob = b * p.dk_sb + h * p.dk_sh + pos * p.dk_ss;
    const long long vob = b * p.dv_sb + h * p.dv_sh + pos * p.dv_ss;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < D) {
        dk[kob + col] = dk_acc[i][jj];
        dv[vob + col] = dv_acc[i][jj];
      }
    }
  }
}

template <int D>
size_t dq_smem() {
  constexpr int KK = KeyTile<D>::value;
  return sizeof(float) * (size_t)(2 * kRows * (D + 4) + 2 * KK * (D + 4) + kRows * (KK + 16));
}

template <int D>
size_t dkv_smem() {
  constexpr int KK = KeyTile<D>::value;
  return sizeof(float) *
         (size_t)(2 * KK * (D + 4) + 2 * kRows * (D + 4) + 2 * kRows * (KK + 16) + 3 * kRows);
}

struct Operands {
  const float *q, *k, *v, *dout, *m, *l, *delta;
  float *dq, *dk, *dv;
};

template <int D>
int launch_d(const Operands& o, const BwdParams& p, int nbkv, bool dkv_pass,
             cudaStream_t stream) {
  constexpr int KK = KeyTile<D>::value;
  if (dkv_pass) {
    const size_t smem = dkv_smem<D>();
    // set on every launch: the attribute belongs to the current device
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.sk + KK - 1) / KK, nbkv);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dk, o.dv, p);
  } else {
    const size_t smem = dq_smem<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.sq + p.qt - 1) / p.qt, nbkv);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        o.q, o.k, o.v, o.dout, o.m, o.l, o.delta, o.dq, p);
  }
  return (int)cudaGetLastError();
}

// dims: nbkv, nh, g, sq, sk, d, causal, q_offset, kv_len (< 0: none)
// strides (elements): q b,h,g,s; k b,h,s; v b,h,s; do b,h,g,s; dq b,h,g,s;
// dk b,h,s; dv b,h,s
int launch(const Operands& o, const int* dims, const long long* st, float scale,
           bool dkv_pass, cudaStream_t stream) {
  BwdParams p;
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
  p.do_sb = st[10]; p.do_sh = st[11]; p.do_sg = st[12]; p.do_ss = st[13];
  p.dq_sb = st[14]; p.dq_sh = st[15]; p.dq_sg = st[16]; p.dq_ss = st[17];
  p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
  p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
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

}  // extern "C"
