// Mamba selective scan for Hopper (sm_90a): jamba's recurrence, from the
// scan through the D skip and the SiLU(z) gate, in one launch, and its
// backward.
//
// Replaces no pallas_call site. The reference runs this region as a jnp
// `lax.scan` over time (repro/models/ssm.py:78-112, `mamba_block`), which
// computes the function of upstream Mamba's `selective_scan_fn(u, delta, A,
// B, C, D, z)` with delta's softplus already applied, and differentiates it
// with JAX's autodiff. Entry points:
//   repro_selective_scan_f32 / _bf16       forward, fp32 or bf16 activations
//   repro_selective_scan_bwd_f32 / _bf16   backward
// The state, A, B, C and h0 are fp32 in both; x, dt, z, D, out (and dout,
// dx, ddt, dz, dD) are in the activation type.
//
// Forward, for every batch b and channel d, with the fp32 state h[n],
// n < N, starting at h0[b, d, :]:
//   for t in 0 .. S-1:
//     u     = dt[b,t,d] * x[b,t,d]            (rounded to bf16 for bf16)
//     h[n]  = exp(dt[b,t,d] * A[d,n]) * h[n] + u * B[b,t,n]
//     y     = sum_n h[n] * C[b,t,n]
//     out[b,t,d] = (y + x[b,t,d] * D[d]) * silu(z[b,t,d])
// and h_last[b, d, :] = h after step S-1. For bf16 activations it rounds
// where the reference rounds (ssm.py:81, 110-112): u, then y, x * D, their
// sum, silu(z) and the product, each to bf16 (to nearest, ties to even).
// `expf`, not `__expf`, and no fast math.
//
// Backward, from dout and dh_last (the gradient of h_last), the reverse walk
// of the same recurrence with the rounded values the forward used and
// every gradient in fp32 (rounded once to its type at the end):
//   dt1 = dout * silu(z), dz = dout * t1 * silu'(z) (t1 = y + x D),
//   dD += dt1 x, dx = dt1 D, then for t = S-1 .. 0:
//     dh[n] += dt1 * C[t,n];  dC[t,n] = sum_d dt1 * h_t[n];
//     du = sum_n dh[n] B[t,n];  dB[t,n] = sum_d dh[n] u;
//     g[n] = dh[n] h_{t-1}[n] exp(dt A[n]);  dA[n] += g[n] dt;
//     ddt = sum_n g[n] A[n] + du x;  dx += du dt;  dh[n] *= exp(dt A[n]),
// and dh0 = dh at the end. dA and dD sum over the batch, dB and dC over the
// channels. Limits against the plain versions (`selective_scan_plain`, the
// reference's tensor ops step by step; `selective_scan_bwd_plain`, the walk
// above as tensor ops): fp32 1e-4 * max|plain| + 1e-5 * min(1, max|plain|),
// the port's fp32 rule (the sums over N and over channels in another order,
// products contracted into FMAs); bf16 2^-7 * max|plain|.
//
// Layout: forward: x, dt, z (B, S, di) and B, C (B, S, N) are read through
// element strides of their batch and time dims with a contiguous last dim,
// so the model's views (z is the second half of the in-projection's output,
// B and C slices of the x-projection's) are read in place. A (di, N), D
// (di,) and h0 (B, di, N) are contiguous (h0 may be a layer's slot of the
// stacked state); out (B, S, di) and h_last (B, di, N) are the wrapper's
// contiguous outputs. Backward: every operand and output contiguous.
// Instantiated at N = 8 (reduced jamba) and 16 (full width).
//
// What bounds it on this card (3.35 TB/s; 67 TFLOP/s fp32): bytes. At the
// served prefill of full-width jamba (B 4, S 32, di 8192, N 16) the forward
// reads x, dt, z (12.6 MB), A and the state (2.6 MB) and writes out and the
// state (6.3 MB) against ~0.13 GFLOP: ~6 us. A decode step (S 1) moves the
// (B, di, N) state in and out, 2 x 2.1 MB, and A: ~1.4 us. The backward
// reads x, dt, z, dout and B, C once and writes dx, ddt, dz, dB, dC, dA, dD
// and dh0 once: at full-width training (B 4, S 128, fp32) 67 MB, ~20 us,
// against ~0.5 GFLOP (three forward walks and the reverse one, ~60 fp32
// operations and 3 exp per state and step).
//
// Design (a first kernel that is right):
// - One thread owns one (b, d) channel and holds its N states and its row
//   of A in registers for the whole sequence: the state never touches
//   device memory between steps (the reference's §Perf note, ssm.py:84-88).
// - A block covers 128 consecutive d of one b, so the per-step loads of x,
//   dt and z and the store of out are coalesced along d. Full-width
//   prefill and decode are 4 x 8192 / 128 = 256 blocks on 132 SMs.
// - B[b, t, :] and C[b, t, :] are shared by all the block's channels: the
//   block stages them for a chunk of kChunk steps in shared memory (4 KB at
//   N = 16) and every thread reads them from there.
// - Backward: the state is recomputed, not saved by the forward (the served
//   launch stays as it is): a first walk keeps h at the start of every
//   chunk of kChunk steps (scratch (B, chunks, N, di), coalesced along d);
//   then, chunk by chunk from the last, a walk from that checkpoint keeps
//   the chunk's states in the thread's local memory (kChunk x N fp32) and
//   the reverse walk over the chunk reads them. dB and dC are summed over
//   each warp's 32 channels by shuffles (the same order in every run) into
//   per-warp partials (warps, B, S, 2N); dA and dD per (b, d) into (B, N,
//   di) and (B, di). Small second kernels add the partials up in a fixed
//   order: no atomics, so a repeat is bitwise the same.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps whose B and C a block stages at once
constexpr int kWarps = kThreads / 32;

struct ScanParams {
  int s, di;
  long long x_sb, x_st, dt_sb, dt_st, z_sb, z_st, b_sb, b_st, c_sb, c_st;
};

// AT: the activation type (float, or uint16_t holding bf16 bits).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// x rounded to bf16 (to nearest, ties to even) and widened, for bf16
// activations; x itself for fp32 ones.
template <typename AT>
__device__ __forceinline__ float act(float x) {
  if constexpr (std::is_same<AT, float>::value) {
    return x;
  } else {
    uint32_t u = __float_as_uint(x);
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
  }
}

__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put(uint16_t* dst, float x) {
  *dst = (uint16_t)(__float_as_uint(act<uint16_t>(x)) >> 16);
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// (y + x * D), rounded as the reference rounds for bf16 activations.
template <typename AT>
__device__ __forceinline__ float skip(float y, float xv, float dd) {
  if constexpr (std::is_same<AT, float>::value) {
    return y + xv * dd;
  } else {
    return act<AT>(act<AT>(y) + act<AT>(xv * dd));
  }
}

template <typename AT, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const AT* __restrict__ x, const AT* __restrict__ dt,
                          const AT* __restrict__ z, const float* __restrict__ bm,
                          const float* __restrict__ cm, const float* __restrict__ a,
                          const AT* __restrict__ dskip, const float* __restrict__ h0,
                          AT* __restrict__ out, float* __restrict__ h_last, ScanParams p) {
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < p.di;
  float h[N], av[N], dd = 0.f;
  const long long hrow = ((long long)b * p.di + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[hrow + n] : 0.f;
    av[n] = live ? a[(long long)d * N + n] : 0.f;
  }
  if (live) dd = widen(dskip[d]);
  const AT* xb = x + b * p.x_sb + d;
  const AT* dtb = dt + b * p.dt_sb + d;
  const AT* zb = z + b * p.z_sb + d;
  AT* ob = out + ((long long)b * p.s) * p.di + d;
  for (int t0 = 0; t0 < p.s; t0 += kChunk) {
    const int tn = min(kChunk, p.s - t0);
    __syncthreads();  // the previous chunk's B and C are no longer read
    for (int i = threadIdx.x; i < tn * N; i += kThreads) {
      const int t = i / N, n = i % N;
      sb[t][n] = bm[b * p.b_sb + (long long)(t0 + t) * p.b_st + n];
      sc[t][n] = cm[b * p.c_sb + (long long)(t0 + t) * p.c_st + n];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < tn; ++t) {
        const long long tt = t0 + t;
        const float xv = widen(xb[tt * p.x_st]);
        const float dtv = widen(dtb[tt * p.dt_st]);
        const float zv = widen(zb[tt * p.z_st]);
        const float dx = act<AT>(dtv * xv);
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dtv * av[n]) * h[n] + dx * sb[t][n];
          y += h[n] * sc[t][n];
        }
        put(ob + tt * p.di, skip<AT>(y, xv, dd) * act<AT>(silu(zv)));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[hrow + n] = h[n];
  }
}

template <typename AT, int N>
int launch_scan(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
                const float* a, const AT* dskip, const float* h0, AT* out, float* h_last,
                const ScanParams& p, int nb, cudaStream_t stream) {
  dim3 grid((unsigned)((p.di + kThreads - 1) / kThreads), nb);
  selective_scan_kernel<AT, N><<<grid, kThreads, 0, stream>>>(x, dt, z, bm, cm, a, dskip, h0,
                                                              out, h_last, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdParams {
  int nb, s, di, nch;  // nch: chunks of kChunk steps
};

// B and C of steps t0 .. t0 + tn - 1 of batch element b into shared memory.
template <int N>
__device__ __forceinline__ void stage_bc(float (*sb)[N], float (*sc)[N],
                                         const float* __restrict__ bm,
                                         const float* __restrict__ cm, int b, int t0, int tn,
                                         const BwdParams& p) {
  __syncthreads();  // the previous chunk's B and C are no longer read
  for (int i = threadIdx.x; i < tn * N; i += kThreads) {
    const int t = i / N, n = i % N;
    const long long src = ((long long)b * p.s + t0 + t) * N + n;
    sb[t][n] = bm[src];
    sc[t][n] = cm[src];
  }
  __syncthreads();
}

template <typename AT, int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(const AT* __restrict__ x, const AT* __restrict__ dt,
                              const AT* __restrict__ z, const float* __restrict__ bm,
                              const float* __restrict__ cm, const float* __restrict__ a,
                              const AT* __restrict__ dskip, const float* __restrict__ h0,
                              const AT* __restrict__ dout, const float* __restrict__ dh_last,
                              AT* __restrict__ dx, AT* __restrict__ ddt, AT* __restrict__ dz,
                              float* __restrict__ dh0, float* __restrict__ ck,
                              float* __restrict__ pbc, float* __restrict__ pa,
                              float* __restrict__ pd, BwdParams p) {
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int w = d >> 5;  // this warp's slot among the partials
  const bool live = d < p.di;
  const long long hrow = ((long long)b * p.di + d) * N;
  const long long row = (long long)b * p.s * p.di + d;  // (b, t = 0, d)
  float h[N], av[N], dd = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[hrow + n] : 0.f;
    av[n] = live ? a[(long long)d * N + n] : 0.f;
  }
  if (live) dd = widen(dskip[d]);

  // walk 1: the state at the start of every chunk
  for (int c = 0; c < p.nch; ++c) {
    const int t0 = c * kChunk, tn = min(kChunk, p.s - t0);
    if (live) {
#pragma unroll
      for (int n = 0; n < N; ++n) ck[(((long long)b * p.nch + c) * N + n) * p.di + d] = h[n];
    }
    stage_bc<N>(sb, sc, bm, cm, b, t0, tn, p);
    if (live) {
      for (int t = 0; t < tn; ++t) {
        const long long i = row + (long long)(t0 + t) * p.di;
        const float xv = widen(x[i]), dtv = widen(dt[i]);
        const float u = act<AT>(dtv * xv);
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = expf(dtv * av[n]) * h[n] + u * sb[t][n];
      }
    }
  }

  float dh[N], dA[N], dD = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    dh[n] = live ? dh_last[hrow + n] : 0.f;
    dA[n] = 0.f;
  }
  float hist[kChunk][N];  // the chunk's states, in local memory
  for (int c = p.nch - 1; c >= 0; --c) {
    const int t0 = c * kChunk, tn = min(kChunk, p.s - t0);
    stage_bc<N>(sb, sc, bm, cm, b, t0, tn, p);
    float hs[N];  // the state before the chunk
#pragma unroll
    for (int n = 0; n < N; ++n) {
      hs[n] = live ? ck[(((long long)b * p.nch + c) * N + n) * p.di + d] : 0.f;
      h[n] = hs[n];
    }
    // walk 2: the chunk's states again, kept
    for (int t = 0; t < tn; ++t) {
      float xv = 0.f, dtv = 0.f;
      if (live) {
        const long long i = row + (long long)(t0 + t) * p.di;
        xv = widen(x[i]);
        dtv = widen(dt[i]);
      }
      const float u = act<AT>(dtv * xv);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * av[n]) * h[n] + u * sb[t][n];
        hist[t][n] = h[n];
      }
    }
    // the reverse walk over the chunk
    for (int t = tn - 1; t >= 0; --t) {
      const long long i = row + (long long)(t0 + t) * p.di;
      float xv = 0.f, dtv = 0.f, zv = 0.f, gv = 0.f;
      if (live) {
        xv = widen(x[i]);
        dtv = widen(dt[i]);
        zv = widen(z[i]);
        gv = widen(dout[i]);
      }
      const float u = act<AT>(dtv * xv);
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) y += hist[t][n] * sc[t][n];
      const float t1 = skip<AT>(y, xv, dd);
      const float sig = 1.f / (1.f + expf(-zv));
      const float dt1 = gv * act<AT>(silu(zv));
      const float dzv = gv * t1 * (sig * (1.f + zv * (1.f - sig)));
      dD += dt1 * xv;
      float dxv = dt1 * dd, du = 0.f, ddtv = 0.f;
      float part[2 * N];  // this channel's dB (n < N) and dC (N + n)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = t > 0 ? hist[t - 1][n] : hs[n];
        dh[n] += dt1 * sc[t][n];
        part[N + n] = dt1 * hist[t][n];
        du += dh[n] * sb[t][n];
        part[n] = dh[n] * u;
        const float da = expf(dtv * av[n]);
        const float g = dh[n] * hp * da;
        dA[n] += g * dtv;
        ddtv += g * av[n];
        dh[n] *= da;
      }
      ddtv += du * xv;
      dxv += du * dtv;
      if (live) {
        put(dx + i, dxv);
        put(ddt + i, ddtv);
        put(dz + i, dzv);
      }
      // dB and dC summed over the warp's channels (every lane ends with the
      // same sums); lane j < 2N writes sum j
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < 2 * N; ++j) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * N; ++j)
        if (lane == j) mine = part[j];
      if (lane < 2 * N)
        pbc[(((long long)w * p.nb + b) * p.s + t0 + t) * (2 * N) + lane] = mine;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      dh0[hrow + n] = dh[n];
      pa[((long long)b * N + n) * p.di + d] = dA[n];
    }
    pd[(long long)b * p.di + d] = dD;
  }
}

// dB and dC (B, S, N): the warps' partials added in warp order.
template <int N>
__global__ void scan_bwd_reduce_bc(const float* __restrict__ pbc, float* __restrict__ db,
                                   float* __restrict__ dc, int nw, long long m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // (b, t, j)
  if (i >= m) return;
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += pbc[w * m + i];
  const long long bt = i / (2 * N);
  const int j = (int)(i - bt * 2 * N);
  if (j < N)
    db[bt * N + j] = s;
  else
    dc[bt * N + j - N] = s;
}

// dA (di, N) and dD (di,): the batch elements' partials added in order.
template <typename AT, int N>
__global__ void scan_bwd_reduce_ad(const float* __restrict__ pa, const float* __restrict__ pd,
                                   float* __restrict__ da, AT* __restrict__ dd, int nb,
                                   int di) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= di) return;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += pa[((long long)b * N + n) * di + d];
    da[(long long)d * N + n] = s;
  }
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += pd[(long long)b * di + d];
  put(dd + d, s);
}

template <typename AT, int N>
int launch_scan_bwd(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
                    const float* a, const AT* dskip, const float* h0, const AT* dout,
                    const float* dh_last, AT* dx, AT* ddt, AT* dz, float* dh0, float* ck,
                    float* pbc, float* pa, float* pd, float* db, float* dc, float* da, AT* dd,
                    const BwdParams& p, cudaStream_t stream) {
  const int nblk = (p.di + kThreads - 1) / kThreads;
  selective_scan_bwd_kernel<AT, N><<<dim3(nblk, p.nb), kThreads, 0, stream>>>(
      x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz, dh0, ck, pbc, pa, pd, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long m = (long long)p.nb * p.s * 2 * N;
  scan_bwd_reduce_bc<N><<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(pbc, db, dc,
                                                                         nblk * kWarps, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_bwd_reduce_ad<AT, N><<<(unsigned)((p.di + 127) / 128), 128, 0, stream>>>(pa, pd, da, dd,
                                                                                p.nb, p.di);
  return (int)cudaGetLastError();
}

template <typename AT>
int run(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
        const float* a, const AT* dskip, const float* h0, AT* out, float* h_last,
        const int* dims, const long long* st, void* stream) {
  ScanParams p;
  const int nb = dims[0], n = dims[3];
  p.s = dims[1];
  p.di = dims[2];
  if (nb < 1 || nb > 65535 || p.s < 1 || p.di < 1) return (int)cudaErrorInvalidValue;
  p.x_sb = st[0]; p.x_st = st[1];
  p.dt_sb = st[2]; p.dt_st = st[3];
  p.z_sb = st[4]; p.z_st = st[5];
  p.b_sb = st[6]; p.b_st = st[7];
  p.c_sb = st[8]; p.c_st = st[9];
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 8) return launch_scan<AT, 8>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, p, nb, s);
  if (n == 16) return launch_scan<AT, 16>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, p, nb, s);
  return (int)cudaErrorInvalidValue;
}

template <typename AT>
int run_bwd(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
            const float* a, const AT* dskip, const float* h0, const AT* dout,
            const float* dh_last, AT* dx, AT* ddt, AT* dz, float* dh0, float* ck, float* pbc,
            float* pa, float* pd, float* db, float* dc, float* da, AT* dd, const int* dims,
            void* stream) {
  BwdParams p;
  p.nb = dims[0];
  p.s = dims[1];
  p.di = dims[2];
  const int n = dims[3];
  if (p.nb < 1 || p.nb > 65535 || p.s < 1 || p.di < 1) return (int)cudaErrorInvalidValue;
  p.nch = (p.s + kChunk - 1) / kChunk;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 8)
    return launch_scan_bwd<AT, 8>(x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz,
                                  dh0, ck, pbc, pa, pd, db, dc, da, dd, p, s);
  if (n == 16)
    return launch_scan_bwd<AT, 16>(x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz,
                                   dh0, ck, pbc, pa, pd, db, dc, da, dd, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dims: batch, S, di, N
// strides (elements): x b,t; dt b,t; z b,t; B b,t; C b,t
int repro_selective_scan_f32(const float* x, const float* dt, const float* z, const float* bm,
                             const float* cm, const float* a, const float* dskip,
                             const float* h0, float* out, float* h_last, const int* dims,
                             const long long* st, void* stream) {
  return run<float>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, dims, st, stream);
}

// bf16 activations (x, dt, z, D, out); fp32 A, B, C and state.
int repro_selective_scan_bf16(const uint16_t* x, const uint16_t* dt, const uint16_t* z,
                              const float* bm, const float* cm, const float* a,
                              const uint16_t* dskip, const float* h0, uint16_t* out,
                              float* h_last, const int* dims, const long long* st,
                              void* stream) {
  return run<uint16_t>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, dims, st, stream);
}

// dims: batch, S, di, N; every operand contiguous. Scratch: ck (B, chunks,
// N, di), pbc (warps, B, S, 2N) with warps = 4 * ceil(di / 128), pa (B, N,
// di), pd (B, di), all fp32, chunks = ceil(S / 32).
int repro_selective_scan_bwd_f32(const float* x, const float* dt, const float* z,
                                 const float* bm, const float* cm, const float* a,
                                 const float* dskip, const float* h0, const float* dout,
                                 const float* dh_last, float* dx, float* ddt, float* dz,
                                 float* dh0, float* ck, float* pbc, float* pa, float* pd,
                                 float* db, float* dc, float* da, float* dd, const int* dims,
                                 void* stream) {
  return run_bwd<float>(x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz, dh0, ck,
                        pbc, pa, pd, db, dc, da, dd, dims, stream);
}

int repro_selective_scan_bwd_bf16(const uint16_t* x, const uint16_t* dt, const uint16_t* z,
                                  const float* bm, const float* cm, const float* a,
                                  const uint16_t* dskip, const float* h0,
                                  const uint16_t* dout, const float* dh_last, uint16_t* dx,
                                  uint16_t* ddt, uint16_t* dz, float* dh0, float* ck,
                                  float* pbc, float* pa, float* pd, float* db, float* dc,
                                  float* da, uint16_t* dd, const int* dims, void* stream) {
  return run_bwd<uint16_t>(x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz, dh0,
                           ck, pbc, pa, pd, db, dc, da, dd, dims, stream);
}

}  // extern "C"
