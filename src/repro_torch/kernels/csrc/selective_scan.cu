// Mamba selective scan for Hopper (sm_90a): jamba's recurrence, from the
// scan through the D skip and the SiLU(z) gate, in one launch.
//
// Replaces no pallas_call site. The reference runs this region as a jnp
// `lax.scan` over time (repro/models/ssm.py:78-112, `mamba_block`), which
// computes the function of upstream Mamba's `selective_scan_fn(u, delta, A,
// B, C, D, z)` with delta's softplus already applied. Entry point:
//   repro_selective_scan_f32   fp32 operands, fp32 state
//
// What it computes, for every batch b and channel d, with the fp32 state
// h[n], n < N, starting at h0[b, d, :]:
//   for t in 0 .. S-1:
//     h[n]  = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//     y     = sum_n h[n] * C[b,t,n]
//     out[b,t,d] = (y + x[b,t,d] * D[d]) * silu(z[b,t,d])
// and h_last[b, d, :] = h after step S-1. `expf`, not `__expf`, and no fast
// math: against the plain version (`selective_scan_plain`, the same tensor
// ops step by step) only the order of the sum over n and the contraction of
// a product and a sum into one FMA differ. Limit: 1e-4 * max|plain| + 1e-5 *
// min(1, max|plain|), the port's fp32 rule.
//
// Layout: x, dt, z (B, S, di) and B, C (B, S, N) are read through element
// strides of their batch and time dims with a contiguous last dim, so the
// model's views (z is the second half of the in-projection's output, B and C
// slices of the x-projection's) are read in place. A (di, N), D (di,) and
// h0 (B, di, N) are contiguous (h0 may be a layer's slot of the stacked
// state); out (B, S, di) and h_last (B, di, N) are the wrapper's contiguous
// outputs. Instantiated at N = 8 (reduced jamba) and 16 (full width).
//
// What bounds it on this card (3.35 TB/s; 67 TFLOP/s fp32): bytes. At the
// served prefill of full-width jamba (B 4, S 32, di 8192, N 16) it reads x,
// dt, z (12.6 MB), A and the state (2.6 MB) and writes out and the state
// (6.3 MB) against ~0.13 GFLOP: ~6 us. A decode step (S 1) moves the
// (B, di, N) state in and out, 2 x 2.1 MB, and A: ~1.4 us.
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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps whose B and C a block stages at once

struct ScanParams {
  int s, di;
  long long x_sb, x_st, dt_sb, dt_st, z_sb, z_st, b_sb, b_st, c_sb, c_st;
};

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ z, const float* __restrict__ bm,
                          const float* __restrict__ cm, const float* __restrict__ a,
                          const float* __restrict__ dskip, const float* __restrict__ h0,
                          float* __restrict__ out, float* __restrict__ h_last, ScanParams p) {
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
  if (live) dd = dskip[d];
  const float* xb = x + b * p.x_sb + d;
  const float* dtb = dt + b * p.dt_sb + d;
  const float* zb = z + b * p.z_sb + d;
  float* ob = out + ((long long)b * p.s) * p.di + d;
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
        const float xv = xb[tt * p.x_st];
        const float dtv = dtb[tt * p.dt_st];
        const float zv = zb[tt * p.z_st];
        const float dx = dtv * xv;
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dtv * av[n]) * h[n] + dx * sb[t][n];
          y += h[n] * sc[t][n];
        }
        ob[tt * p.di] = (y + xv * dd) * (zv / (1.f + expf(-zv)));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[hrow + n] = h[n];
  }
}

template <int N>
int launch_scan(const float* x, const float* dt, const float* z, const float* bm,
                const float* cm, const float* a, const float* dskip, const float* h0,
                float* out, float* h_last, const ScanParams& p, int nb, cudaStream_t stream) {
  dim3 grid((unsigned)((p.di + kThreads - 1) / kThreads), nb);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, z, bm, cm, a, dskip, h0, out,
                                                          h_last, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dims: batch, S, di, N
// strides (elements): x b,t; dt b,t; z b,t; B b,t; C b,t
int repro_selective_scan_f32(const float* x, const float* dt, const float* z, const float* bm,
                             const float* cm, const float* a, const float* dskip,
                             const float* h0, float* out, float* h_last, const int* dims,
                             const long long* st, void* stream) {
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
  if (n == 8) return launch_scan<8>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, p, nb, s);
  if (n == 16) return launch_scan<16>(x, dt, z, bm, cm, a, dskip, h0, out, h_last, p, nb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
