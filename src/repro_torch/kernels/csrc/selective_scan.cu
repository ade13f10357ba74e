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
// No fast math: silu(z) by `expf`; the decays by `__expf` (below, `decay`).
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
// What bounds it on this card (3.35 TB/s; 67 TFLOP/s fp32): bytes, against
// an instruction stream that is nearly as long. At the served prefill of
// full-width jamba (B 4, S 32, di 8192, N 16) the forward reads x, dt, z
// (12.6 MB), A and the state (2.6 MB) and writes out and the state (6.3
// MB): ~6 us; its 16.8 M state steps take ~12 instructions each (the
// decay's exp, three FMAs, their share of staging), ~6 us at the card's
// issue rate (132 SMs x 4 warp instructions a clock). A decode step moves
// the (B, di, N) state in and out, 2 x 2.1 MB, and A: ~1.4 us, a latency
// problem. The backward reads x, dt, z, dout and B, C once and writes dx,
// ddt, dz, dB, dC, dA, dD and dh0 once: at full-width training (B 4, S 128,
// fp32) 67 MB, ~20 us; it walks the states three times (checkpoints, the
// chunk again, the reverse walk) at ~48 instructions a state and step,
// ~95 us at the issue rate: instructions, not bytes, set its floor.
//
// Design:
// - A channel's N states are split over L = N / 4 lanes, 4 states a lane
//   (4 lanes a channel at N = 16, 2 at N = 8). The (B, di, N) state, A and
//   the backward's (B, di, N) outputs move as 16-byte accesses by
//   consecutive lanes.
// - Steps come in chunks (16 in the forward, 8 in the backward). A block
//   stages a chunk's x, dt, z (and dout) for its channels, coalesced along
//   d, and B and C in shared memory, loading the next chunk into registers
//   while it walks the current one. At staging each (step, channel) is turned once into what
//   the walk reads (dt, u = dt x, dout silu(z)) and what the chunk's finish
//   reads (x D, silu(z), x, dout silu'(z)).
// - The walks keep no sum over n: each lane writes its part (of y; of du
//   and sum_n g A in the backward) to shared memory, and after the chunk the
//   thread that staged a (step, channel) adds its L parts in lane order and
//   forms the outputs (out; dx, ddt, dz and its part of dD), stored
//   coalesced along d. No shuffle or branch in the forward's walk.
// - Forward: 128 threads a block, 128 / L channels of one batch element
//   (4 x 256 = 1,024 blocks at full width, ~31 warps an SM).
// - Backward: 32 channels a block (128 threads at N = 16, 64 at N = 8).
//   Walk 1 goes from h0 to the start of the last chunk and keeps the state
//   at the start of every chunk between in scratch (B, chunks - 2, di, N).
//   Then, chunk by chunk from the last, walk 2 goes from that state through
//   the chunk, keeping its 8 x 4 states a lane in registers (128 registers
//   at N = 16: four blocks an SM), and the reverse walk reads them back.
// - dB and dC: a lane's 8 values (dB and dC at its 4 states) are summed
//   over the warp's channels by a reduce-scatter butterfly (7 shuffles at N
//   = 16; each lane ends with one sum), the warps' sums added in warp order
//   through shared memory into per-block partials (blocks, B, S, 2N): 16.8
//   MB at full width. dA goes per (b, d) into (B, di, N), dD per (b, d)
//   into (B, di) from its staging threads' parts in thread order. A second
//   kernel adds the partials up in a fixed order: no atomics, so a repeat
//   is bitwise the same.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kStates = 4;        // states a lane
constexpr int kFwdThreads = 128;  // forward block
constexpr int kFwdChunk = 16;     // forward steps staged at once
constexpr int kBwdChannels = 32;  // backward block: channels
constexpr int kChunk = 8;         // backward: steps a chunk (states kept in registers)

struct ScanParams {
  int s, di, vec;  // vec: h0, A and h_last 16-byte aligned
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

// t1 = y + x D from the staged x D, rounded as the reference rounds for
// bf16 activations.
template <typename AT>
__device__ __forceinline__ float skip(float y, float xd) {
  if constexpr (std::is_same<AT, float>::value) {
    return y + xd;
  } else {
    return act<AT>(act<AT>(y) + xd);
  }
}

// The state's decay exp(dt A), by the special-function unit: 2^(x log2 e)
// (`__expf`: two instructions where `expf` takes eight). CUDA bounds its
// error by 2 + floor(1.173 |x|) ulp, which grows with |dt A| (95 ulp at
// -80), and it flushes results under 2^-126 to 0; as an absolute error on
// a decay in (0, 1] that is at most 2 ulp of 1 (2.4e-7) over all x <= 0.
__device__ __forceinline__ float decay(float x) { return __expf(x); }

// 4 consecutive floats, as one 16-byte access when `vec`.
__device__ __forceinline__ void load4(float (&v)[kStates], const float* p, bool vec) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kStates; ++j) v[j] = p[j];
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kStates], bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kStates; ++j) p[j] = v[j];
  }
}

// A staged row of B or C: the lane's 4 states.
__device__ __forceinline__ void row4(float (&v)[kStates], const float* s) {
  const float4 t = *reinterpret_cast<const float4*>(s);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

// The sum of a channel's L per-lane partials, staged consecutively, in
// lane order.
template <int L>
__device__ __forceinline__ float lane_total(const float* p) {
  float v = p[0];
#pragma unroll
  for (int q = 1; q < L; ++q) v += p[q];
  return v;
}

// v: this lane's dB (0..3) and dC (4..7) at its 4 states. A reduce-scatter
// over the warp's channels (the lanes of one state group, lane % L): three
// rounds halve the values, lanes xor L, 2L, 4L, each keeping one half and
// adding the partner's; lanes xor 8L .. 16 (at L = 2) add whole. Returns
// the sum of value k = 4 [lane & L] + 2 [lane & 2L] + [lane & 4L].
template <int L>
__device__ __forceinline__ float channel_sum(const float (&v)[2 * kStates], int lane) {
  float w4[4], w2[2];
  {
    const bool hi = lane & L;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = (hi ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, hi ? v[i] : v[i + 4], L);
  }
  {
    const bool hi = lane & (2 * L);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      w2[i] = (hi ? w4[i + 2] : w4[i]) +
              __shfl_xor_sync(0xffffffffu, hi ? w4[i] : w4[i + 2], 2 * L);
  }
  const bool hi = lane & (4 * L);
  float r = (hi ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, hi ? w2[0] : w2[1], 4 * L);
#pragma unroll
  for (int m = 8 * L; m < 32; m <<= 1) r += __shfl_xor_sync(0xffffffffu, r, m);
  return r;
}

template <typename AT, int N>
__global__ void __launch_bounds__(kFwdThreads)
    selective_scan_kernel(const AT* __restrict__ x, const AT* __restrict__ dt,
                          const AT* __restrict__ z, const float* __restrict__ bm,
                          const float* __restrict__ cm, const float* __restrict__ a,
                          const AT* __restrict__ dskip, const float* __restrict__ h0,
                          AT* __restrict__ out, float* __restrict__ h_last, ScanParams p) {
  constexpr int L = N / kStates, CPB = kFwdThreads / L;
  constexpr int PER = kFwdChunk * CPB / kFwdThreads, TSTEP = kFwdThreads / CPB;
  constexpr int BCN = kFwdChunk * N, BCP = (BCN + kFwdThreads - 1) / kFwdThreads;
  __shared__ float s_dt[kFwdChunk][CPB], s_u[kFwdChunk][CPB];
  __shared__ float s_xd[kFwdChunk][CPB], s_g[kFwdChunk][CPB];
  __shared__ float s_y[kFwdChunk][kFwdThreads];  // each lane's part of y
  __shared__ __align__(16) float s_b[kFwdChunk][N];
  __shared__ __align__(16) float s_c[kFwdChunk][N];
  const int tid = threadIdx.x, b = blockIdx.y, d0 = blockIdx.x * CPB;
  // the walk: channel ch, states q * 4 .. q * 4 + 3
  const int ch = tid / L, q = tid % L, d = d0 + ch;
  const bool live = d < p.di;
  // the staging: channel sc at steps st, st + TSTEP, ...
  const int sc = tid % CPB, st = tid / CPB, sd = d0 + sc;
  const bool slive = sd < p.di;
  const float dd = slive ? widen(dskip[sd]) : 0.f;
  float h[kStates] = {}, av[kStates] = {};
  const long long hrow = ((long long)b * p.di + d) * N + q * kStates;
  if (live) {
    load4(h, h0 + hrow, p.vec);
    load4(av, a + (long long)d * N + q * kStates, p.vec);
  }
  const AT* xb = x + b * p.x_sb + sd;
  const AT* dtb = dt + b * p.dt_sb + sd;
  const AT* zb = z + b * p.z_sb + sd;
  AT* ob = out + (long long)b * p.s * p.di + sd;
  AT rx[PER], rdt[PER], rz[PER];
  float rb[BCP], rc[BCP];
  auto load = [&](int t0, int tn) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      const bool ok = slive && t < tn;
      const long long tt = t0 + t;
      rx[i] = ok ? xb[tt * p.x_st] : AT(0);
      rdt[i] = ok ? dtb[tt * p.dt_st] : AT(0);
      rz[i] = ok ? zb[tt * p.z_st] : AT(0);
    }
#pragma unroll
    for (int i = 0; i < BCP; ++i) {
      const int e = tid + i * kFwdThreads, t = e / N, n = e % N;
      const bool ok = e < BCN && t < tn;
      rb[i] = ok ? bm[b * p.b_sb + (long long)(t0 + t) * p.b_st + n] : 0.f;
      rc[i] = ok ? cm[b * p.c_sb + (long long)(t0 + t) * p.c_st + n] : 0.f;
    }
  };
  auto commit = [&]() {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      const float xv = widen(rx[i]), dtv = widen(rdt[i]), zv = widen(rz[i]);
      s_dt[t][sc] = dtv;
      s_u[t][sc] = act<AT>(dtv * xv);
      s_xd[t][sc] = act<AT>(xv * dd);
      s_g[t][sc] = act<AT>(zv / (1.f + expf(-zv)));
    }
#pragma unroll
    for (int i = 0; i < BCP; ++i) {
      const int e = tid + i * kFwdThreads;
      if (e < BCN) {
        s_b[e / N][e % N] = rb[i];
        s_c[e / N][e % N] = rc[i];
      }
    }
  };
  // the chunk's out from its y parts, stored coalesced along d
  auto finish = [&](int t0, int tn) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      if (slive && t < tn) {
        const float y = lane_total<L>(&s_y[t][sc * L]);
        put(ob + (long long)(t0 + t) * p.di, act<AT>(skip<AT>(y, s_xd[t][sc]) * s_g[t][sc]));
      }
    }
  };
  const int nch = (p.s + kFwdChunk - 1) / kFwdChunk;
  load(0, min(kFwdChunk, p.s));
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * kFwdChunk, tn = min(kFwdChunk, p.s - t0);
    if (c > 0) {
      __syncthreads();  // the previous chunk is walked
      finish(t0 - kFwdChunk, kFwdChunk);
    }
    commit();  // each thread overwrites only the slots it finished
    __syncthreads();
    if (c + 1 < nch) load(t0 + kFwdChunk, min(kFwdChunk, p.s - t0 - kFwdChunk));
#pragma unroll 4
    for (int t = 0; t < kFwdChunk; ++t) {
      if (t < tn) {
        const float dtv = s_dt[t][ch], u = s_u[t][ch];
        float bb[kStates], cc[kStates];
        row4(bb, &s_b[t][q * kStates]);
        row4(cc, &s_c[t][q * kStates]);
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          h[j] = decay(dtv * av[j]) * h[j] + u * bb[j];
          y += h[j] * cc[j];
        }
        s_y[t][tid] = y;
      }
    }
  }
  __syncthreads();
  finish((nch - 1) * kFwdChunk, p.s - (nch - 1) * kFwdChunk);
  if (live) store4(h_last + hrow, h, p.vec);
}

template <typename AT, int N>
int launch_scan(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
                const float* a, const AT* dskip, const float* h0, AT* out, float* h_last,
                const ScanParams& p, int nb, cudaStream_t stream) {
  constexpr int CPB = kFwdThreads / (N / kStates);
  dim3 grid((unsigned)((p.di + CPB - 1) / CPB), nb);
  selective_scan_kernel<AT, N><<<grid, kFwdThreads, 0, stream>>>(x, dt, z, bm, cm, a, dskip,
                                                                 h0, out, h_last, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdParams {
  int nb, s, di, nch, vec;  // nch: chunks of kChunk steps; vec: the (B, di, N) and
                            // (di, N) operands 16-byte aligned
};

// a backward block's threads: kBwdChannels channels of N / kStates lanes
template <int N>
struct BwdBlock {
  static constexpr int kThreads = kBwdChannels * (N / kStates);
};

template <typename AT, int N>
__global__ void __launch_bounds__(BwdBlock<N>::kThreads)
    selective_scan_bwd_kernel(const AT* __restrict__ x, const AT* __restrict__ dt,
                              const AT* __restrict__ z, const float* __restrict__ bm,
                              const float* __restrict__ cm, const float* __restrict__ a,
                              const AT* __restrict__ dskip, const float* __restrict__ h0,
                              const AT* __restrict__ dout, const float* __restrict__ dh_last,
                              AT* __restrict__ dx, AT* __restrict__ ddt, AT* __restrict__ dz,
                              float* __restrict__ dh0, float* __restrict__ ck,
                              float* __restrict__ pbc, float* __restrict__ pa,
                              float* __restrict__ pd, BwdParams p) {
  constexpr int L = N / kStates, CPB = kBwdChannels, T = BwdBlock<N>::kThreads;
  constexpr int PER = kChunk * CPB / T, TSTEP = T / CPB;
  constexpr int BCN = kChunk * N, BCP = (BCN + T - 1) / T;
  constexpr int W = T / 32, SLOTS = 2 * N;
  // the walks read these for every lane
  __shared__ float s_dt[kChunk][CPB], s_u[kChunk][CPB], s_dt1[kChunk][CPB];
  // the finish reads these, and each lane's parts of y, du and sum_n g A
  __shared__ float s_x[kChunk][CPB], s_xd[kChunk][CPB], s_dzf[kChunk][CPB];
  __shared__ float s_y[kChunk][T], s_du[kChunk][T], s_ga[kChunk][T];
  __shared__ __align__(16) float s_b[kChunk][N];
  __shared__ __align__(16) float s_c[kChunk][N];
  __shared__ float s_bc[W][kChunk][SLOTS];  // each warp's dB, dC sums
  __shared__ float s_dd[T];                 // each staging thread's part of dD
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * CPB;
  const int ch = tid / L, q = tid % L, d = d0 + ch;
  const bool live = d < p.di;
  const int sc = tid % CPB, st = tid / CPB, sd = d0 + sc;
  const bool slive = sd < p.di;
  const float dds = slive ? widen(dskip[sd]) : 0.f;  // the staged channel's D
  const long long hrow = ((long long)b * p.di + d) * N + q * kStates;
  const long long row0 = (long long)b * p.s * p.di;  // (b, t = 0, d = 0)
  float h[kStates] = {}, av[kStates] = {};
  if (live) {
    load4(h, h0 + hrow, p.vec);
    load4(av, a + (long long)d * N + q * kStates, p.vec);
  }
  // this lane's slot among the warp's dB, dC sums (channel_sum's k), if it
  // stores one (at L = 2 lanes 16..31 repeat lanes 0..15)
  const int k = 4 * !!(lane & L) + 2 * !!(lane & (2 * L)) + !!(lane & (4 * L));
  const int slot = (k < 4 ? 0 : N - 4) + q * kStates + k;
  const bool stores = 8 * L < 32 ? lane < 8 * L : true;

  AT rx[PER], rdt[PER], rz[PER], rg[PER];
  float rb[BCP], rc[BCP];
  // the chunk's operands into registers; `full`: z, dout and C too (walk 2)
  auto load = [&](int t0, int tn, bool full) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      const bool ok = slive && t < tn;
      const long long idx = row0 + (long long)(t0 + t) * p.di + sd;
      rx[i] = ok ? x[idx] : AT(0);
      rdt[i] = ok ? dt[idx] : AT(0);
      rz[i] = ok && full ? z[idx] : AT(0);
      rg[i] = ok && full ? dout[idx] : AT(0);
    }
#pragma unroll
    for (int i = 0; i < BCP; ++i) {
      const int e = tid + i * T, t = e / N, n = e % N;
      const bool ok = e < BCN && t < tn;
      const long long src = ((long long)b * p.s + t0 + t) * N + n;
      rb[i] = ok ? bm[src] : 0.f;
      rc[i] = ok && full ? cm[src] : 0.f;
    }
  };
  auto commit = [&](bool full) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      const float xv = widen(rx[i]), dtv = widen(rdt[i]);
      s_dt[t][sc] = dtv;
      s_u[t][sc] = act<AT>(dtv * xv);
      if (full) {
        const float zv = widen(rz[i]), gv = widen(rg[i]);
        const float den = 1.f + expf(-zv), sig = 1.f / den;
        s_x[t][sc] = xv;
        s_xd[t][sc] = act<AT>(xv * dds);
        s_dt1[t][sc] = gv * act<AT>(zv / den);
        s_dzf[t][sc] = gv * (sig * (1.f + zv * (1.f - sig)));
      }
    }
#pragma unroll
    for (int i = 0; i < BCP; ++i) {
      const int e = tid + i * T;
      if (e < BCN) {
        s_b[e / N][e % N] = rb[i];
        if (full) s_c[e / N][e % N] = rc[i];
      }
    }
  };
  // the chunk's dx, ddt, dz from its lanes' parts (stored coalesced along
  // d), its part of dD, and its dB, dC partials
  float ddp = 0.f;
  auto finish = [&](int t0, int tn) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = st + i * TSTEP;
      if (slive && t < tn) {
        const long long idx = row0 + (long long)(t0 + t) * p.di + sd;
        const float y = lane_total<L>(&s_y[t][sc * L]);
        const float du = lane_total<L>(&s_du[t][sc * L]);
        const float ga = lane_total<L>(&s_ga[t][sc * L]);
        const float xv = s_x[t][sc], dt1 = s_dt1[t][sc];
        put(dx + idx, dt1 * dds + du * s_dt[t][sc]);
        put(ddt + idx, ga + du * xv);
        put(dz + idx, skip<AT>(y, s_xd[t][sc]) * s_dzf[t][sc]);
        ddp += dt1 * xv;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk * SLOTS / T; ++i) {
      const int e = tid + i * T, t = e / SLOTS, j = e % SLOTS;
      if (t < tn) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < W; ++v) s += s_bc[v][t][j];
        pbc[(((long long)blk * p.nb + b) * p.s + t0 + t) * SLOTS + j] = s;
      }
    }
  };
  // checkpoint slot of chunk c (1 <= c <= nch - 2): the state at its start
  auto ckp = [&](int c) { return ck + (((long long)b * (p.nch - 2) + c - 1) * p.di + d) * N +
                                 q * kStates; };

  // walk 1: from h0 to the start of the last chunk
  load(0, min(kChunk, p.s), p.nch == 1);
  for (int c = 0; c + 1 < p.nch; ++c) {
    const int t0 = c * kChunk;
    if (c > 0 && live) store4(ckp(c), h, p.vec);
    __syncthreads();  // the previous chunk is walked
    commit(false);
    __syncthreads();
    load(t0 + kChunk, min(kChunk, p.s - t0 - kChunk), c + 2 == p.nch);
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float dtv = s_dt[t][ch], u = s_u[t][ch];
      float bb[kStates];
      row4(bb, &s_b[t][q * kStates]);
#pragma unroll
      for (int j = 0; j < kStates; ++j) h[j] = decay(dtv * av[j]) * h[j] + u * bb[j];
    }
  }

  float dh[kStates] = {}, dA[kStates] = {}, hs[kStates], rck[kStates] = {};
  if (live) load4(dh, dh_last + hrow, p.vec);
#pragma unroll
  for (int j = 0; j < kStates; ++j) hs[j] = h[j];
  __syncthreads();  // walk 1 is done with the staged chunk
  for (int c = p.nch - 1; c >= 0; --c) {
    const int t0 = c * kChunk, tn = min(kChunk, p.s - t0);
    commit(true);  // each thread overwrites only the slots it finished
    __syncthreads();
    if (c > 0) {
      load(t0 - kChunk, kChunk, true);
      if (live) load4(rck, c == 1 ? h0 + hrow : ckp(c - 1), p.vec);
    }
    // walk 2: the chunk's states, kept, and each lane's part of y
    float hist[kChunk][kStates];
#pragma unroll
    for (int j = 0; j < kStates; ++j) h[j] = hs[j];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < tn) {
        const float dtv = s_dt[t][ch], u = s_u[t][ch];
        float bb[kStates], cc[kStates];
        row4(bb, &s_b[t][q * kStates]);
        row4(cc, &s_c[t][q * kStates]);
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          h[j] = decay(dtv * av[j]) * h[j] + u * bb[j];
          hist[t][j] = h[j];
          y += h[j] * cc[j];
        }
        s_y[t][tid] = y;
      }
    }
    // the reverse walk over the chunk
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      if (t < tn) {
        const float dt1 = s_dt1[t][ch], dtv = s_dt[t][ch], u = s_u[t][ch];
        float bb[kStates], cc[kStates], v[2 * kStates];
        row4(bb, &s_b[t][q * kStates]);
        row4(cc, &s_c[t][q * kStates]);
        float du = 0.f, ga = 0.f;
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          const float hp = t > 0 ? hist[t > 0 ? t - 1 : 0][j] : hs[j];
          dh[j] += dt1 * cc[j];
          v[kStates + j] = dt1 * hist[t][j];
          du += dh[j] * bb[j];
          v[j] = dh[j] * u;
          const float da = decay(dtv * av[j]);
          const float g = dh[j] * hp * da;
          dA[j] += g * dtv;
          ga += g * av[j];
          dh[j] *= da;
        }
        s_du[t][tid] = du;
        s_ga[t][tid] = ga;
        const float r = channel_sum<L>(v, lane);
        if (stores) s_bc[w][t][slot] = r;
      }
    }
#pragma unroll
    for (int j = 0; j < kStates; ++j) hs[j] = rck[j];
    __syncthreads();  // the chunk is walked
    finish(t0, tn);
  }
  s_dd[tid] = ddp;
  __syncthreads();
  if (live) {
    store4(dh0 + hrow, dh, p.vec);
    store4(pa + hrow, dA, p.vec);
  }
  if (tid < CPB && d0 + tid < p.di) {  // dD of channel tid: its staging threads in order
    float s = s_dd[tid];
#pragma unroll
    for (int i = 1; i < TSTEP; ++i) s += s_dd[tid + i * CPB];
    pd[(long long)b * p.di + d0 + tid] = s;
  }
}

// dB and dC (B, S, N): each of the first blocks adds 32 outputs' partials,
// its 8 warps a strided eighth of the channel blocks each (coalesced along
// the outputs), then the eighths in warp order; dA (di, N) and dD (di,):
// the batch elements' parts added in order, one thread an output. Fixed
// orders: a repeat is bitwise the same.
constexpr int kReduceThreads = 256;
constexpr int kReduceSplit = kReduceThreads / 32;

template <typename AT, int N>
__global__ void __launch_bounds__(kReduceThreads)
    scan_bwd_reduce(const float* __restrict__ pbc, const float* __restrict__ pa,
                    const float* __restrict__ pd, float* __restrict__ db,
                    float* __restrict__ dc, float* __restrict__ da, AT* __restrict__ dd,
                    int nblk, BwdParams p) {
  __shared__ float part[kReduceSplit][32];
  const long long m = (long long)p.nb * p.s * 2 * N, ma = (long long)p.di * N;
  const long long nbc = (m + 31) / 32;
  const int tid = threadIdx.x;
  if (blockIdx.x < nbc) {
    const int lane = tid & 31, g = tid >> 5;
    const long long i = (long long)blockIdx.x * 32 + lane;
    float s = 0.f;
    if (i < m) {
#pragma unroll 8
      for (int k = g; k < nblk; k += kReduceSplit) s += pbc[k * m + i];
    }
    part[g][lane] = s;
    __syncthreads();
    if (g == 0 && i < m) {
      s = part[0][lane];
#pragma unroll
      for (int j = 1; j < kReduceSplit; ++j) s += part[j][lane];
      const long long bt = i / (2 * N);
      const int j = (int)(i - bt * 2 * N);
      if (j < N)
        db[bt * N + j] = s;
      else
        dc[bt * N + j - N] = s;
    }
    return;
  }
  const long long i = (blockIdx.x - nbc) * kReduceThreads + tid;
  if (i < ma) {
    float s = 0.f;
    for (int k = 0; k < p.nb; ++k) s += pa[k * ma + i];
    da[i] = s;
  } else if (i < ma + p.di) {
    const long long j = i - ma;
    float s = 0.f;
    for (int k = 0; k < p.nb; ++k) s += pd[k * p.di + j];
    put(dd + j, s);
  }
}

template <typename AT, int N>
int launch_scan_bwd(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
                    const float* a, const AT* dskip, const float* h0, const AT* dout,
                    const float* dh_last, AT* dx, AT* ddt, AT* dz, float* dh0, float* ck,
                    float* pbc, float* pa, float* pd, float* db, float* dc, float* da, AT* dd,
                    const BwdParams& p, cudaStream_t stream) {
  const int nblk = (p.di + kBwdChannels - 1) / kBwdChannels;
  selective_scan_bwd_kernel<AT, N><<<dim3(nblk, p.nb), BwdBlock<N>::kThreads, 0, stream>>>(
      x, dt, z, bm, cm, a, dskip, h0, dout, dh_last, dx, ddt, dz, dh0, ck, pbc, pa, pd, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)p.nb * p.s * 2 * N + 31) / 32 +
                           ((long long)p.di * (N + 1) + kReduceThreads - 1) / kReduceThreads;
  scan_bwd_reduce<AT, N><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(pbc, pa, pd, db, dc,
                                                                         da, dd, nblk, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <typename AT>
int run(const AT* x, const AT* dt, const AT* z, const float* bm, const float* cm,
        const float* a, const AT* dskip, const float* h0, AT* out, float* h_last,
        const int* dims, const long long* st, void* stream) {
  ScanParams p;
  const int nb = dims[0], n = dims[3];
  p.s = dims[1];
  p.di = dims[2];
  if (nb < 1 || nb > 65535 || p.s < 1 || p.di < 1) return (int)cudaErrorInvalidValue;
  p.vec = aligned16(h0) && aligned16(a) && aligned16(h_last);
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
  p.vec = aligned16(h0) && aligned16(a) && aligned16(dh_last) && aligned16(dh0) &&
          (p.nch <= 2 || aligned16(ck)) && aligned16(pa);
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

// The backward's channels a block and steps a chunk, which size its
// scratch: the wrapper checks its own copy against them when it loads the
// library (`kernels/cuda.py::scan_bwd_scratch`).
void repro_selective_scan_bwd_geometry(int* out) {
  out[0] = kBwdChannels;
  out[1] = kChunk;
}

// dims: batch, S, di, N; every operand contiguous. Scratch
// (`kernels/cuda.py::scan_bwd_scratch`), all fp32, chunks = ceil(S / 8),
// blocks = ceil(di / 32): ck (B, max(chunks - 2, 0), di, N), pbc (blocks, B,
// S, 2N), pa (B, di, N), pd (B, di).
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
