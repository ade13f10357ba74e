// ECR sparse convolution and PECR fused conv+ReLU+maxpool on Hopper's TF32
// tensor cores, at fp32 accuracy through split-TF32 (sm_90a).
//
// Replaces the TPU kernels
//   repro/kernels/ecr_conv/kernel.py  ecr_conv_pallas_batch (and ecr_conv_pallas at N=1)
//   repro/kernels/conv_pool/kernel.py conv_pool_pallas_batch (and conv_pool_pallas at N=1)
// with one device body and two entry points: `repro_ecr_conv_f32` writes the
// conv result, `repro_conv_pool_f32` applies ReLU and a p x p max-pool
// (stride p, floor) in shared memory and writes only the pooled tile.
//
// What it computes (the Pallas kernels' function): the VALID conv of
// x (N,H,W,C) with w (kh,kw,C,O) at `stride`, where sample b sums only over
// the channel blocks ids[b, 0..cnt[b]) of width bc. A block left out of the
// schedule contributes nothing; cnt[b] = 0 (an all-zero pad sample) does no
// multiply-adds and writes zeros. fp32 in, fp32 out, within the port's fp32
// limit of a plain fp32 sum (1e-4 * max|plain| + 1e-5 * min(1, max|plain|)).
//
// What bounds it on this card: the multiply-adds. A served VGG-19 layer at
// batch 8 is 5-20 GFLOP of live work against a few MB of operands, far above
// the H100's ridge. An fp32 FMA body on the CUDA cores (67 TFLOP/s) runs
// the live work at a lower rate than cuDNN runs all of it, so skipping
// cannot pay there. Plain TF32 on the tensor cores errs by about 3x the
// limit over a 4,608-term reduction; split-TF32 (tf32_mma.cuh: three TF32
// products per multiply-add) holds it, at 495 / 3 = 165 TFLOP/s.
// What stands between the kernel and that rate: mma.sync itself (wgmma is
// not used; scripts/mma_rate.py measures what mma.sync's TF32 products
// reach with nothing else in the way), the instructions that feed it from
// shared memory (fragment loads, B's split), barriers per staged step, tile
// padding on 28- and 14-wide maps, and filling 132 SMs.
//
// Design:
// - Implicit GEMM per sample on mma.sync m16n8k8 TF32. One block owns a
//   spatial output tile of TM = TH x TW positions (M), TN output channels (N)
//   and one sample; K = taps x scheduled channels, in k-steps of 8 channels.
//   At the served block_c = 8 a k-step is one scheduled block ids[b, k];
//   block_c = 4 packs two blocks into a step, 16 takes two steps, and the
//   tail of the last step is zero-filled. The skip is the loop bound: a
//   sample runs ceil(cnt[b] * bc / 8) steps.
// - Tile sizes: (TM, TN) from {128, 64}^2 per launch. Of the tiles whose grid
//   (M tiles x N tiles x samples) covers the SMs, the one with the least
//   padded work, ties to the larger tile (VGG-19 at batch 8: 64 x 128 on
//   56 x 56 maps, which 8 x 8 tiles cover exactly, 128 x 128 on 28 x 28);
//   else the grid with the most blocks (conv13-16 at batch 8 and N=1:
//   64 x 64). TH x TW is the spatial tile of at most TM positions needing the
//   fewest tiles, then a width that is a multiple of 8, then the smallest halo.
// - 8 warps, 2 along M x 4 along N; a warp owns (TM/2) x (TN/4): at 128 x 128
//   4 m16 x 4 n8 tiles, 16 MMA tiles x 3 products = 48 MMAs per tap and step.
//   3 x 3 convs run their 9 taps unrolled, so the next tap's fragment loads
//   issue under this tap's MMAs.
// - Staging: per k-step, cp.async (16 bytes) into a double buffer: the halo'd
//   input tile ((TH-1)*s+kh) x ((TW-1)*s+kw) positions x 8 channels (32
//   contiguous bytes per position in NHWC) and the weight slab
//   taps x 8 x TN, so the next step loads while this one multiplies. Above
//   48 KB the shared memory is dynamic (cudaFuncSetAttribute); 3x3 at
//   128 x 128 takes about 100 KB, two blocks per SM. 5x5 and 11x11 stage
//   their taps in chunks that keep two blocks per SM where they can.
// - Where the split happens. A (the halo): once per k-step, when it has
//   landed, into a split halo (one more barrier per step, twice the halo's
//   shared memory), because each halo value feeds up to kh*kw taps x 4 warps
//   along N. B (the slab): as its fragments are loaded, since each value
//   feeds only the 2 warps along M and a split slab would double the largest
//   buffer (one block per SM at 3x3, TN = 128).
// - A fragments by ldmatrix. The split halo holds per position four 16-byte
//   chunks, hi(c0-3), hi(c4-7), lo(c0-3), lo(c4-7); an m16n8k8 TF32 A
//   fragment is four 8-row x 4-value matrices, which is what ldmatrix.x4
//   (b16) delivers, so one ldmatrix gives the hi fragment and one the lo
//   fragment, each lane naming the position of its own row (the im2col row
//   of any tap, straight from the halo). Chunk c of position p lies at chunk
//   c ^ ((p >> 1) & 3), so the 8 rows of an ldmatrix phase (consecutive
//   positions at stride 1) hit 8 distinct 16-byte bank groups. On the card
//   this beat 16-byte loads regrouped in registers, and splitting A at every
//   fragment load.
// - B fragments: b0 is (k = t, n = g), b1 (k = t + 4, n = g). Slab rows are
//   padded to TN + 8 floats, so rows t = 0..3 start 8 banks apart, and a
//   lane reads two adjacent columns with one 8-byte load: column 2g of a
//   16-column pair is n = g of n8 tile 2q, column 2g + 1 that of tile
//   2q + 1; a half-warp hits 32 distinct banks. The accumulators then hold 4
//   consecutive output channels per row, written as one float4.
// - PECR epilogue: TH and TW are multiples of p, so no pool window straddles
//   two tiles; the ReLU'd accumulators go to shared memory and only pooled
//   outputs with py < OH/p, px < OW/p (floor) reach global memory.
// - Every block reduces its own tile over all of its sample's live channels;
//   nothing is reduced across blocks, so results repeat bitwise from run to
//   run. At N=1 (never launched by the engine, whose buckets hold 2 or more
//   requests) conv13-16 fill 32 of 132 SMs; a split reduction over channel
//   groups is not implemented.
// - Ragged edges: positions past OH/OW and output channels past O are masked;
//   C must be a multiple of bc. Operands that are not 16-byte aligned, a bc
//   that is not a multiple of 4, or O not a multiple of 4, are staged with
//   plain loads into the same layout (the same results, slower).
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, and return cudaGetLastError() (or the error
// of a shape they cannot take).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kThreads = 256;          // 8 warps: 2 along M x 4 along N
constexpr int kK = 8;                  // channels per k-step (m16n8k8)
constexpr int kPad = 8;                // floats after each slab row (banks)
constexpr int kMaxSmem = 227 * 1024;   // a block's shared memory on sm_90
constexpr int kTwoPerSm = 113 * 1024;  // stay under this for 2 blocks per SM

struct Params {
  int n, h, w, c, o, kh, kw, stride, bc, n_cb;
  int oh, ow, pool;                 // pool = 0: no epilogue
  int th, tw, tiles, tiles_w;       // spatial tile, tiles in all / along OW
  int ih_t, iw_t;                   // its halo'd input tile
  int taps, tc, n_chunks;           // taps per staged chunk, chunks per step
  int fast_x, fast_w;               // cp.async staging usable
  int halo_floats, slab_floats;     // one buffer of each
};

// Input channel of virtual channel v (v < n_live * bc) of sample b.
__device__ __forceinline__ int channel_of(const int32_t* ids_b, int v, int bc) {
  const int kb = v / bc;
  return ids_b[kb] * bc + (v - kb * bc);
}

// Stage the halo'd input tile of k-step grp: [position][8 channels].
__device__ void stage_halo(float* halo, const float* __restrict__ xb,
                           const int32_t* __restrict__ ids_b, int total_v, int grp,
                           int gy0, int gx0, const Params& p) {
  const int npos = p.ih_t * p.iw_t;
  const int v0 = grp * kK;
  if (p.fast_x) {  // 4 channels (within one block) per cp.async
    // a thread stages the same 4 channels at every position it visits
    const int q = threadIdx.x & 1, v = v0 + 4 * q;
    const bool vok = v < total_v;
    const float* xc = vok ? xb + channel_of(ids_b, v, p.bc) : xb;
    for (int pos = threadIdx.x >> 1; pos < npos; pos += kThreads / 2) {
      const int iy = pos / p.iw_t, ix = pos - iy * p.iw_t;
      const int gy = gy0 + iy, gx = gx0 + ix;
      const bool ok = vok && gy < p.h && gx < p.w;
      cp_async16(smem_addr(halo + pos * kK + 4 * q),
                 ok ? xc + ((size_t)gy * p.w + gx) * p.c : xb, ok);
    }
  } else {
    for (int l = threadIdx.x; l < npos * kK; l += kThreads) {
      const int pos = l / kK, kk = l % kK;
      const int iy = pos / p.iw_t, ix = pos - iy * p.iw_t;
      const int gy = gy0 + iy, gx = gx0 + ix, v = v0 + kk;
      float val = 0.f;
      if (v < total_v && gy < p.h && gx < p.w)
        val = xb[((size_t)gy * p.w + gx) * p.c + channel_of(ids_b, v, p.bc)];
      halo[l] = val;
    }
  }
}

// Stage taps [t0, t0 + nt) of the weight slab of k-step grp, output channels
// [o0, o0 + TN): [tap][8 channels][TN + kPad].
template <int TN>
__device__ void stage_slab(float* slab, const float* __restrict__ w,
                           const int32_t* __restrict__ ids_b, int total_v, int grp,
                           int t0, int nt, int o0, const Params& p) {
  constexpr int kRow = TN + kPad;
  const int v0 = grp * kK;
  const size_t tap_stride = (size_t)p.c * p.o;
  if (p.fast_w) {  // 4 output channels per cp.async
    // a thread stages the same (row, 4 channels) of every tap it visits
    constexpr int kPerTap = kK * TN / 4;
    static_assert(kThreads % kPerTap == 0, "a thread keeps its row and columns");
    const int r = threadIdx.x % kPerTap, k = r / (TN / 4), c4 = r % (TN / 4);
    const int v = v0 + k, oc = o0 + 4 * c4;
    const bool ok = v < total_v && oc < p.o;
    const float* src = ok ? w + (size_t)t0 * tap_stride +
                                (size_t)channel_of(ids_b, v, p.bc) * p.o + oc
                          : w;
    for (int tt = threadIdx.x / kPerTap; tt < nt; tt += kThreads / kPerTap)
      cp_async16(smem_addr(slab + (tt * kK + k) * kRow + 4 * c4),
                 ok ? src + tt * tap_stride : w, ok);
  } else {
    for (int l = threadIdx.x; l < nt * kK * TN; l += kThreads) {
      const int oo = l % TN, k = (l / TN) % kK, tt = l / (kK * TN);
      const int v = v0 + k, oc = o0 + oo;
      float val = 0.f;
      if (v < total_v && oc < p.o)
        val = w[(size_t)(t0 + tt) * tap_stride + (size_t)channel_of(ids_b, v, p.bc) * p.o + oc];
      slab[(tt * kK + k) * kRow + oo] = val;
    }
  }
}

// MT m16 tiles x NT n8 tiles per warp: a block of TM = 32 * MT positions x
// TN = 32 * NT output channels.
template <int MT, int NT, bool kPool>
__global__ void __launch_bounds__(kThreads, 2)
ecr_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                float* __restrict__ out, Params p) {
  constexpr int TM = 32 * MT, TN = 32 * NT, kRow = TN + kPad;
  extern __shared__ __align__(128) float smem[];
  // [halo 0][halo 1][split halo][slab 0][slab 1]
  float* const hs = smem + 2 * p.halo_floats;
  float* const slab0 = smem + 4 * p.halo_floats;

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * TN;
  const int ty0 = (blockIdx.x / p.tiles_w) * p.th;
  const int tx0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: TM/2 positions x TN/4 channels
  const int g = lane >> 2, t = lane & 3;

  // the schedule is the loop bound (the Pallas kernel's @pl.when(k < cnt))
  const int n_live = min(max(cnt[b], 0), p.n_cb);
  const int total_v = n_live * p.bc;  // scheduled channels, in schedule order
  const int n_units = (total_v + kK - 1) / kK * p.n_chunks;

  const int32_t* ids_b = ids + (size_t)b * p.n_cb;
  const float* xb = x + (size_t)b * p.h * p.w * p.c;
  const int gy0 = ty0 * p.stride, gx0 = tx0 * p.stride;
  const int tile_p = p.th * p.tw;

  // A by ldmatrix: lane gives row (lane & 7) of matrix lane >> 3; matrices 0
  // and 1 are rows 0-7 and 8-15 of m16 tile mt at channels 0-3 (chunk 0),
  // matrices 2 and 3 the same at channels 4-7 (chunk 1). apos = the halo
  // position of the lane's row at tap 0.
  int apos[MT];
  const int achunk = lane >> 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int m = wm * (TM / 2) + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    if (m >= tile_p) m = 0;  // a dummy row: computes on a real position, never stored
    const int py = m / p.tw, px = m - py * p.tw;
    apos[mt] = py * p.stride * p.iw_t + px * p.stride;
  }
  const uint32_t hs_s = smem_addr(hs);
  // B: slab row t (k = t; row t + 4 is k = t + 4), columns 2g and 2g + 1 of
  // each 16-column pair of this warp's TN/4 channels
  const int b_off = t * kRow + wn * (TN / 4) + 2 * g;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto stage = [&](int u) {
    const int grp = u / p.n_chunks, chunk = u % p.n_chunks;
    const int t0 = chunk * p.tc;
    if (chunk == 0)
      stage_halo(smem + (grp & 1) * p.halo_floats, xb, ids_b, total_v, grp, gy0, gx0, p);
    stage_slab<TN>(slab0 + (u & 1) * p.slab_floats, w, ids_b, total_v, grp, t0,
                   min(p.tc, p.taps - t0), o0, p);
  };

  if (n_units > 0) stage(0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) stage(u + 1);  // its buffers were released by the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (u % p.n_chunks == 0) {  // split the step's halo once, chunks swizzled
      const float* halo = smem + ((u / p.n_chunks) & 1) * p.halo_floats;
      for (int l = tid; l < p.halo_floats / 4; l += kThreads) {
        const int pos = l >> 1, q = l & 1, sw = (pos >> 1) & 3;
        const float4 v = *reinterpret_cast<const float4*>(halo + 4 * l);
        uint32_t h[4], lo[4];
        split(v.x, h[0], lo[0]);
        split(v.y, h[1], lo[1]);
        split(v.z, h[2], lo[2]);
        split(v.w, h[3], lo[3]);
        *reinterpret_cast<uint4*>(hs + pos * 16 + 4 * (q ^ sw)) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(hs + pos * 16 + 4 * ((q + 2) ^ sw)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      __syncthreads();
    }
    const float* slab = slab0 + (u & 1) * p.slab_floats;
    const int t0 = (u % p.n_chunks) * p.tc;
    const int nt = min(p.tc, p.taps - t0);
    // one tap: the slab rows of tap tt of this chunk against the halo
    // shifted by toff positions
    auto tap_step = [&](int tt, int toff) {
      uint32_t bh[NT][2], bl[NT][2];
      const float* brow = slab + tt * kK * kRow + b_off;
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const float2 r0 = *reinterpret_cast<const float2*>(brow + 16 * q);
        const float2 r1 = *reinterpret_cast<const float2*>(brow + 4 * kRow + 16 * q);
        split(r0.x, bh[2 * q][0], bl[2 * q][0]);
        split(r0.y, bh[2 * q + 1][0], bl[2 * q + 1][0]);
        split(r1.x, bh[2 * q][1], bl[2 * q][1]);
        split(r1.y, bh[2 * q + 1][1], bl[2 * q + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int pos = apos[mt] + toff;
        const uint32_t addr = hs_s + pos * 64 + ((achunk ^ (pos >> 1)) & 3) * 16;
        uint32_t ah[4], al[4];
        ldmatrix_x4(ah, addr);
        ldmatrix_x4(al, addr ^ 32);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_split(acc[mt][jn], ah, al, bh[jn], bl[jn]);
      }
    };
    if (p.kh == 3 && p.kw == 3 && p.tc == 9) {
      // VGG's 3x3 unrolled: the next tap's fragments load under this one's MMAs
#pragma unroll
      for (int tt = 0; tt < 9; ++tt) tap_step(tt, (tt / 3) * p.iw_t + tt % 3);
    } else {
      for (int tt = 0; tt < nt; ++tt) {
        const int tap = t0 + tt;
        const int i = tap / p.kw, j = tap - i * p.kw;
        tap_step(tt, i * p.iw_t + j);
      }
    }
    __syncthreads();  // this unit's buffers may be refilled
  }

  // fragment row g (+ 8) of m16 tile mt is position wm*TM/2 + mt*16 + g (+ 8);
  // of pair q, c[2r] of tiles 2q and 2q+1 and c[2r+1] of both are output
  // channels cb + 16q + 0, 1, 2, 3
  const int cb = wn * (TN / 4) + 4 * t;
  if (!kPool) {
    const bool vec = (p.o & 3) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = wm * (TM / 2) + mt * 16 + g + 8 * r;
        if (m >= tile_p) continue;
        const int oy = ty0 + m / p.tw, ox = tx0 + m % p.tw;
        if (oy >= p.oh || ox >= p.ow) continue;
        float* orow = out + (((size_t)b * p.oh + oy) * p.ow + ox) * p.o;
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
          const int oc = o0 + cb + 16 * q;
          const float v[4] = {acc[mt][2 * q][2 * r], acc[mt][2 * q + 1][2 * r],
                              acc[mt][2 * q][2 * r + 1], acc[mt][2 * q + 1][2 * r + 1]};
          if (vec && oc + 3 < p.o) {
            *reinterpret_cast<float4*>(orow + oc) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (oc + e < p.o) orow[oc + e] = v[e];
          }
        }
      }
    }
    return;
  }

  // PECR epilogue: ReLU'd accumulators -> shared memory [TM][kRow] -> p x p
  // max -> global
  cp_async_wait<0>();
  __syncthreads();
  float* cs = smem;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = wm * (TM / 2) + mt * 16 + g + 8 * r;
#pragma unroll
      for (int q = 0; q < NT / 2; ++q)
        *reinterpret_cast<float4*>(cs + m * kRow + cb + 16 * q) = make_float4(
            fmaxf(acc[mt][2 * q][2 * r], 0.f), fmaxf(acc[mt][2 * q + 1][2 * r], 0.f),
            fmaxf(acc[mt][2 * q][2 * r + 1], 0.f), fmaxf(acc[mt][2 * q + 1][2 * r + 1], 0.f));
    }
  __syncthreads();
  const int pp = p.pool;
  const int pth = p.th / pp, ptw = p.tw / pp;
  const int poh = p.oh / pp, pow_ = p.ow / pp;
  for (int l = tid; l < pth * ptw * TN; l += kThreads) {
    const int oo = l % TN;
    const int qp = l / TN;
    const int qy = qp / ptw, qx = qp - qy * ptw;
    const int gy = ty0 / pp + qy, gx = tx0 / pp + qx, oc = o0 + oo;
    if (gy >= poh || gx >= pow_ || oc >= p.o) continue;
    float mx = 0.f;  // every value is ReLU'd, so 0 is the identity of the max
    for (int dy = 0; dy < pp; ++dy)
      for (int dx = 0; dx < pp; ++dx)
        mx = fmaxf(mx, cs[((qy * pp + dy) * p.tw + qx * pp + dx) * kRow + oo]);
    out[(((size_t)b * poh + gy) * pow_ + gx) * p.o + oc] = mx;
  }
}

// Spatial tile of at most tm positions (th and tw multiples of the pool
// window) whose double-buffered halo and one tap of the slab fit: the fewest
// tiles, then a width that is a multiple of 8 (the 8 rows of a fragment in
// one tile row), then the smallest halo. Then the taps per staged chunk: all
// of them if two blocks still fit an SM, else as many as fit that, else as
// many as fit one block. Returns the dynamic shared memory, 0 if none fits.
size_t pick_tile(Params& p, int tm, int tn) {
  const int pp = p.pool ? p.pool : 1;
  const int cov_h = p.oh / pp * pp, cov_w = p.ow / pp * pp;  // rows/cols the floor keeps
  if (cov_h < 1 || cov_w < 1) return 0;
  const long long tap_floats = (long long)kK * (tn + kPad);
  long long best = -1;
  for (int tw = pp; tw <= std::min(cov_w, tm); tw += pp) {
    const int th = std::min(tm / tw, cov_h) / pp * pp;
    if (th < 1) continue;
    const int ih = (th - 1) * p.stride + p.kh, iw = (tw - 1) * p.stride + p.kw;
    const long long halo = (long long)ih * iw * kK;
    if ((4 * halo + 2 * tap_floats) * (long long)sizeof(float) > kMaxSmem) continue;
    const long long tiles = (long long)((cov_h + th - 1) / th) * ((cov_w + tw - 1) / tw);
    const long long key = (tiles * 2 + (tw % 8 != 0)) * kMaxSmem + halo;
    if (best < 0 || key < best) {
      best = key;
      p.th = th;
      p.tw = tw;
      p.ih_t = ih;
      p.iw_t = iw;
      p.halo_floats = (int)halo;
    }
  }
  if (best < 0) return 0;
  p.tiles_w = (cov_w + p.tw - 1) / p.tw;
  p.tiles = ((cov_h + p.th - 1) / p.th) * p.tiles_w;
  const long long halo_bytes = 4LL * p.halo_floats * sizeof(float);
  const long long tap_bytes = 2 * tap_floats * (long long)sizeof(float);
  const long long left2 = (kTwoPerSm - halo_bytes) / tap_bytes;
  const long long left1 = (kMaxSmem - halo_bytes) / tap_bytes;
  p.tc = (int)std::min<long long>(p.taps, left2 >= 1 ? left2 : left1);
  p.n_chunks = (p.taps + p.tc - 1) / p.tc;
  p.slab_floats = (int)(p.tc * tap_floats);
  const size_t stage = (4 * (size_t)p.halo_floats + 2 * (size_t)p.slab_floats) * sizeof(float);
  const size_t epi = p.pool ? (size_t)tm * (tn + kPad) * sizeof(float) : 0;
  return std::max(stage, epi);
}

template <int MT, int NT, bool kPool>
int run(const Params& p, size_t smem, const float* x, const float* w, const int32_t* ids,
        const int32_t* cnt, float* out, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ecr_conv_kernel<MT, NT, kPool>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.tiles, (p.o + 32 * NT - 1) / (32 * NT), p.n);
  ecr_conv_kernel<MT, NT, kPool><<<grid, kThreads, smem, stream>>>(x, w, ids, cnt, out, p);
  return (int)cudaGetLastError();
}

template <bool kPool>
int dispatch(int mt, int nt, const Params& p, size_t smem, const float* x, const float* w,
             const int32_t* ids, const int32_t* cnt, float* out, cudaStream_t stream) {
  if (mt == 4 && nt == 4) return run<4, 4, kPool>(p, smem, x, w, ids, cnt, out, stream);
  if (mt == 2 && nt == 4) return run<2, 4, kPool>(p, smem, x, w, ids, cnt, out, stream);
  if (mt == 4 && nt == 2) return run<4, 2, kPool>(p, smem, x, w, ids, cnt, out, stream);
  return run<2, 2, kPool>(p, smem, x, w, ids, cnt, out, stream);
}

int launch(const float* x, const float* w, const int32_t* ids, const int32_t* cnt,
           float* out, int n, int h, int wd, int c, int o, int kh, int kw, int stride,
           int bc, int pool, int tn, cudaStream_t stream) {
  if (n < 1 || o < 1 || bc < 1 || c < bc || c % bc || stride < 1 || kh < 1 || kw < 1 ||
      h < kh || wd < kw || pool < 0 || pool > 8 || n > 65535 ||
      (tn != 0 && tn != 64 && tn != 128))
    return (int)cudaErrorInvalidValue;
  Params base;
  base.n = n; base.h = h; base.w = wd; base.c = c; base.o = o;
  base.kh = kh; base.kw = kw; base.stride = stride;
  base.bc = bc; base.n_cb = c / bc;
  base.oh = (h - kh) / stride + 1;
  base.ow = (wd - kw) / stride + 1;
  base.pool = pool;
  base.taps = kh * kw;
  base.fast_x = bc % 4 == 0 && ((uintptr_t)x & 15) == 0;  // c is a multiple of bc
  base.fast_w = o % 4 == 0 && ((uintptr_t)w & 15) == 0;
  // (TM, TN): of the tiles whose grid covers the SMs, the one with the least
  // padded work (M tiles x TM x N tiles x TN; ties go to the larger tile),
  // else the one with the most blocks. tn = 64 or 128 (a searched output
  // tile) keeps only the choices with 32 * NT == tn; 0 keeps all four.
  const int choices[4][2] = {{4, 4}, {2, 4}, {4, 2}, {2, 2}};
  const long long sms = sm_count();
  Params p;
  size_t smem = 0;
  int mt = 0, nt = 0;
  long long best_short = 0, best_cost = 0;  // (grid short of the SMs, cost): least wins
  for (const auto& ch : choices) {
    if (tn != 0 && 32 * ch[1] != tn) continue;
    Params q = base;
    const size_t s = pick_tile(q, 32 * ch[0], 32 * ch[1]);
    const long long o_tiles = (o + 32 * ch[1] - 1) / (32 * ch[1]);
    if (s == 0 || o_tiles > 65535) continue;
    const long long blocks = (long long)q.tiles * o_tiles * n;
    const long long short_ = blocks < sms;
    const long long cost = short_ ? -blocks : (long long)q.tiles * 32 * ch[0] * o_tiles * 32 * ch[1];
    if (mt == 0 || short_ < best_short || (short_ == best_short && cost < best_cost)) {
      best_short = short_;
      best_cost = cost;
      p = q;
      smem = s;
      mt = ch[0];
      nt = ch[1];
    }
  }
  if (mt == 0) return (int)cudaErrorInvalidValue;
  if (pool) return dispatch<true>(mt, nt, p, smem, x, w, ids, cnt, out, stream);
  return dispatch<false>(mt, nt, p, smem, x, w, ids, cnt, out, stream);
}

}  // namespace

extern "C" {

// Conv only: out (N, OH, OW, O). tn: the output-channel tile, 64 or 128
// columns per block, or 0 for the launch's own choice.
int repro_ecr_conv_f32(const float* x, const float* w, const int32_t* ids,
                       const int32_t* cnt, float* out, int n, int h, int wd,
                       int c, int o, int kh, int kw, int stride, int bc,
                       void* stream, int tn) {
  return launch(x, w, ids, cnt, out, n, h, wd, c, o, kh, kw, stride, bc, 0, tn,
                (cudaStream_t)stream);
}

// Conv + ReLU + pool x pool max-pool (stride pool, floor): out (N, OH/p, OW/p, O).
int repro_conv_pool_f32(const float* x, const float* w, const int32_t* ids,
                        const int32_t* cnt, float* out, int n, int h, int wd,
                        int c, int o, int kh, int kw, int stride, int bc,
                        int pool, void* stream, int tn) {
  if (pool < 1) return (int)cudaErrorInvalidValue;
  return launch(x, w, ids, cnt, out, n, h, wd, c, o, kh, kw, stride, bc, pool, tn,
                (cudaStream_t)stream);
}

}  // extern "C"
