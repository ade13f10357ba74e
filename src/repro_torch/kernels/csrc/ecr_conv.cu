// ECR sparse convolution and PECR fused conv+ReLU+maxpool for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   repro/kernels/ecr_conv/kernel.py  ecr_conv_pallas_batch (and ecr_conv_pallas at N=1)
//   repro/kernels/conv_pool/kernel.py conv_pool_pallas_batch (and conv_pool_pallas at N=1)
// with one device body and two entry points: `repro_ecr_conv_f32` writes the
// conv result, `repro_conv_pool_f32` applies ReLU and a p x p max-pool
// (stride p, floor) in shared memory and writes only the pooled tile.
//
// What it computes (the same function as the Pallas kernels): VALID conv of
// x (N,H,W,C) with w (kh,kw,C,O) at `stride`, where sample b sums only over
// the channel blocks ids[b, 0..cnt[b]) of width bc. A block left out of the
// schedule contributes nothing; cnt[b] = 0 (an all-zero pad sample) does no
// multiply-adds and writes zeros. fp32 in, fp32 accumulate, fp32 out.
//
// Design for this card, and what bounds it:
// - The Pallas kernel keeps a whole (H,W,bc) map resident in 8 MiB of VMEM
//   and reduces over the channel blocks along a sequential grid axis into
//   scratch. A Hopper block has at most 227 KB of shared memory and blocks run
//   in no order, so here one CUDA block owns one spatial output tile
//   (TH x TW) x kTileO output channels x one sample, and the reduction over
//   channel blocks is a loop inside the block: `for k < cnt[b]` over block
//   ids[b,k] (the block reads its own ids/cnt; nothing is prefetched). The
//   accumulators stay in registers; nothing is reduced across blocks.
// - Per channel chunk of `cc` channels the block stages its input tile with
//   the halo, ((TH-1)*stride+kh) x ((TW-1)*stride+kw) x cc, and the weight
//   slab kh x kw x cc x kTileO in shared memory; the launcher sizes cc so
//   the two fit in 48 KB for any k and stride the registry sends (VGG 3x3/1,
//   LeNet 5x5, AlexNet 11x11/4).
// - The work is fp32 FMA on CUDA cores (no TF32: the port holds fp32
//   parity). Each thread owns kRP spatial positions x kRO output channels,
//   so one (tap, channel) step loads kRP + kRO values from shared memory for
//   kRP * kRO FMAs: at this size the kernel is bound by shared-memory loads
//   and by the fp32 FMA rate, well below the card's 67 TFLOP/s; it is the
//   simple, correct first kernel, and wgmma/TMA come later.
// - PECR epilogue: TH and TW are multiples of p, so no pool window straddles
//   two tiles; the ReLU'd conv tile goes through shared memory, and only
//   pooled outputs with py < oh/p, px < ow/p (floor) reach global memory.
// - Ragged spatial edges and output-channel counts that are not a multiple of
//   kTileO are masked; input channels must be a multiple of bc (the schedule
//   indexes bc-wide blocks); output channels need no padding.
//
// The int8 form of this conv (`repro_ecr_conv_i8`) has its own tensor-core
// body in ecr_conv_int8.cu.
//
// Launch hygiene: the entry points launch on the caller's stream, never
// synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileO = 64;                   // output channels per block
constexpr int kOcGroups = 16;                // threads along O
constexpr int kSpGroups = kThreads / kOcGroups;  // threads along space
constexpr int kRO = kTileO / kOcGroups;      // output channels per thread
constexpr int kRP = 4;                       // spatial positions per thread
constexpr int kMaxTileP = kSpGroups * kRP;   // TH * TW <= 64
constexpr size_t kSmemBudget = 48 * 1024;   // no opt-in attribute needed
constexpr int kMaxChunk = 16;                // channels staged per chunk

struct ConvParams {
  int n, h, w, c, o;
  int kh, kw, stride;
  int bc, n_cb;
  int oh, ow;        // conv output dims
  int pool;          // 0 = no epilogue
  int th, tw;        // spatial output tile
  int tiles_w;       // tiles along the output width
  int cc;            // channels staged per chunk
  int ih_t, iw_t;    // input tile incl. halo
};

template <bool kPool>
__global__ void __launch_bounds__(kThreads)
ecr_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                float* __restrict__ out, ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int x_tile = p.ih_t * p.iw_t;
  const int taps = p.kh * p.kw;
  float* xs = smem;                 // [cc][ih_t][iw_t]
  float* ws = smem + p.cc * x_tile;  // [tap][cc][kTileO]

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kTileO;
  const int ty0 = (blockIdx.x / p.tiles_w) * p.th;
  const int tx0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int tid = threadIdx.x;
  const int og = tid % kOcGroups;  // channels o0 + og + kOcGroups * r
  const int sg = tid / kOcGroups;  // positions sg + kSpGroups * r
  const int tile_p = p.th * p.tw;

  int pos_off[kRP];
#pragma unroll
  for (int r = 0; r < kRP; ++r) {
    const int sp = sg + kSpGroups * r;
    pos_off[r] = sp < tile_p ? (sp / p.tw) * p.stride * p.iw_t + (sp % p.tw) * p.stride : 0;
  }

  float acc[kRP][kRO];
#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < kRO; ++j) acc[i][j] = 0.f;

  // the schedule is the loop bound (the Pallas kernel's @pl.when(k < cnt))
  const int n_live = min(max(cnt[b], 0), p.n_cb);
  const int32_t* ids_b = ids + (size_t)b * p.n_cb;
  const float* xb = x + (size_t)b * p.h * p.w * p.c;
  const int gy0 = ty0 * p.stride, gx0 = tx0 * p.stride;

  for (int k = 0; k < n_live; ++k) {
    const int cbase = ids_b[k] * p.bc;
    for (int c0 = 0; c0 < p.bc; c0 += p.cc) {
      const int nc = min(p.cc, p.bc - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int l = tid; l < p.cc * x_tile; l += kThreads) {
        const int ci = l % p.cc;
        const int rest = l / p.cc;
        const int ix = rest % p.iw_t, iy = rest / p.iw_t;
        const int gy = gy0 + iy, gx = gx0 + ix;
        float v = 0.f;
        if (ci < nc && gy < p.h && gx < p.w)
          v = xb[((size_t)gy * p.w + gx) * p.c + cbase + c0 + ci];
        xs[ci * x_tile + iy * p.iw_t + ix] = v;
      }
      for (int l = tid; l < taps * p.cc * kTileO; l += kThreads) {
        const int oo = l % kTileO;
        const int rest = l / kTileO;
        const int ci = rest % p.cc, t = rest / p.cc;
        float v = 0.f;
        if (ci < nc && o0 + oo < p.o)
          v = w[((size_t)t * p.c + cbase + c0 + ci) * p.o + o0 + oo];
        ws[l] = v;
      }
      __syncthreads();
      for (int ci = 0; ci < nc; ++ci) {
        const float* xc = xs + ci * x_tile;
        for (int i = 0; i < p.kh; ++i) {
          for (int j = 0; j < p.kw; ++j) {
            const float* wt = ws + ((i * p.kw + j) * p.cc + ci) * kTileO + og;
            float wv[kRO], xv[kRP];
#pragma unroll
            for (int r = 0; r < kRO; ++r) wv[r] = wt[kOcGroups * r];
#pragma unroll
            for (int r = 0; r < kRP; ++r) xv[r] = xc[pos_off[r] + i * p.iw_t + j];
#pragma unroll
            for (int a = 0; a < kRP; ++a)
#pragma unroll
              for (int q = 0; q < kRO; ++q) acc[a][q] = fmaf(xv[a], wv[q], acc[a][q]);
          }
        }
      }
    }
  }

  if (!kPool) {
#pragma unroll
    for (int a = 0; a < kRP; ++a) {
      const int sp = sg + kSpGroups * a;
      if (sp >= tile_p) continue;
      const int oy = ty0 + sp / p.tw, ox = tx0 + sp % p.tw;
      if (oy >= p.oh || ox >= p.ow) continue;
      float* orow = out + (((size_t)b * p.oh + oy) * p.ow + ox) * p.o;
#pragma unroll
      for (int q = 0; q < kRO; ++q) {
        const int oc = o0 + og + kOcGroups * q;
        if (oc < p.o) orow[oc] = acc[a][q];
      }
    }
    return;
  }

  // PECR epilogue: ReLU'd conv tile -> shared memory -> p x p max -> global
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem_raw);  // [tile_p][kTileO]
#pragma unroll
  for (int a = 0; a < kRP; ++a) {
    const int sp = sg + kSpGroups * a;
    if (sp >= tile_p) continue;
#pragma unroll
    for (int q = 0; q < kRO; ++q) cs[sp * kTileO + og + kOcGroups * q] = fmaxf(acc[a][q], 0.f);
  }
  __syncthreads();
  const int pp = p.pool;
  const int pth = p.th / pp, ptw = p.tw / pp;
  const int poh = p.oh / pp, pow_ = p.ow / pp;
  for (int l = tid; l < pth * ptw * kTileO; l += kThreads) {
    const int oo = l % kTileO;
    const int qp = l / kTileO;
    const int qy = qp / ptw, qx = qp % ptw;
    const int gy = ty0 / pp + qy, gx = tx0 / pp + qx, oc = o0 + oo;
    if (gy >= poh || gx >= pow_ || oc >= p.o) continue;
    float m = 0.f;  // every value is ReLU'd, so 0 is the identity of the max
    for (int dy = 0; dy < pp; ++dy)
      for (int dx = 0; dx < pp; ++dx)
        m = fmaxf(m, cs[((qy * pp + dy) * p.tw + qx * pp + dx) * kTileO + oo]);
    out[(((size_t)b * poh + gy) * pow_ + gx) * p.o + oc] = m;
  }
}

// Largest channel chunk (<= bc, at most kMaxChunk) whose staged input tile
// and weight slab fit kSmemBudget; 0 when even one channel does not fit.
int pick_chunk(int bc, int ih_t, int iw_t, int taps) {
  for (int cc = kMaxChunk; cc >= 1; cc /= 2) {
    const size_t bytes = (size_t)cc * (ih_t * iw_t + taps * kTileO) * sizeof(float);
    if (cc <= bc && bytes <= kSmemBudget) return cc;
  }
  return 0;
}

int launch(const float* x, const float* w, const int32_t* ids, const int32_t* cnt,
           float* out, int n, int h, int wd, int c, int o, int kh, int kw, int stride,
           int bc, int pool, cudaStream_t stream) {
  if (n < 1 || bc < 1 || c % bc || stride < 1 || h < kh || wd < kw || pool < 0 ||
      pool > 8 || n > 65535)
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  p.n = n; p.h = h; p.w = wd; p.c = c; p.o = o;
  p.kh = kh; p.kw = kw; p.stride = stride;
  p.bc = bc; p.n_cb = c / bc;
  p.oh = (h - kh) / stride + 1;
  p.ow = (wd - kw) / stride + 1;
  p.pool = pool;
  // spatial tile: 8 x 8, or the largest multiple of the pool window <= 8
  p.th = p.tw = pool ? pool * (pool <= 8 ? 8 / pool : 1) : 8;
  if (p.th * p.tw > kMaxTileP) return (int)cudaErrorInvalidValue;
  p.ih_t = (p.th - 1) * stride + kh;
  p.iw_t = (p.tw - 1) * stride + kw;
  p.cc = pick_chunk(bc, p.ih_t, p.iw_t, kh * kw);
  if (p.cc == 0) return (int)cudaErrorInvalidValue;
  // the pooled launch tiles only the rows/cols the floor keeps
  const int cov_h = pool ? (p.oh / pool) * pool : p.oh;
  const int cov_w = pool ? (p.ow / pool) * pool : p.ow;
  if (cov_h < 1 || cov_w < 1) return (int)cudaErrorInvalidValue;
  p.tiles_w = (cov_w + p.tw - 1) / p.tw;
  const int tiles_h = (cov_h + p.th - 1) / p.th;
  const size_t stage = (size_t)p.cc * (p.ih_t * p.iw_t + kh * kw * kTileO) * sizeof(float);
  const size_t epi = pool ? (size_t)p.th * p.tw * kTileO * sizeof(float) : 0;
  const size_t smem = stage > epi ? stage : epi;
  dim3 grid(tiles_h * p.tiles_w, (o + kTileO - 1) / kTileO, n);
  if (pool) {
    ecr_conv_kernel<true><<<grid, kThreads, smem, stream>>>(x, w, ids, cnt, out, p);
    return (int)cudaGetLastError();
  }
  ecr_conv_kernel<false><<<grid, kThreads, smem, stream>>>(x, w, ids, cnt, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Conv only: out (N, OH, OW, O).
int repro_ecr_conv_f32(const float* x, const float* w, const int32_t* ids,
                       const int32_t* cnt, float* out, int n, int h, int wd,
                       int c, int o, int kh, int kw, int stride, int bc,
                       void* stream) {
  return launch(x, w, ids, cnt, out, n, h, wd, c, o, kh, kw, stride, bc, 0,
                (cudaStream_t)stream);
}

// Conv + ReLU + pool x pool max-pool (stride pool, floor): out (N, OH/p, OW/p, O).
int repro_conv_pool_f32(const float* x, const float* w, const int32_t* ids,
                        const int32_t* cnt, float* out, int n, int h, int wd,
                        int c, int o, int kh, int kw, int stride, int bc,
                        int pool, void* stream) {
  if (pool < 1) return (int)cudaErrorInvalidValue;
  return launch(x, w, ids, cnt, out, n, h, wd, c, o, kh, kw, stride, bc, pool,
                (cudaStream_t)stream);
}

}  // extern "C"
