// int8 ECR sparse convolution on Hopper's int8 tensor cores (sm_90a).
//
// Replaces the TPU kernel
//   repro/quant/kernels.py ecr_conv_int8_pallas_batch (and ecr_conv_int8_pallas
//   at N=1, a batch of one with an identity-prefix schedule)
// as the entry point `repro_ecr_conv_i8`.
//
// What it computes (the Pallas kernels' function): the VALID conv of the
// int8 x (N,H,W,C) with the int8 w (kh,kw,C,O) at `stride`, where sample b
// sums only over its channel blocks ids[b, 0..cnt[b]) of width bc, exactly,
// in int32, and leaves as fp32 rescaled in the reference's order:
//   out[b,y,x,o] = ((float)acc * sx[b]) * sw[o].
// cnt[b] = 0 (an all-zero pad sample) writes zeros. The integer sums are
// exact in any order (|acc| <= 127 * 127 * C * kh * kw < 2^31 for every
// layer the registry sends), so any tiling of the reduction agrees bitwise
// with a plain version that sums in float64.
//
// What bounds it on this card: the int8 work is tiny next to the card's
// 1,979 TOPS of int8 tensor cores (a served VGG-19 layer at batch 8 is
// 5-20 GOP, 3-10 us at peak); the bytes (input, weights, fp32 output) are a
// few MB. So the kernel is bound by how fast it feeds the tensor cores from
// shared memory and by filling 132 SMs, not by the device's memory.
//
// Design:
// - Implicit GEMM over the live channels, on mma.sync m16n8k32 s8 (exact
//   int32 accumulation). One block owns a spatial output tile of up to 128
//   positions (M, TH x TW, chosen per layer to need the fewest tiles), 128
//   output channels (N) and one sample. K = taps x scheduled channels, in
//   steps of 32 channels: one step gathers 32 / bc scheduled blocks
//   (four at the served block_c = 8) from ids[b, :cnt[b]] into one 32-channel
//   slab; the tail of the last step is zero-filled.
// - Per 32-channel group the block stages, with cp.async into a double
//   buffer, the halo'd input tile ((TH-1)*s+kh) x ((TW-1)*s+kw) x 32 int8
//   and the weight slab (taps x 32 x 128 int8), so the next group loads
//   while the current one multiplies. Layers whose slab does not fit (5x5,
//   11x11) stage their taps in chunks. Above 48 KB the shared memory is
//   dynamic, raised with cudaFuncSetAttribute.
// - A operand (positions x channels): x is NHWC, so every staged position is
//   32 channel-contiguous bytes and ldmatrix.x4 gathers the im2col rows of
//   any tap straight from the halo tile (each lane names its own row). The
//   two 16-byte halves of a position swap when bit 2 of the position is set,
//   so the 8 rows of an ldmatrix phase hit 8 distinct bank groups.
// - B operand (channels x output channels, K-contiguous per channel in the
//   fragment): w is O-contiguous, so the slab is staged as it lies and each
//   thread transposes 4x4 byte blocks in registers (prmt): four 32-bit reads
//   give the fragments of four n8 tiles whose columns interleave (column n of
//   tile j is output channel 4n + j). 16-byte chunks of a slab row are XOR-
//   swizzled by (row / 4) so the four k-rows a warp reads at once fall in
//   distinct banks.
// - 8 warps, 2 along M x 4 along N: a warp owns 64 positions x 32 output
//   channels, 16 MMAs per k-step from 4 ldmatrix.x4 and 8 shared loads.
// - Every block reduces its own tile over all of its sample's live channels;
//   nothing is reduced across blocks. At N=1 conv13-16 launch only 8 blocks
//   on 132 SMs. Splitting their channel groups across blocks (int32 atomics
//   and a flush pass) bought little there and nothing at the batches the
//   engine serves (its buckets hold 2 or more requests), so it does not.
// - Ragged edges: positions past OH/OW and output channels past O are masked;
//   C must be a multiple of bc. Operands that are not 8-byte (x) or 16-byte
//   (w) aligned, or a bc that is not a multiple of 8, are staged with plain
//   byte loads instead of cp.async (the same results, slower).
//
// Launch hygiene: the entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "int8_mma.cuh"

namespace {

using namespace int8mma;

constexpr int kThreads = 256;          // 8 warps: 2 along M x 4 along N
constexpr int kTileM = 128;            // output positions per block
constexpr int kTileN = 128;            // output channels per block
constexpr int kK = 32;                 // channels per k-step (m16n8k32)
constexpr int kTapBytes = kK * kTileN; // one tap of the staged weight slab
constexpr int kMaxSmem = 227 * 1024;   // a block's shared memory on sm_90
constexpr int kTwoPerSm = 113 * 1024;  // stay under this for 2 blocks per SM

struct Params {
  int n, h, w, c, o, kh, kw, stride, bc, n_cb;
  int oh, ow;
  int th, tw, tiles_w, ih_t, iw_t;  // spatial tile and its halo'd input tile
  int taps, tc, n_chunks;           // taps per staged chunk, chunks per group
  int fast_x, fast_w;               // cp.async staging usable
  int halo_bytes, slab_bytes;       // one buffer of each
};

// Byte offset of channel byte kk (0..31) of staged position pos: the two
// 16-byte halves swap when bit 2 of pos is set (ldmatrix without conflicts).
__device__ __forceinline__ int halo_off(int pos, int kk) {
  return pos * kK + ((((kk >> 4) ^ (pos >> 2)) & 1) << 4) + (kk & 15);
}

// Byte offset of output-channel byte oo (0..127) of slab row k of tap tt:
// 16-byte chunks XOR-swizzled by bits 2-3 of k.
__device__ __forceinline__ int slab_off(int tt, int k, int oo) {
  return (tt * kK + k) * kTileN + ((((oo >> 4) ^ (((k >> 2) & 3) << 1))) << 4) + (oo & 15);
}

// Input channel of virtual channel v (v < n_live * bc) of sample b.
__device__ __forceinline__ int channel_of(const int32_t* ids_b, int v, int bc) {
  const int kb = v / bc;
  return ids_b[kb] * bc + (v - kb * bc);
}

// Stage the halo'd input tile of 32-channel group grp.
__device__ void stage_halo(unsigned char* halo, const int8_t* __restrict__ xb,
                           const int32_t* __restrict__ ids_b, int total_v, int grp,
                           int gy0, int gx0, const Params& p) {
  const int npos = p.ih_t * p.iw_t;
  const int v0 = grp * kK;
  if (p.fast_x) {  // 8 channels (within one block) per cp.async
    // a thread stages the same 8 channels at every position it visits
    const int q = threadIdx.x & 3, v = v0 + q * 8;
    const bool vok = v < total_v;
    const int8_t* xc = vok ? xb + channel_of(ids_b, v, p.bc) : xb;
    for (int pos = threadIdx.x >> 2; pos < npos; pos += kThreads / 4) {
      const int iy = pos / p.iw_t, ix = pos - iy * p.iw_t;
      const int gy = gy0 + iy, gx = gx0 + ix;
      const bool ok = vok && gy < p.h && gx < p.w;
      cp_async8(smem_addr(halo + halo_off(pos, q * 8)),
                ok ? xc + ((size_t)gy * p.w + gx) * p.c : xb, ok);
    }
  } else {
    for (int l = threadIdx.x; l < npos * kK; l += kThreads) {
      const int pos = l / kK, kk = l % kK;
      const int iy = pos / p.iw_t, ix = pos - iy * p.iw_t;
      const int gy = gy0 + iy, gx = gx0 + ix, v = v0 + kk;
      int8_t val = 0;
      if (v < total_v && gy < p.h && gx < p.w)
        val = xb[((size_t)gy * p.w + gx) * p.c + channel_of(ids_b, v, p.bc)];
      halo[halo_off(pos, kk)] = (unsigned char)val;
    }
  }
}

// Stage taps [t0, t0 + nt) of the weight slab of group grp, output channels
// [o0, o0 + 128).
__device__ void stage_slab(unsigned char* slab, const int8_t* __restrict__ w,
                           const int32_t* __restrict__ ids_b, int total_v, int grp,
                           int t0, int nt, int o0, const Params& p) {
  const int v0 = grp * kK;
  if (p.fast_w) {  // 16 output channels per cp.async
    // a thread stages the same slab row k and 16 channels of every tap
    static_assert(kThreads == 8 * kK, "one (row, 16-channel chunk) per thread");
    const int c16 = threadIdx.x & 7, k = threadIdx.x >> 3;
    const int v = v0 + k, oc = o0 + c16 * 16;
    const bool ok = v < total_v && oc < p.o;
    const size_t tap_stride = (size_t)p.c * p.o;
    const int8_t* src = ok ? w + (size_t)t0 * tap_stride +
                                 (size_t)channel_of(ids_b, v, p.bc) * p.o + oc
                           : w;
    for (int tt = 0; tt < nt; ++tt)
      cp_async16(smem_addr(slab + slab_off(tt, k, c16 * 16)),
                 ok ? src + tt * tap_stride : w, ok);
  } else {
    for (int l = threadIdx.x; l < nt * kK * kTileN; l += kThreads) {
      const int oo = l % kTileN, k = (l / kTileN) % kK, tt = l / (kK * kTileN);
      const int v = v0 + k, oc = o0 + oo;
      int8_t val = 0;
      if (v < total_v && oc < p.o)
        val = w[((size_t)(t0 + tt) * p.c + channel_of(ids_b, v, p.bc)) * p.o + oc];
      slab[slab_off(tt, k, oo)] = (unsigned char)val;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ecr_conv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ ids, const int32_t* __restrict__ cnt,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [halo 0][halo 1][slab 0][slab 1]
  unsigned char* const slab0 = smem + 2 * p.halo_bytes;

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kTileN;
  const int ty0 = (blockIdx.x / p.tiles_w) * p.th;
  const int tx0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 positions x 32 channels
  const int g = lane >> 2, t = lane & 3;

  // the schedule is the loop bound (the Pallas kernel's @pl.when(k < cnt))
  const int n_live = min(max(cnt[b], 0), p.n_cb);
  const int total_v = n_live * p.bc;  // scheduled channels, in schedule order
  const int n_units = (total_v + kK - 1) / kK * p.n_chunks;

  const int32_t* ids_b = ids + (size_t)b * p.n_cb;
  const int8_t* xb = x + (size_t)b * p.h * p.w * p.c;
  const int gy0 = ty0 * p.stride, gx0 = tx0 * p.stride;
  const int tile_p = p.th * p.tw;

  // ldmatrix: lane gives row (lane & 7) + 8 * ((lane >> 3) & 1) of each
  // m16 tile, k-half lane >> 4; pbase = that row's halo position at tap 0
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lhalf = lane >> 4;
  int pbase[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    int m = wm * 64 + mt * 16 + lrow;
    if (m >= tile_p) m = 0;  // a dummy row: computes on a real position, never stored
    const int py = m / p.tw, px = m - py * p.tw;
    pbase[mt] = py * p.stride * p.iw_t + px * p.stride;
  }
  // B: this thread reads 16-byte chunk 2*wn + (g >> 2) of the slab rows,
  // swizzled by t (rows 4t+i and 16+4t+i have (k >> 2) & 3 == t)
  const int b_off = ((((2 * wn + (g >> 2)) ^ (t << 1))) << 4) + ((g & 3) << 2);

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto stage = [&](int u) {
    const int grp = u / p.n_chunks, chunk = u % p.n_chunks;
    const int t0 = chunk * p.tc;
    if (chunk == 0)
      stage_halo(smem + ((u / p.n_chunks) & 1) * p.halo_bytes, xb, ids_b, total_v, grp,
                 gy0, gx0, p);
    stage_slab(slab0 + (u & 1) * p.slab_bytes, w, ids_b, total_v, grp, t0,
               min(p.tc, p.taps - t0), o0, p);
  };

  if (n_units > 0) stage(0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) stage(u + 1);  // its buffers were released by the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* slab = slab0 + (u & 1) * p.slab_bytes;
    const uint32_t halo_s = smem_addr(smem + ((u / p.n_chunks) & 1) * p.halo_bytes);
    const int t0 = (u % p.n_chunks) * p.tc;
    const int nt = min(p.tc, p.taps - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const int tap = t0 + tt;
      const int i = tap / p.kw, j = tap - i * p.kw;
      const int toff = i * p.iw_t + j;
      uint32_t b0[4], b1[4];
      {
        const unsigned char* srow = slab + tt * kTapBytes + b_off;
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(srow + (4 * t) * kTileN);
        const uint32_t* r1 = reinterpret_cast<const uint32_t*>(srow + (16 + 4 * t) * kTileN);
        transpose4x4(r0[0], r0[kTileN / 4], r0[2 * kTileN / 4], r0[3 * kTileN / 4], b0);
        transpose4x4(r1[0], r1[kTileN / 4], r1[2 * kTileN / 4], r1[3 * kTileN / 4], b1);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int pos = pbase[mt] + toff;
        uint32_t a[4];
        ldmatrix_x4(a, halo_s + pos * kK + ((((pos >> 2) ^ lhalf) & 1) << 4));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma_s8(acc[mt][jj], a, b0[jj], b1[jj]);
      }
    }
    __syncthreads();  // this unit's buffers may be refilled
  }

  // epilogue: fragment row g (+8) of m16 tile mt is position
  // wm*64 + mt*16 + g (+8); its columns 2t, 2t+1 of n8 tile jj are output
  // channels o0 + 32*wn + 8t + jj and + 4 + jj
  const int ob = o0 + 32 * wn + 8 * t;
  const bool vec = (p.o & 3) == 0 && ob + 7 < p.o;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = wm * 64 + mt * 16 + g + 8 * r;
      if (m >= tile_p) continue;
      const int oy = ty0 + m / p.tw, ox = tx0 + m % p.tw;
      if (oy >= p.oh || ox >= p.ow) continue;
      const size_t row = (((size_t)b * p.oh + oy) * p.ow + ox) * p.o;
      int32_t v[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        v[jj] = acc[mt][jj][2 * r];
        v[4 + jj] = acc[mt][jj][2 * r + 1];
      }
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = ob + e < p.o ? ((float)v[e] * sx[b]) * sw[ob + e] : 0.f;
      if (vec) {
        float4* dst = reinterpret_cast<float4*>(out + row + ob);
        dst[0] = make_float4(f[0], f[1], f[2], f[3]);
        dst[1] = make_float4(f[4], f[5], f[6], f[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ob + e < p.o) out[row + ob + e] = f[e];
      }
    }
  }
}

// Spatial tile of at most kTileM positions whose double-buffered halo and
// one tap fit: the fewest tiles, then a width that is a multiple of 8 (the
// 8 rows of an ldmatrix phase in one tile row), then the smallest halo.
bool pick_tile(Params& p) {
  long long best = -1;
  for (int tw = 1; tw <= std::min(p.ow, kTileM); ++tw) {
    const int th = std::min(kTileM / tw, p.oh);
    const int ih = (th - 1) * p.stride + p.kh, iw = (tw - 1) * p.stride + p.kw;
    const long long halo = (long long)ih * iw * kK;
    if (2 * halo + 2 * kTapBytes > kMaxSmem) continue;
    const long long tiles = (long long)((p.oh + th - 1) / th) * ((p.ow + tw - 1) / tw);
    const long long key = (tiles * 2 + (tw % 8 != 0)) * kMaxSmem + halo;
    if (best < 0 || key < best) {
      best = key;
      p.th = th;
      p.tw = tw;
      p.ih_t = ih;
      p.iw_t = iw;
      p.halo_bytes = (int)halo;
    }
  }
  if (best < 0) return false;
  p.tiles_w = (p.ow + p.tw - 1) / p.tw;
  // taps per staged chunk: all of them if two blocks still fit an SM,
  // else as many as fit that, else as many as fit one block
  const int left2 = (kTwoPerSm - 2 * p.halo_bytes) / (2 * kTapBytes);
  const int left1 = (kMaxSmem - 2 * p.halo_bytes) / (2 * kTapBytes);
  p.tc = std::min(p.taps, left2 >= 1 ? left2 : left1);
  p.n_chunks = (p.taps + p.tc - 1) / p.tc;
  p.slab_bytes = p.tc * kTapBytes;
  return true;
}

// The launch's geometry (Params with the spatial tile filled in), or an
// error for a shape the kernel cannot take. Also answers
// `repro_ecr_conv_i8_tile`, so the Python mirror is checked against it.
int choose(Params& p, int n, int h, int wd, int c, int o, int kh, int kw, int stride,
           int bc) {
  if (n < 1 || o < 1 || bc < 1 || c < bc || c % bc || stride < 1 || kh < 1 || kw < 1 ||
      h < kh || wd < kw || n > 65535)
    return (int)cudaErrorInvalidValue;
  p.n = n; p.h = h; p.w = wd; p.c = c; p.o = o;
  p.kh = kh; p.kw = kw; p.stride = stride;
  p.bc = bc; p.n_cb = c / bc;
  p.oh = (h - kh) / stride + 1;
  p.ow = (wd - kw) / stride + 1;
  p.taps = kh * kw;
  if (!pick_tile(p)) return (int)cudaErrorInvalidValue;
  if ((o + kTileN - 1) / kTileN > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

int launch(const int8_t* x, const int8_t* w, const int32_t* ids, const int32_t* cnt,
           const float* sx, const float* sw, float* out, int n, int h, int wd, int c,
           int o, int kh, int kw, int stride, int bc, cudaStream_t stream) {
  Params p;
  const int err = choose(p, n, h, wd, c, o, kh, kw, stride, bc);
  if (err != 0) return err;
  p.fast_x = bc % 8 == 0 && ((uintptr_t)x & 7) == 0;
  p.fast_w = o % 16 == 0 && ((uintptr_t)w & 15) == 0;
  const int tiles = ((p.oh + p.th - 1) / p.th) * p.tiles_w;
  const int o_tiles = (o + kTileN - 1) / kTileN;
  const size_t smem = 2 * (size_t)p.halo_bytes + 2 * (size_t)p.slab_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ecr_conv_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tiles, o_tiles, n);
  ecr_conv_i8_kernel<<<grid, kThreads, smem, stream>>>(x, w, ids, cnt, sx, sw, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int8 conv, int32 accumulation, rescaled at the flush: x (N,H,W,C) int8,
// w (kh,kw,C,O) int8, sx (N,) per-sample and sw (O,) per-output-channel fp32
// scales -> out (N, OH, OW, O) fp32.
int repro_ecr_conv_i8(const int8_t* x, const int8_t* w, const int32_t* ids,
                      const int32_t* cnt, const float* sx, const float* sw,
                      float* out, int n, int h, int wd, int c, int o, int kh,
                      int kw, int stride, int bc, void* stream) {
  return launch(x, w, ids, cnt, sx, sw, out, n, h, wd, c, o, kh, kw, stride, bc,
                (cudaStream_t)stream);
}

// The geometry `launch` would pick, without launching: out[0..6] = the
// block's positions and output channels (128, 128), spatial tile rows,
// columns, spatial tiles, output-channel tiles, dynamic shared memory in
// bytes. Returns 0, or the error `launch` would return.
int repro_ecr_conv_i8_tile(int n, int h, int wd, int c, int o, int kh, int kw, int stride,
                           int bc, int* out) {
  Params p;
  const int e = choose(p, n, h, wd, c, o, kh, kw, stride, bc);
  if (e != 0) return e;
  const int vals[7] = {kTileM, kTileN, p.th, p.tw, ((p.oh + p.th - 1) / p.th) * p.tiles_w,
                       (o + kTileN - 1) / kTileN,
                       (int)(2 * (size_t)p.halo_bytes + 2 * (size_t)p.slab_bytes)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
