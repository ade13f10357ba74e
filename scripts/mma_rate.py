#!/usr/bin/env python3
"""Measure the card's TF32 rate through mma.sync (the instruction the port's
fp32 ECR / PECR kernel issues), with no memory traffic in the way.

    python3 scripts/mma_rate.py

Builds a tiny CUDA kernel with nvcc (sm_90a) into build/mma_rate/: each warp
runs `iters` rounds of `chains` independent mma.sync.m16n8k8 TF32 products
on register operands and accumulators, as the ECR kernel's inner loop does
without its loads. Prints the card's name and power limit, and the TF32
TFLOP/s for 1 to 4 warps per SM sub-partition and 4 to 16 independent
accumulators per warp (the ECR kernel runs 4 warps per sub-partition, 16
accumulators per warp at 128 x 128 tiles), each the median of 5 timed runs
with CUDA events. One split-TF32 multiply-add costs three such products.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  float acc[CHAINS][4] = {};
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(1e-3f * (threadIdx.x + r));
  for (int r = 0; r < 2; ++r) b[r] = __float_as_uint(1e-3f * (threadIdx.x - r));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int chains, int blocks, int threads, int iters,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (chains) {
    case 4: mma_loop<4><<<blocks, threads, 0, st>>>(out, iters); break;
    case 8: mma_loop<8><<<blocks, threads, 0, st>>>(out, iters); break;
    case 16: mma_loop<16><<<blocks, threads, 0, st>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.cuda import nvcc_path

    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_rate.cu").write_text(SRC)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(out_dir / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for warps_per_sp in (1, 2, 4):
        threads = 128 * warps_per_sp  # one block per SM: 4 sub-partitions
        out = torch.empty(sms * threads, device="cuda")
        for chains in (4, 8, 16):
            def run():
                err = lib.mma_rate_launch(out.data_ptr(), chains, sms, threads, iters,
                                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            run()
            torch.cuda.synchronize()
            ms = []
            for _ in range(5):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            t = sorted(ms)[2]
            flops = 2.0 * 16 * 8 * 8 * chains * iters * (threads // 32) * sms
            print(f"warps/sub-partition {warps_per_sp} chains {chains:2d}: {t:.3f} ms, "
                  f"TF32 {flops / t / 1e9:.1f} TFLOP/s (split-TF32 {flops / t / 3e9:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
