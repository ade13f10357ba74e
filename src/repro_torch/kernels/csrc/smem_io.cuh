// Device and host helpers shared by the tensor-core kernels (int8_mma.cuh,
// tf32_mma.cuh): shared-memory addresses, asynchronous global->shared copies
// (cp.async), ldmatrix, the device's SM count, and the once-per-device
// dynamic shared-memory allowance.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace smemio {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 8 bytes from global to shared; when `ok` is false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and receives 32 bits of row l / 4 of each matrix
// (bytes 4 * (l % 4) ... + 3): 8 rows x 16 int8, or 8 rows x 4 tf32 in the
// layout of an mma.sync A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same four 8x8 b16 matrices, transposed as they load: lane l receives
// rows 2 * (l % 4) and 2 * (l % 4) + 1 of column l / 4 of each matrix, the
// layout of an mma.sync B fragment whose k rows are the matrix's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

constexpr int kMaxDevices = 64;

// Allow `kernel` `bytes` of dynamic shared memory on the current device,
// calling cudaFuncSetAttribute only when that device has not yet allowed as
// much: the attribute belongs to the device that is current when it is set,
// so `allowed` (one array per kernel instantiation) keeps the largest
// allowance per device ordinal. Racing threads may both set it, which is
// harmless.
inline cudaError_t allow_smem(const void* kernel, int bytes,
                              std::atomic<int> (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && allowed[dev].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && tracked) {
    int seen = allowed[dev].load(std::memory_order_relaxed);
    while (seen < bytes && !allowed[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return e;
}

// The number of SMs of the current device.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;  // an H100's; a launch on a broken device fails on its own
  return n;
}

}  // namespace smemio
