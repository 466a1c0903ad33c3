// Shared helpers for the honours_tpu_torch kernels (plain C interface,
// loaded with ctypes).  Every C entry launches on the stream it is given
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HTT_EXPORT extern "C" __attribute__((visibility("default")))

HTT_EXPORT const char* htt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ unsigned htt_lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The 32-bit shared-window address of a pointer into shared memory.
__device__ __forceinline__ unsigned htt_shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of 16 or 4 bytes from device memory to the shared
// address a (cp.async, Ampere and later), their commit and the wait on
// all but the newest N groups of this thread.
__device__ __forceinline__ void htt_cp_async16(unsigned a, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void htt_cp_async4(unsigned a, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void htt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void htt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block copies n bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory and waits for all of them.
__device__ __forceinline__ void htt_copy_to_shared(void* dst, const void* src,
                                                   long long n) {
  for (long long i = 16LL * threadIdx.x; i < n; i += 16LL * blockDim.x)
    htt_cp_async16(htt_shared_addr(dst) + static_cast<unsigned>(i),
                   static_cast<const char*>(src) + i);
  htt_cp_commit();
  htt_cp_wait<0>();
  __syncthreads();
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename F>
inline void htt_smem_limit_once(F* fn, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
}

// Loads from a shared address that neither compiler may drop, predicate
// or sink into a branch, so independent loads overlap.
__device__ __forceinline__ unsigned htt_lds_u8(unsigned a) {
  unsigned short v;
  asm volatile("ld.volatile.shared.u8 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ unsigned htt_lds_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint2 htt_lds_u32x2(unsigned a) {
  uint2 v;
  asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// Stores of a byte and of 16 zero bytes at the shared address a.
__device__ __forceinline__ void htt_sts_u8(unsigned a, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;\n"
               :: "r"(a), "h"(static_cast<unsigned short>(v)) : "memory");
}

__device__ __forceinline__ void htt_sts_zero16(unsigned a) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
               :: "r"(a), "r"(0u) : "memory");
}
