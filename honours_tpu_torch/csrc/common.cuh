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
