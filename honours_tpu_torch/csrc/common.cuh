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

__device__ __forceinline__ uint4 htt_lds_u32x4(unsigned a) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
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

// ---------------------------------------------------------------------------
// Single-pass decoupled look-back (Merrill & Garland) over a row's tiles
// (kernels 1 and 6): a tile's state is one 64-bit word in a zeroed
// scratch the wrapper allocates, flag and value written by one store.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long htt_ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void htt_st_status(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The tile of this block, counted in launch order.  A row of one tile
// waits on no other, so it takes blockIdx and needs no scratch; wider
// rows take an atomic ticket from the word after the launch's states, so
// that the tiles a block waits on were handed out earlier and already
// hold an SM.
__device__ __forceinline__ long long htt_take_ticket(
    unsigned long long* status, long long tiles) {
  __shared__ long long s_ticket;
  if (tiles == 1) return blockIdx.x;
  if (threadIdx.x == 0)
    s_ticket = static_cast<long long>(atomicAdd(status + gridDim.x, 1ull));
  __syncthreads();
  return s_ticket;
}

// ---------------------------------------------------------------------------
// The rANS decode walks' stream window and refill (kernels 4, 4b and 8)
// ---------------------------------------------------------------------------

namespace htt_walk {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned RANS_L = 1u << 23;
constexpr int RING = 2048;     // stream bytes a read keeps in shared memory
constexpr int SEG = 512;       // a ring segment: 16 bytes a lane
constexpr int SEG_SHIFT = 9;

// A read's window of the stream.  Ring coordinate a = p + delta holds row
// byte p (delta = the row's offset in its 16-byte line) at ring + a % RING
// (ring: a RING-aligned shared address), and bytes outside the row read as
// 0.  Segments seg, seg+1 are resident, seg+2 and seg+3 in flight.  The
// walk keeps pa = a mod 2^32 of its pointer; pa reaching edge (the start
// of seg+1) moves the window on.
struct Window {
  const uint8_t* row;
  long long delta, Mb, seg;
  unsigned ring, pa, edge;
  int k;

  // lane k's 16 bytes of segment q: copied when inside the row, zeros
  // when outside it, byte by byte at the row's two ends
  __device__ __forceinline__ void fill(long long q) {
    const long long lo = q * SEG + 16 * k - delta;  // row byte at the line start
    const unsigned dst = ring | static_cast<unsigned>((q * SEG + 16 * k) & (RING - 1));
    if (lo >= 0 && lo + 16 <= Mb) {
      htt_cp_async16(dst, row + lo);
    } else if (lo + 16 <= 0 || lo >= Mb) {
      htt_sts_zero16(dst);
    } else {
      for (int j = 0; j < 16; ++j)
        htt_sts_u8(dst + j, lo + j >= 0 && lo + j < Mb ? row[lo + j] : 0);
    }
    htt_cp_commit();
  }

  __device__ __forceinline__ void start(const uint8_t* row_, long long Mb_,
                                        unsigned ring_, long long ptr,
                                        int lane) {
    row = row_;
    delta = reinterpret_cast<uintptr_t>(row_) & 15;
    ring = ring_;
    Mb = Mb_;
    k = lane;
    seg = (ptr + delta) >> SEG_SHIFT;
    pa = static_cast<unsigned>(ptr + delta);
    edge = static_cast<unsigned>((seg + 1) * SEG);
#pragma unroll
    for (int q = 0; q < 4; ++q) fill(seg + q);
    htt_cp_wait<2>();
    __syncwarp();
  }

  __device__ __forceinline__ unsigned byte(unsigned off) const {
    return htt_lds_u8(ring | ((pa + off) & (RING - 1)));
  }

  // after the pointer moved (by less than SEG - 64 bytes since the last
  // call): on entering a new segment, fetch the one three ahead into the
  // slot just left
  __device__ __forceinline__ void keep_up() {
    if (static_cast<int>(pa - edge) >= 0) {
      ++seg;
      edge += SEG;
      __syncwarp();
      fill(seg + 3);
      htt_cp_wait<2>();
      __syncwarp();
    }
  }
};

// the RING-aligned shared address of warp w's ring, past `used` bytes of
// the block's dynamic shared memory (which has RING bytes to spare)
__device__ __forceinline__ unsigned ring_of(const uint8_t* sm, long long used,
                                            int w) {
  const unsigned a = htt_shared_addr(sm) + static_cast<unsigned>(used);
  return ((a + RING - 1) & ~static_cast<unsigned>(RING - 1)) + w * RING;
}

// Both refill rounds of one step: a lane below RANS_L takes a byte in lane
// order, and one that was below 2^15 (so still below RANS_L after it) a
// second one after every first.  The pointer moves by at most 64 bytes;
// the caller calls win.keep_up() before it has moved SEG - 64.
__device__ __forceinline__ unsigned refill(unsigned x, bool active,
                                           Window& win, unsigned lt) {
  const bool n1 = active && x < RANS_L;
  const bool n2 = active && x < (RANS_L >> 8);
  const unsigned m1 = __ballot_sync(FULL, n1);
  const unsigned m2 = __ballot_sync(FULL, n2);
  const unsigned c1 = __popc(m1);
  const unsigned b1 = win.byte(__popc(m1 & lt));
  const unsigned b2 = win.byte(c1 + __popc(m2 & lt));
  x = n2 ? (x << 16) | (b1 << 8) | b2 : n1 ? (x << 8) | b1 : x;
  win.pa += c1 + __popc(m2);
  return x;
}

// bytes v (one each) into g[0, n)
__device__ __forceinline__ void put_bytes(uint8_t* g, const unsigned* v,
                                          int n) {
#pragma unroll
  for (int j = 0; j < n; ++j)
    g[j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));
}

// g[i, T) = sym: byte stores up to g's next 16-byte line, then lines
// (a warp's byte stores hit 32 rows, 32 sectors each)
__device__ __forceinline__ void fill_tail(uint8_t* g, int i, int T,
                                          unsigned sym) {
  const int head = min(T - i, static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(g + i) & 15)) & 15));
  for (int j = 0; j < head; ++j) g[i + j] = static_cast<uint8_t>(sym);
  i += head;
  const unsigned s4 = (sym & 255u) * 0x01010101u;
  for (; i + 16 <= T; i += 16)
    *reinterpret_cast<uint4*>(g + i) = make_uint4(s4, s4, s4, s4);
  for (; i < T; ++i) g[i] = static_cast<uint8_t>(sym);
}

}  // namespace htt_walk

// ---------------------------------------------------------------------------
// One-thread-a-read walks over LSB-first bit streams (kernels B and C)
// ---------------------------------------------------------------------------

namespace htt_serial {

// The stream of one row from byte `pos` on, LSB-first: `buf` holds nb
// bits, `pend` the next 4 bytes, loaded one refill ahead of their use.
// Loads are 4-byte words at word-aligned addresses (a row starts at any
// byte, so up to 3 bytes come one at a time first); bytes at or past M
// read as 0, so nothing past the row is read.
struct BitReader {
  const uint8_t* row;
  long long M, pos;
  unsigned long long buf = 0;
  int nb = 0;
  unsigned pend = 0;

  __device__ __forceinline__ unsigned byte_at(long long p) const {
    return p < M ? __ldg(row + p) : 0u;
  }
  __device__ __forceinline__ unsigned word_at(long long p) const {
    if (p + 4 <= M) return __ldg(reinterpret_cast<const unsigned*>(row + p));
    return byte_at(p) | byte_at(p + 1) << 8 | byte_at(p + 2) << 16 |
           byte_at(p + 3) << 24;
  }
  // at most 3 bytes (24 bits) into buf, then the first word into pend
  __device__ __forceinline__ void start() {
    while (reinterpret_cast<uintptr_t>(row + pos) & 3) {
      buf |= static_cast<unsigned long long>(byte_at(pos)) << nb;
      nb += 8;
      ++pos;
    }
    pend = word_at(pos);
    pos += 4;
  }
  // at least 33 bits in buf afterwards, from at least 1 before
  __device__ __forceinline__ void refill() {
    if (nb <= 32) {
      buf |= static_cast<unsigned long long>(pend) << nb;
      nb += 32;
      pend = word_at(pos);
      pos += 4;
    }
  }
  __device__ __forceinline__ void drop(int bits) {
    buf >>= bits;
    nb -= bits;
  }
};

}  // namespace htt_serial
