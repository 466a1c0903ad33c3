// Kernel K: flat_uint_submin's optimal step-aligned partition, one read a
// block.
//
// No TPU kernel stands behind it: honours_tpu partitions on the host only
// (honours_tpu/codecs/flats.py:57 partition_flats, a Python double loop),
// and this is its counterpart on the card, cut for cut.  Over the
// candidate boundaries 0, step, 2 step, ..., and n (m = ceil(n / step)
// chunks, the last one short):
//   best[0] = 0,
//   best[j] = min over i < j of best[i] + 3
//             + ((b_j - b_i) minbits(max - min of u[b_i:b_j]) + 7) / 8,
// the smallest i winning a tie (the host's strict < with i ascending);
// then the prev chain from m back to 0 gives the cuts.  u is the samples
// as uint16; best is kept in int64 (the host's floats hold these
// integers exactly).
//
// Bound on this card: the chain.  Step j needs best[0..j-1], so the m
// steps run in order; a step does j independent (i, j) evaluations and a
// block-wide argmin.  O(m^2 / 2) evaluations a read: about 7.6 M at
// 250,000 samples (m = 3,907), 2.1 G at 4,194,000 (m = 65,532).
// Design: a block a read.  A pre-pass stores each chunk's (min, max);
// index i belongs to thread i % T, which keeps the range (min, max) of
// chunks i..j-1 (updated by chunk j - 1 at step j) and reads best[i],
// both in shared memory where a read's m fits it (else in the wrapper's
// scratch), so neither needs a barrier.  The argmin is a minimum over
// 64-bit keys (cost << 24 | i), so the least i wins a tie: a warp
// butterfly, one barrier, then every warp reduces the warps' keys
// (double-buffered by step parity) and the owner of index j keeps
// best[j]: one barrier a step.  Thread 0 walks the prev chain at the end.
// The wrapper bounds n (< 2^31) and m (< 2^24), so a key holds its cost.
//
// Output ownership: each block writes only its own row of cut (a 1 at
// each chosen boundary index 0..m; the wrapper zeroes cut first), of
// prev and of its scratch.

#include "common.cuh"

namespace {

// the dynamic shared memory a block may take (best and the ranges, 12 B
// an index): the wrapper keeps a read's state there up to this size
constexpr int SMEM_MAX = 200 * 1024;

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(1024)
    flats_partition_kernel(const int16_t* __restrict__ sig, long long L,
                           const int* __restrict__ n_arr, long long step,
                           long long mmax, unsigned* __restrict__ cmnx,
                           unsigned* __restrict__ smnx_g,
                           long long* __restrict__ best_g,
                           int* __restrict__ prev, uint8_t* __restrict__ cut,
                           int in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long red[2][32];
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x, T = blockDim.x;
  const unsigned lane = t & 31, w = t >> 5, warps = T >> 5;
  const long long n = min(max(static_cast<long long>(n_arr[b]), 0LL), L);
  const long long m = (n + step - 1) / step;
  const uint16_t* row = reinterpret_cast<const uint16_t*>(sig) + b * L;
  unsigned* cm = cmnx + b * mmax;
  long long* best = in_smem ? reinterpret_cast<long long*>(smem)
                            : best_g + b * (mmax + 1);
  unsigned* sm = in_smem
                     ? reinterpret_cast<unsigned*>(smem + 8 * (mmax + 1))
                     : smnx_g + b * mmax;
  int* pv = prev + b * (mmax + 1);

  for (long long c = t; c < m; c += T) {
    const long long lo = c * step, hi = min(lo + step, n);
    unsigned mn = 0xFFFFu, mx = 0;
    for (long long p = lo; p < hi; ++p) {
      const unsigned x = row[p];
      mn = min(mn, x);
      mx = max(mx, x);
    }
    cm[c] = mn | (mx << 16);
  }
  if (t == 0) best[0] = 0;
  __syncthreads();

  for (long long j = 1; j <= m; ++j) {
    const unsigned cj = cm[j - 1];
    const unsigned cn = cj & 0xFFFFu, cx = cj >> 16;
    const long long bj = min(j * step, n);
    unsigned long long key = ~0ULL;
    for (long long i = t; i < j; i += T) {
      unsigned mn = cn, mx = cx;
      if (i < j - 1) {
        const unsigned s = sm[i];
        mn = min(mn, s & 0xFFFFu);
        mx = max(mx, s >> 16);
      }
      sm[i] = mn | (mx << 16);
      const unsigned d = mx - mn;
      const long long bits = d ? 32 - __clz(d) : 0;
      const long long cost = best[i] + 3 + ((bj - i * step) * bits + 7) / 8;
      key = umin64(key, (static_cast<unsigned long long>(cost) << 24) |
                            static_cast<unsigned long long>(i));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      key = umin64(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (lane == 0) red[j & 1][w] = key;
    __syncthreads();
    key = lane < warps ? red[j & 1][lane] : ~0ULL;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      key = umin64(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (t == static_cast<unsigned>(j % T)) {
      best[j] = static_cast<long long>(key >> 24);
      pv[j] = static_cast<int>(key & 0xFFFFFFu);
    }
  }
  __syncthreads();
  if (t == 0) {
    uint8_t* c = cut + b * (mmax + 1);
    long long k = m;
    c[k] = 1;
    while (k != 0) {
      k = pv[k];
      c[k] = 1;
    }
  }
}

}  // namespace

HTT_EXPORT int htt_flats_partition(const void* sig, long long B, long long L,
                                   const void* n, long long step,
                                   long long mmax, void* cmnx, void* smnx,
                                   void* best, void* prev, void* cut,
                                   long long threads, long long smem_bytes,
                                   void* cuda_stream) {
  if (B > 0) {
    static bool smem_set[64];
    if (smem_bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (smem_bytes > 0)
      htt_smem_limit_once(flats_partition_kernel, SMEM_MAX, smem_set);
    flats_partition_kernel<<<static_cast<unsigned>(B),
                             static_cast<unsigned>(threads),
                             static_cast<size_t>(smem_bytes),
                             static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int16_t*>(sig), L, static_cast<const int*>(n),
        step, mmax, static_cast<unsigned*>(cmnx),
        static_cast<unsigned*>(smnx), static_cast<long long*>(best),
        static_cast<int*>(prev), static_cast<uint8_t*>(cut),
        smem_bytes > 0 ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}
