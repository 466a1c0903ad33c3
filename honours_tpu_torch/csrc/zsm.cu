// Kernel L: uint_zsm's running mean, a block a read.
//
// No TPU kernel stands behind it: honours_tpu takes the mean on the host
// only (honours_tpu/codecs/uintc.py:128 UintZsmCodec._mean16, the
// reference's get_mean_16, press/util.c:74-88), and this is its
// counterpart on the card, bit for bit: mean = 0.0, then mean += (x_i -
// mean) / (i + 1) in float64 for i = 0 .. n - 1, then truncation toward
// zero.  That recurrence rounds at every step and is not associative, so
// it cannot be split over threads; but only its truncation is returned,
// and for almost every read that follows from the read's exact sum.
//
// The settled rule.  Let S be the exact sum of the read's n samples, so
// that its exact mean is S / n.  With u = 2^-53, |x_i| <= 2^15 and |mean|
// <= 2^15, step i (from 1) scales the error it inherits by (i - 1) / i <=
// 1 and adds at most 2u 2^16 / i (the rounded subtract and divide) and
// u 2^15 (the rounded add), so
//     |running mean - S / n| <= 2^-38 n + 2^-36 (1 + ln n) < eps(n),
//     eps(n) = (n + 64) 2^-37,
// with a margin of 2 (1.99999 at n = 2^22, more below).  Truncation toward
// zero jumps only at nonzero integers, so where no nonzero integer lies
// within eps(n) of S / n, the answer is C's truncating S / n.  In
// integers, with r = |S| mod n, a read of 1 <= n <= 2^22 samples is
// settled when S = 0 or 2^37 min(r, n - r) > n (n + 64) (both sides below
// 2^59).  Up to n of about 370,000 that is "S / n is not an integer"; at
// n = 2^22 it flags the means within 128 / n of an integer.  The other
// reads (flagged, and those of more than 2^22 samples) take the chain.
// tests/test_torch_zsm_model.py holds a numpy model of the rule to the
// reference's mean, and the bound to the running mean, on edge reads.
//
// Bound on this card: the bytes (2 B a sample read once) for a settled
// read; a flagged read costs its chain of n dependent float64 (subtract,
// divide, add) steps, the divide the longest.
// Design: one block of 256 threads a read.  The threads sum its first n
// samples exactly: 16-byte loads of 8 samples where the row is aligned
// (a scalar head and tail), int32 sums of a load, int64 over the read,
// then a warp-shuffle and shared-memory reduction.  Thread 0 applies the
// settled rule; for a flagged read it walks the chain in the same launch,
// samples in order, 8 a 16-byte load issued a group ahead, with
// __dsub_rn / __ddiv_rn / __dadd_rn, which nvcc never contracts into a
// fused multiply-add, so each rounds as the host's does.  Row b's mean is
// written to out[b] by thread 0; n is clamped to [0, L] and an empty read
// gives 0.  A bucket of flagged reads costs its longest chain and one read
// of the bucket: every read's block is resident at once at the bucket's B.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SETTLED_MAX = 1LL << 22;  // eps(n) holds to here

// the two int16 samples of a 32-bit word, low one first (little endian)
__device__ __forceinline__ int lo16(int w) {
  return static_cast<int>(static_cast<int16_t>(w & 0xFFFF));
}
__device__ __forceinline__ int hi16(int w) { return w >> 16; }

__device__ __forceinline__ int sum8(int4 v) {
  return lo16(v.x) + hi16(v.x) + lo16(v.y) + hi16(v.y) + lo16(v.z) +
         hi16(v.z) + lo16(v.w) + hi16(v.w);
}

// samples before the row's first 16-byte boundary (at most m)
__device__ __forceinline__ long long aligned_head(const int16_t* row,
                                                  long long m) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(row));
  return min(m, static_cast<long long>(((16u - (a & 15u)) & 15u) >> 1));
}

__device__ __forceinline__ double mean_step(double mean, int x, long long i) {
  return __dadd_rn(mean, __ddiv_rn(__dsub_rn(static_cast<double>(x), mean),
                                   static_cast<double>(i + 1)));
}

// get_mean_16's chain over row[0 .. m), before its truncation
__device__ double running_mean(const int16_t* row, long long m) {
  double mean = 0.0;
  const long long head = aligned_head(row, m);
  long long i = 0;
  for (; i < head; ++i) mean = mean_step(mean, row[i], i);
  const int4* v = reinterpret_cast<const int4*>(row + head);
  const long long nv = (m - head) >> 3;
  int4 w = nv > 0 ? v[0] : make_int4(0, 0, 0, 0);
  for (long long k = 0; k < nv; ++k) {
    const int4 next = v[min(k + 1, nv - 1)];  // off the chain
    const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mean = mean_step(mean, lo16(words[j]), i++);
      mean = mean_step(mean, hi16(words[j]), i++);
    }
    w = next;
  }
  for (; i < m; ++i) mean = mean_step(mean, row[i], i);
  return mean;
}

__global__ void __launch_bounds__(THREADS)
    zsm_mean_kernel(const int16_t* __restrict__ sig, long long L,
                    const int* __restrict__ n, long long* __restrict__ out) {
  __shared__ long long part[THREADS / 32];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const long long m = min(max(static_cast<long long>(n[b]), 0LL), L);
  const int16_t* row = sig + b * L;

  // the exact sum of row[0 .. m)
  const long long head = aligned_head(row, m);
  long long s = t < head ? row[t] : 0;
  const int4* v = reinterpret_cast<const int4*>(row + head);
  const long long nv = (m - head) >> 3;
#pragma unroll 4
  for (long long k = t; k < nv; k += THREADS) s += sum8(v[k]);
  for (long long i = head + 8 * nv + t; i < m; i += THREADS) s += row[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  if ((t & 31) == 0) part[t >> 5] = s;
  __syncthreads();
  if (t != 0) return;
  long long S = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) S += part[w];

  if (m == 0) {
    out[b] = 0;
    return;
  }
  if (m <= SETTLED_MAX) {
    const unsigned long long um = static_cast<unsigned long long>(m);
    const unsigned long long r =
        static_cast<unsigned long long>(S < 0 ? -S : S) % um;
    const unsigned long long d = min(r, um - r);
    if (S == 0 || (d << 37) > um * (um + 64)) {
      out[b] = S / m;  // C's division: toward zero
      return;
    }
  }
  out[b] = static_cast<long long>(running_mean(row, m));  // toward zero
}

}  // namespace

HTT_EXPORT int htt_zsm_mean(const void* sig, long long B, long long L,
                            const void* n, void* out, void* cuda_stream) {
  if (B > 0)
    zsm_mean_kernel<<<static_cast<unsigned>(B), THREADS, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int16_t*>(sig), L, static_cast<const int*>(n),
        static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
