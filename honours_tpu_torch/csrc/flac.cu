// Kernel N: the flac decode, every block of a read in one walk.
//
// No TPU kernel stands behind it: honours_tpu decodes flac on the host
// only (honours_tpu/codecs/flac.py:132-170 FlacCodec.depress, a block at
// a time, its Rice codes a bit at a time in _rice_unbits), and this is
// its counterpart on the card.  A read is blocks of 4,096 samples (the
// last one shorter) end to end from byte 0 of its row:
//   [15][blen samples, i16 LE]                          verbatim, or
//   [order 0-4][k][warm-up i16 LE x order][Rice codes]  a fixed predictor
// The Rice codes are LSB-first within bytes: per residual q ones, a zero
// and the k value bits, LSB-first too; the residual is the zigzag z =
// (q << k) | bits, and the block's Rice bits end on a byte boundary.  A
// block's size does not follow from its header: the next header is the
// byte after the last of its blen - order codes, so a read is one walk.
// Samples: the warm-up, then x[j] = r + the order-th fixed prediction
// from x[j - 1 .. j - order] (the host's repeated integration, the same
// values mod 2^16), written as int16.  Row b holds n[b] samples (clamped
// to [0, L]), zeros to L.  A byte at or past the row's end reads as 0, so
// a cut stream decodes without a fault.  A header the press never writes
// (mode 5-14, an order not below the block's length, k above 30) ends
// the row's walk: its samples from that block on are 0.
//
// Bound on this card: the chain.  Each code starts where the one before
// it ends and each header where the block before it ends, so a read is
// one dependent walk of (unary run, value bits, prediction) steps; the
// bytes (about 1 a sample in, 2 a sample out) are small beside it.
// Design: one thread a read and a block a thread (THREADS = 1): the lanes
// of a warp would walk their reads' different paths in lockstep (at the
// main path's [256, 65536] on an H100 80GB HBM3 at 700 W, 32 threads a
// block took 2.4x as long as 1: tools/flac_threads.py).  A 64-bit bit
// buffer refilled a byte at a time (a 128-byte line serves 128 byte
// loads); a unary run by __ffs over 32-bit windows, 32 ones at a time
// past the first window, so a run of any length decodes; then k <= 30
// value bits from the same buffer.  Arithmetic is uint32, wrapping: the
// int16 result depends only on the low 16 bits of every term.
//
// Output ownership: row b's L samples are written by row b's thread only.

#include "common.cuh"

namespace {

constexpr int THREADS = 1;
constexpr long long BLOCK = 4096;
constexpr unsigned VERBATIM = 15;
constexpr unsigned MAX_ORDER = 4;
constexpr unsigned MAX_K = 30;

struct Row {
  const uint8_t* __restrict__ p;
  long long M;
  __device__ __forceinline__ unsigned byte(long long i) const {
    return i >= 0 && i < M ? static_cast<unsigned>(p[i]) : 0u;
  }
  __device__ __forceinline__ unsigned u16(long long i) const {
    return byte(i) | (byte(i + 1) << 8);
  }
};

// LSB-first bits of a row from a byte on; counts the bits it consumed
struct Bits {
  Row row;
  long long next;
  unsigned long long acc;
  int have;
  long long used;
  __device__ __forceinline__ Bits(Row r, long long at)
      : row(r), next(at), acc(0), have(0), used(0) {}
  __device__ __forceinline__ void refill() {
    while (have <= 56) {
      acc |= static_cast<unsigned long long>(row.byte(next++)) << have;
      have += 8;
    }
  }
  __device__ __forceinline__ void take(int c) {
    acc >>= c;
    have -= c;
    used += c;
  }
};

__global__ void __launch_bounds__(THREADS)
    flac_decode_kernel(const uint8_t* __restrict__ stream, long long B,
                       long long M, const int* __restrict__ n, long long L,
                       int16_t* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const Row row{stream + b * M, M};
  int16_t* o = out + b * L;
  const long long m = min(max(static_cast<long long>(n[b]), 0LL), L);
  long long off = 0, pos = 0;
  while (pos < m) {
    const long long blen = min(BLOCK, m - pos);
    const unsigned mode = row.byte(off);
    if (mode == VERBATIM) {
      for (long long j = 0; j < blen; ++j)
        o[pos + j] = static_cast<int16_t>(row.u16(off + 1 + 2 * j));
      off += 1 + 2 * blen;
      pos += blen;
      continue;
    }
    const unsigned k = row.byte(off + 1);
    if (mode > MAX_ORDER || mode >= blen || k > MAX_K) break;
    const unsigned order = mode;
    unsigned h1 = 0, h2 = 0, h3 = 0, h4 = 0;  // x[j-1] .. x[j-4]
    for (unsigned j = 0; j < order; ++j) {
      const unsigned x = row.u16(off + 2 + 2 * j);
      o[pos + j] = static_cast<int16_t>(x);
      h4 = h3;
      h3 = h2;
      h2 = h1;
      h1 = x;
    }
    const long long start = off + 2 + 2 * order;
    Bits bits(row, start);
    const unsigned kmask = (1u << k) - 1u;
    for (long long j = order; j < blen; ++j) {
      unsigned q = 0;
      for (;;) {
        bits.refill();
        const unsigned w = static_cast<unsigned>(bits.acc);
        if (w == 0xFFFFFFFFu) {  // 32 ones or more
          q += 32;
          bits.take(32);
          continue;
        }
        const int t = __ffs(~w) - 1;  // ones before the zero
        q += t;
        bits.take(t + 1);
        break;
      }
      bits.refill();
      const unsigned v = static_cast<unsigned>(bits.acc) & kmask;
      bits.take(static_cast<int>(k));
      const unsigned z = (q << k) | v;
      const unsigned r = (z >> 1) ^ (0u - (z & 1u));
      unsigned x;
      switch (order) {
        case 0: x = r; break;
        case 1: x = h1 + r; break;
        case 2: x = 2u * h1 - h2 + r; break;
        case 3: x = 3u * h1 - 3u * h2 + h3 + r; break;
        default: x = 4u * h1 - 6u * h2 + 4u * h3 - h4 + r; break;
      }
      o[pos + j] = static_cast<int16_t>(x);
      h4 = h3;
      h3 = h2;
      h2 = h1;
      h1 = x;
    }
    off = start + (bits.used + 7) / 8;
    pos += blen;
  }
  for (; pos < L; ++pos) o[pos] = 0;
}

}  // namespace

HTT_EXPORT int htt_flac_decode(const void* stream, long long B, long long M,
                               const void* n, long long L, void* out,
                               void* cuda_stream) {
  if (B > 0 && L > 0)
    flac_decode_kernel<<<static_cast<unsigned>((B + THREADS - 1) / THREADS),
                         THREADS, 0,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), B, M, static_cast<const int*>(n),
        L, static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
