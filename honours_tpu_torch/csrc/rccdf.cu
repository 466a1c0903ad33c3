// Kernels F and G: rccdf's per-read static-CDF rANS, encode and decode.
//
// No TPU kernel stands behind them: honours_tpu codes rccdf_vb*_zd on the
// host only, with numpy loops (honours_tpu/kernels/rans.py:67
// rans_encode_static and :126 rans_decode_static, reached through
// codecs/rc.py RcVbZdCodec), and these are their counterparts on the
// card, bit for bit.  A row's body: [16 states:u32 LE][16 lane lengths:
// u32 LE][lane 0 bytes]...; lane i codes bytes i, i + 16, ... of its row
// with the row's table of 12-bit frequencies (sum 4096).
//
// Bound on this card: each lane is a serial chain of steps (a division
// and a renormalisation in the encode; a table lookup, a multiply and a
// refill from the lane's bytes in the decode), ceil(n / 16) steps a row;
// the bytes (about 1 in, 0.4 out a coded byte) are small beside it.
// Design: one warp a row, its 16 lanes on threads 0-15, the row's table
// in shared memory.  The encode emits each lane's bytes into its own run
// of wrapper scratch (2 ceil(N / 16) bytes a lane) in emission order;
// then the warp writes the head and copies every lane's bytes reversed
// after the lane lengths before it.  The decode builds the row's slot ->
// symbol table (4,096 bytes, a binary search a slot over the cumulative
// frequencies) and the lanes' starts (a shuffle scan of their lengths),
// then each lane walks its bytes forward.
//
// Integers follow the plain versions (engine/rccdf.py): the encode's
// states stay below 2^31 (x < f << 19 after renormalising, so x / f <
// 2^19); the decode holds its states as int64 with two's-complement
// wrap and arithmetic right shifts, as PyTorch's int64 does, so a
// corrupt stream decodes to the same bytes on both routes.
//
// Output ownership: each block writes only its own row: the encode its
// head (threads 0-15, a state and a length each) and its lanes' bytes
// (each byte by one thread, lane after lane), the decode byte t * 16 + i
// by lane i.  The wrapper zeroes the outputs first.

#include "common.cuh"

namespace {

constexpr int K = 16;
constexpr int PROB_BITS = 12;
constexpr int SLOTS = 1 << PROB_BITS;
constexpr unsigned RANS_L = 1u << 23;
constexpr int RENORM_SHIFT = 23 - PROB_BITS + 8;
constexpr int HEAD = 8 * K;

__global__ void __launch_bounds__(32)
    rccdf_encode_kernel(const uint8_t* __restrict__ data, long long N,
                        const int* __restrict__ dlen,
                        const int* __restrict__ freqs,
                        const int* __restrict__ cum, uint8_t* __restrict__ out,
                        long long W, long long* __restrict__ blen,
                        uint8_t* __restrict__ scratch, long long cap) {
  __shared__ unsigned f_s[256], c_s[256];
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  for (unsigned s = t; s < 256; s += 32) {
    f_s[s] = static_cast<unsigned>(freqs[b * 256 + s]);
    c_s[s] = static_cast<unsigned>(cum[b * 256 + s]);
  }
  __syncwarp();
  const long long n = min(max(static_cast<long long>(dlen[b]), 0LL), N);
  const uint8_t* row = data + b * N;
  unsigned x = RANS_L;
  long long len = 0;
  if (t < K) {
    uint8_t* mine = scratch + (b * K + t) * cap;
    // the lane's symbols t, t + 16, ..., walked from the last
    const long long steps = n > t ? (n - 1 - t) / K + 1 : 0;
    for (long long j = steps - 1; j >= 0; --j) {
      const unsigned s = row[j * K + t];
      const unsigned f = f_s[s];
      const unsigned ub = f << RENORM_SHIFT;
      if (x >= ub) {
        mine[len++] = static_cast<uint8_t>(x);
        x >>= 8;
        if (x >= ub) {
          mine[len++] = static_cast<uint8_t>(x);
          x >>= 8;
        }
      }
      const unsigned q = x / f;
      x = (q << PROB_BITS) + (x - q * f) + c_s[s];
    }
  }
  // the lanes' starts: an exclusive scan of their lengths
  long long start = t < K ? len : 0;
#pragma unroll
  for (int o = 1; o < K; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, start, o);
    if (t >= static_cast<unsigned>(o)) start += y;
  }
  const long long total = __shfl_sync(0xffffffffu, start, K - 1);
  start -= t < K ? len : 0;
  uint8_t* orow = out + b * W;
  if (t < K) {
    for (int i = 0; i < 4; ++i) {
      orow[4 * t + i] = static_cast<uint8_t>(x >> (8 * i));
      orow[4 * K + 4 * t + i] = static_cast<uint8_t>(len >> (8 * i));
    }
  }
  if (t == 0) blen[b] = HEAD + total;
  __syncwarp();  // scratch written by every lane
  for (int i = 0; i < K; ++i) {
    const long long li = __shfl_sync(0xffffffffu, len, i);
    const long long si = __shfl_sync(0xffffffffu, start, i);
    const uint8_t* src = scratch + (b * K + i) * cap;
    for (long long j = t; j < li; j += 32)
      orow[HEAD + si + j] = src[li - 1 - j];
  }
}

// stream[b, pos] or 0 outside the row
__device__ __forceinline__ unsigned byte_at(const uint8_t* row, long long M,
                                            long long pos) {
  return pos >= 0 && pos < M ? row[pos] : 0u;
}

__global__ void __launch_bounds__(32)
    rccdf_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                        const int* __restrict__ off,
                        const int* __restrict__ count, long long N,
                        const int* __restrict__ freqs,
                        uint8_t* __restrict__ out) {
  __shared__ long long f_s[256], lo_s[256], hi_s[256];
  __shared__ uint8_t lut[SLOTS];
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  // cumulative frequencies: 8 symbols a thread, then a shuffle scan
  long long part = 0;
  for (int i = 0; i < 8; ++i) {
    const long long f = freqs[b * 256 + 8 * t + i];
    f_s[8 * t + i] = f;
    part += f;
  }
  long long inc = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (t >= static_cast<unsigned>(o)) inc += y;
  }
  long long acc = inc - part;
  for (int i = 0; i < 8; ++i) {
    lo_s[8 * t + i] = acc;
    acc += f_s[8 * t + i];
    hi_s[8 * t + i] = acc;
  }
  __syncwarp();
  // slot -> the first symbol whose high end passes it (255 past the sum)
  for (unsigned slot = t; slot < SLOTS; slot += 32) {
    int a = 0, z = 256;  // the answer lies in [a, z]
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (hi_s[mid] > static_cast<long long>(slot)) z = mid;
      else a = mid + 1;
    }
    lut[slot] = static_cast<uint8_t>(min(a, 255));
  }
  __syncwarp();

  const uint8_t* row = stream + b * M;
  const long long base = off[b];
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  unsigned long long x = 0;
  long long len = 0;
  if (t < K) {
    for (int i = 0; i < 4; ++i) {
      x |= static_cast<unsigned long long>(byte_at(row, M, base + 4 * t + i))
           << (8 * i);
      len |= static_cast<long long>(
                 byte_at(row, M, base + 4 * K + 4 * t + i)) << (8 * i);
    }
  }
  long long start = len;
#pragma unroll
  for (int o = 1; o < K; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, start, o);
    if (t >= static_cast<unsigned>(o)) start += y;
  }
  if (t >= K) return;
  long long pos = base + HEAD + start - len;
  uint8_t* orow = out + b * N;
  for (long long i = t; i < cnt; i += K) {
    const unsigned slot = static_cast<unsigned>(x) & (SLOTS - 1);
    const unsigned s = lut[slot];
    const long long q = static_cast<long long>(x) >> PROB_BITS;
    x = static_cast<unsigned long long>(f_s[s]) *
            static_cast<unsigned long long>(q) +
        slot - static_cast<unsigned long long>(lo_s[s]);
    orow[i] = static_cast<uint8_t>(s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (static_cast<long long>(x) < static_cast<long long>(RANS_L)) {
        x = (x << 8) | byte_at(row, M, pos);
        ++pos;
      }
    }
  }
}

}  // namespace

HTT_EXPORT int htt_rccdf_encode(const void* data, long long B, long long N,
                                const void* dlen, const void* freqs,
                                const void* cum, void* out, long long W,
                                void* blen, void* scratch, long long cap,
                                void* cuda_stream) {
  if (B > 0)
    rccdf_encode_kernel<<<static_cast<unsigned>(B), 32, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(data), N, static_cast<const int*>(dlen),
        static_cast<const int*>(freqs), static_cast<const int*>(cum),
        static_cast<uint8_t*>(out), W, static_cast<long long*>(blen),
        static_cast<uint8_t*>(scratch), cap);
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_rccdf_decode(const void* stream, long long B, long long M,
                                const void* off, const void* count,
                                long long N, const void* freqs, void* out,
                                void* cuda_stream) {
  if (B > 0)
    rccdf_decode_kernel<<<static_cast<unsigned>(B), 32, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M, static_cast<const int*>(off),
        static_cast<const int*>(count), N, static_cast<const int*>(freqs),
        static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
