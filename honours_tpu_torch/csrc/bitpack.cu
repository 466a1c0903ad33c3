// Kernels I and J: MSB-first fixed-width bit packing and unpacking over
// ragged rows.
//
// No TPU kernel stands behind them: honours_tpu packs the uint family's
// and flat_uint_submin's fields on the host only (honours_tpu/kernels/
// bitpack.py:26 pack_bits and :38 unpack_bits, numpy bit matrices,
// reached through codecs/uintc.py and codecs/flats.py), and these are
// their counterparts on the card.  A row r is (its values at val_off[r],
// count[r] fields of width b = width[r], clamped to [0, 16]): field i
// holds the low b bits of value i, MSB-first at stream bits [i b, i b +
// b) of the row, the last byte padded with zeros in its low bits, as
// np.packbits does; the row's ceil(count b / 8) bytes sit at out_off[r].
// The uint codecs have one row a read, flat_uint_submin one a segment.
//
// Bound on this card: bytes.  Each value is read once (4 B), each packed
// byte written once; a field needs a few shifts and masks.
// Design: no scan and no atomic.  The wrapper gives the exclusive prefix
// of the rows' packed bytes (I) or counts (J), [R + 1] with the total
// last; a grid-stride loop runs one thread an output byte (I) or a field
// (J), finds its row by a binary search of that prefix (rows in order,
// so a warp's threads mostly share a row and its search path), and reads
// the total from the card, so the launch needs no host sync.  I gathers
// the fields that overlap its byte (at most 8 / b + 2, 40 bits) into one
// 64-bit word; J reads the at most 3 bytes that hold its b <= 16 bits at
// byte (i b) >> 3 of its row, each checked against the row's byte length
// (a byte past it, or outside the stream, reads as 0, so a cut stream
// cannot read past its row).
//
// Output ownership: I writes byte j of row r only from the thread of
// (r, j); rows' byte ranges are the caller's to keep apart.  J writes
// out[out_off[r] + i] only from the thread of field (r, i).

#include "common.cuh"

namespace {

// The row r with off[r] <= t < off[r + 1] of a non-decreasing [R + 1]
// prefix with off[0] = 0 and t < off[R].
__device__ __forceinline__ long long row_of(const long long* __restrict__ off,
                                            long long R, long long t) {
  long long lo = 0, hi = R;
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (off[mid] <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int clamp_width(long long b) {
  return static_cast<int>(b < 0 ? 0 : (b > 16 ? 16 : b));
}

__global__ void __launch_bounds__(256)
    bitpack_kernel(const int* __restrict__ values,
                   const long long* __restrict__ val_off,
                   const long long* __restrict__ count,
                   const long long* __restrict__ width,
                   const long long* __restrict__ pk_off, long long R,
                   uint8_t* __restrict__ out,
                   const long long* __restrict__ out_off) {
  const long long total = pk_off[R];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long r = row_of(pk_off, R, t);
    const long long j = t - pk_off[r];
    const int b = clamp_width(width[r]);  // >= 1: the row has bytes
    const unsigned mask = (1u << b) - 1u;
    const long long lo = 8 * j, hi = lo + 8;
    const long long i0 = lo / b;
    const long long i1 = min((hi - 1) / b, count[r] - 1);
    const int* v = values + val_off[r];
    unsigned long long acc = 0;  // fields i0..i1: bits [i0 b, (i1 + 1) b)
    for (long long i = i0; i <= i1; ++i)
      acc = (acc << b) | (static_cast<unsigned>(v[i]) & mask);
    const long long end = (i1 + 1) * b;
    const unsigned long long byte =
        end >= hi ? acc >> (end - hi) : acc << (hi - end);
    out[out_off[r] + j] = static_cast<uint8_t>(byte);
  }
}

__global__ void __launch_bounds__(256)
    bitunpack_kernel(const uint8_t* __restrict__ stream, long long S,
                     const long long* __restrict__ in_off,
                     const long long* __restrict__ in_len,
                     const long long* __restrict__ width,
                     const long long* __restrict__ cnt_off, long long R,
                     int* __restrict__ out,
                     const long long* __restrict__ out_off) {
  const long long total = cnt_off[R];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long r = row_of(cnt_off, R, t);
    const long long i = t - cnt_off[r];
    const int b = clamp_width(width[r]);
    const long long bit0 = i * b;
    const long long base = in_off[r], len = in_len[r];
    unsigned win = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const long long pos = (bit0 >> 3) + q;
      const long long src = base + pos;
      const unsigned x =
          pos < len && src >= 0 && src < S ? stream[src] : 0u;
      win = (win << 8) | x;
    }
    const int sh = 24 - static_cast<int>(bit0 & 7) - b;
    out[out_off[r] + i] = static_cast<int>((win >> sh) & ((1u << b) - 1u));
  }
}

}  // namespace

HTT_EXPORT int htt_bitpack_msb(const void* values, const void* val_off,
                               const void* count, const void* width,
                               const void* pk_off, long long R, void* out,
                               const void* out_off, long long blocks,
                               void* cuda_stream) {
  if (R > 0 && blocks > 0)
    bitpack_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(values),
        static_cast<const long long*>(val_off),
        static_cast<const long long*>(count),
        static_cast<const long long*>(width),
        static_cast<const long long*>(pk_off), R, static_cast<uint8_t*>(out),
        static_cast<const long long*>(out_off));
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_bitunpack_msb(const void* stream, long long S,
                                 const void* in_off, const void* in_len,
                                 const void* width, const void* cnt_off,
                                 long long R, void* out, const void* out_off,
                                 long long blocks, void* cuda_stream) {
  if (R > 0 && blocks > 0)
    bitunpack_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), S,
        static_cast<const long long*>(in_off),
        static_cast<const long long*>(in_len),
        static_cast<const long long*>(width),
        static_cast<const long long*>(cnt_off), R, static_cast<int*>(out),
        static_cast<const long long*>(out_off));
  return static_cast<int>(cudaGetLastError());
}
