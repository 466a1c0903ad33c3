// Kernel M: the segment-header walk of a stream of self-sized segments.
//
// No TPU kernel stands behind it: honours_tpu walks these headers on the
// host only (honours_tpu/codecs/pfor.py:62-78, turbopfor's block loop;
// honours_tpu/codecs/flats.py:116, flat_uint_submin's segment loop), and
// this is its counterpart on the card.  A row's segments lie end to end
// from byte first[b]; segment s holds count[b, s] items, and its size in
// bytes follows from its own header:
//   H + ceil(count * byte[off + ib] / 8) + E * byte[off + ie]
// (flats: H = 3, ib = 2, E = 0, the header [min:u16][b:1B]; turbopfor:
// H = 2, ib = 0, ie = 1, E = 3, the header [b:1B][nex:1B] and 3 bytes an
// exception).  out[b, s] is segment s's offset for s < nseg[b] (clamped
// to [0, S]); from s = nseg[b] on it is the byte after the last segment.
// A byte at or past the row's end (or before its start) reads as 0, so a
// cut stream walks on without a fault; a negative count counts as 0.
//
// Bound on this card: the chain.  Each header's offset is known only once
// the header before it is read, so a row is one dependent chain of
// (load a byte, multiply, add) steps, S of them; the bytes (a few a
// segment read, 8 a segment written) are small beside it.
// Design: one thread a row, a warp a block so a bucket's rows spread over
// the SMs.  The counts are read in order (a 128-byte line serves 16
// steps) and only the header bytes touch the stream.
//
// Output ownership: row b's S offsets are written by row b's thread only.

#include "common.cuh"

namespace {

__device__ __forceinline__ long long byte_at(const uint8_t* __restrict__ row,
                                             long long M, long long p) {
  return p >= 0 && p < M ? static_cast<long long>(row[p]) : 0LL;
}

__global__ void __launch_bounds__(32)
    hdrwalk_kernel(const uint8_t* __restrict__ stream, long long B,
                   long long M, const long long* __restrict__ first,
                   const long long* __restrict__ nseg,
                   const long long* __restrict__ count, long long S,
                   long long H, long long ib, long long ie, long long E,
                   long long* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = stream + b * M;
  const long long* cnt = count + b * S;
  long long* o = out + b * S;
  const long long m = min(max(nseg[b], 0LL), S);
  long long off = first[b];
  for (long long s = 0; s < m; ++s) {
    o[s] = off;
    const long long c = max(cnt[s], 0LL);
    long long size = H + (c * byte_at(row, M, off + ib) + 7) / 8;
    if (E) size += E * byte_at(row, M, off + ie);
    off += size;
  }
  for (long long s = m; s < S; ++s) o[s] = off;
}

}  // namespace

HTT_EXPORT int htt_hdrwalk(const void* stream, long long B, long long M,
                           const void* first, const void* nseg,
                           const void* count, long long S, long long H,
                           long long ib, long long ie, long long E, void* out,
                           void* cuda_stream) {
  if (B > 0 && S > 0)
    hdrwalk_kernel<<<static_cast<unsigned>((B + 31) / 32), 32, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), B, M,
        static_cast<const long long*>(first),
        static_cast<const long long*>(nseg),
        static_cast<const long long*>(count), S, H, ib, ie, E,
        static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
