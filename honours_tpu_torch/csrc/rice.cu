// Kernel B: Golomb-Rice decode of one bit stream per read.
//
// No TPU kernel stands behind it: honours_tpu decodes rice only on the
// host (honours_tpu/codecs/rice.py rice_decode, :66-84), and this is its
// counterpart on the card.  The stream (press/press.c:4893-4924) is
// LSB-first within bytes: a 3-bit header k2 k1 k0 (stream bit 0 is k's
// high bit), then per value q = v >> k ones, a zero and the k low bits of
// v MSB-first.  Row b's stream starts at byte off[b] of its row of M
// bytes; bytes at or past M read as 0, so every walk ends inside the row
// and a cut stream decodes to garbage without a fault.  Out row b holds
// count[b] values (clamped to [0, N]), each the low 8 bits of
// (q << k) | bits, then zeros to N.
//
// Bound on this card: latency.  A read is one serial walk, a record's
// start known only once the record before it is decoded; its bytes
// (the stream in, a byte a value out) are small.
// Design: one thread per read and a block each, so no two reads share a
// warp and the data-dependent steps of one never wait on another's.  A
// 64-bit window of the stream, refilled a 4-byte word at a time (each
// word loaded one refill ahead) to at least 33 bits, gives a unary run of
// up to 32 ones with one __ffs(~window) (a longer run, possible for
// k < 3, takes a step each 32 ones); the k value bits follow from the
// window by one bit reversal.
// Values are stored four to a 32-bit word where N % 4 == 0 (the
// wrapper's output rows are then word-aligned), else a byte at a time.
// Each thread writes only its own row.

#include "common.cuh"

namespace {

// A row of N output bytes written in order: four to a 32-bit word where
// WORD (N % 4 == 0, so the wrapper's rows are word-aligned), else a byte
// at a time; finish() writes zeros from the next byte to N.
template <bool WORD>
struct ByteRow {
  uint8_t* o;
  unsigned word = 0;

  __device__ __forceinline__ void put(long long i, unsigned x) {
    if (WORD) {
      word |= (x & 0xFFu) << (8 * (i & 3));
      if ((i & 3) == 3) {
        reinterpret_cast<unsigned*>(o)[i >> 2] = word;
        word = 0;
      }
    } else {
      o[i] = static_cast<uint8_t>(x);
    }
  }
  // i: the bytes put so far
  __device__ __forceinline__ void finish(long long i, long long N) {
    if (WORD) {
      if (i & 3) {  // the last partial word, zeros after its bytes
        reinterpret_cast<unsigned*>(o)[i >> 2] = word;
        i = (i + 3) & ~3LL;
      }
      for (; i < N; i += 4) reinterpret_cast<unsigned*>(o)[i >> 2] = 0u;
    } else {
      for (; i < N; ++i) o[i] = 0;
    }
  }
};

template <bool WORD>
__global__ void __launch_bounds__(1)
    rice_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                       const int* __restrict__ off,
                       const int* __restrict__ count, long long N,
                       uint8_t* __restrict__ out) {
  const long long b = blockIdx.x;
  long long cnt = count[b];
  cnt = cnt < 0 ? 0 : (cnt > N ? N : cnt);
  const long long start = off[b] < 0 ? 0 : off[b];
  htt_serial::BitReader in{stream + b * M, M, start};
  ByteRow<WORD> o{out + b * N};

  in.start();  // at most 3 bytes, 24 bits
  in.refill();
  const int k = static_cast<int>(((in.buf & 1) << 2) | (in.buf & 2) |
                                 ((in.buf >> 2) & 1));
  in.drop(3);
  long long i = 0;
  for (; i < cnt; ++i) {
    unsigned q = 0;
    for (;;) {
      in.refill();
      const unsigned lo = static_cast<unsigned>(in.buf);
      if (lo != 0xFFFFFFFFu) {
        const int t = __ffs(~lo) - 1;  // ones before the terminating zero
        q += t;
        in.drop(t + 1);
        break;
      }
      q += 32;
      in.drop(32);
    }
    in.refill();  // k <= 7 bits, from the 1 or more left
    const unsigned bits = static_cast<unsigned>(in.buf) & ((1u << k) - 1u);
    const unsigned v = k ? __brev(bits) >> (32 - k) : 0u;
    in.drop(k);
    o.put(i, (q << k) | v);
  }
  o.finish(i, N);
}

}  // namespace

HTT_EXPORT int htt_rice_decode(const void* stream, long long B, long long M,
                               const void* off, const void* count,
                               long long N, void* out, void* cuda_stream) {
  if (B > 0 && N > 0) {
    const unsigned grid = static_cast<unsigned>(B);
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    const auto* s = static_cast<const uint8_t*>(stream);
    const auto* of = static_cast<const int*>(off);
    const auto* c = static_cast<const int*>(count);
    auto* o = static_cast<uint8_t*>(out);
    if (N % 4 == 0)
      rice_decode_kernel<true><<<grid, 1, 0, st>>>(s, M, of, c, N, o);
    else
      rice_decode_kernel<false><<<grid, 1, 0, st>>>(s, M, of, c, N, o);
  }
  return static_cast<int>(cudaGetLastError());
}
