// Kernel B: Golomb-Rice decode of one bit stream per read.
//
// No TPU kernel stands behind it: honours_tpu decodes rice only on the
// host (honours_tpu/codecs/rice.py rice_decode, :66-84), and this is its
// counterpart on the card.  The stream (press/press.c:4893-4924) is
// LSB-first within bytes: a 3-bit header k2 k1 k0 (stream bit 0 is k's
// high bit), then per value q = v >> k ones, a zero and the k low bits of
// v MSB-first.  Row b's stream starts at byte off[b] of its row of M
// bytes (a negative off reads as 0); bytes at or past M read as 0, so a
// cut or garbage stream decodes without a fault (a row of 0xFF bytes is
// one unary run, q unbounded).  Out row b holds count[b] values (clamped
// to [0, N]), each the low 8 bits of (q << k) | bits, then zeros to N.
//
// Bound on this card: latency and issue of the walks.  Each code's start
// is known only once the code before it is decoded; the bytes (the
// stream in, a byte a value out) are small.
// Design: the chunked, self-synchronising decode of common.cuh
// (htt_chunked): one block of 512 threads a read, each thread a chunk of
// 256 stream bits (about 50 values), a tile of 131,072 bits staged in
// shared memory at a time, a thread's chunk in a stage column of its own.
// A walk from a wrong bit meets the true walk within a few codes (a unary
// run ends at the first zero whatever bit it starts on), so on the
// runner's streams a tile needs one fix-point round; the rounds need no
// bound on a code's length, which a garbage unary run lacks.  Past the
// stream's last nonzero byte every value is 0, so the chunks stop there.
// A step reads the 64 stream bits at its position from three staged
// words: a unary run of up to 32 ones with one __ffs(~window) (a longer
// run, possible for k < 3, reads on 32 bits at a time), then the k value
// bits by one bit reversal.  A warp-step takes about 450 cycles on the
// H100, and the emit pass (its walk and its scattered stores) is half of
// the kernel's time there (PERF.md, row B).
//
// Output ownership: stated in common.cuh (htt_chunked): each value byte
// is written by the thread whose chunk holds the value's code, in words
// where a whole aligned word is that thread's; the values past the last
// chunk's (all 0) and the zero tail to N by whole words across the block
// and their unaligned end bytes by thread 0.  Each block writes only its
// own row.

#include "common.cuh"

namespace {

using namespace htt_chunked;

struct Rice {
  int k;

  // the code at bit p: one code, its length and value
  __device__ __forceinline__ unsigned step(const Source& s, unsigned p,
                                           unsigned& len1, unsigned& len,
                                           unsigned& sym) const {
    unsigned long long w = s.peek64(p);
    unsigned q = 0;
    while (static_cast<unsigned>(w) == 0xFFFFFFFFu) {  // 32 ones or more
      q += 32;
      w = s.peek64(p + q);
    }
    const unsigned t = __ffs(~static_cast<unsigned>(w)) - 1;  // ones left
    const unsigned bits = static_cast<unsigned>(w >> (t + 1)) & ((1u << k) - 1u);
    const unsigned v = k ? __brev(bits) >> (32 - k) : 0u;
    q += t;
    len1 = len = q + 1 + k;
    sym = (q << k) | v;
    return 1;
  }
  // from any bit past the stream's last nonzero byte: values 0 without end
  __device__ __forceinline__ void tail(unsigned, unsigned& n,
                                       unsigned& sym) const {
    n = STOP;
    sym = 0;
  }
};

__global__ void __launch_bounds__(THREADS, 2)
    rice_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                       const int* __restrict__ off,
                       const int* __restrict__ count, long long N,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const long long b = blockIdx.x;
  const long long c = count[b];
  const unsigned cnt = static_cast<unsigned>(c < 0 ? 0 : (c > N ? N : c));
  const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
  Source src = make_source(stream + b * M, M, start);
  const unsigned h = src.peek32(0);
  const Rice code{static_cast<int>(((h & 1) << 2) | (h & 2) | ((h >> 2) & 1))};
  decode_row(code, src, 3u, static_cast<unsigned>(8 * (M - start)), cnt,
             out + b * N, static_cast<unsigned>(N), smem);
}

}  // namespace

HTT_EXPORT int htt_rice_decode(const void* stream, long long B, long long M,
                               const void* off, const void* count,
                               long long N, void* out, void* cuda_stream) {
  if (B > 0 && N > 0) {
    constexpr int bytes = 4 * SMEM_WORDS;
    static bool smem_set[64];
    htt_smem_limit_once(rice_decode_kernel, bytes, smem_set);
    rice_decode_kernel<<<static_cast<unsigned>(B), THREADS, bytes,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M,
        static_cast<const int*>(off), static_cast<const int*>(count), N,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
