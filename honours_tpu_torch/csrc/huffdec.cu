// Kernel C: static-Huffman decode of one LSB-first bit stream per read.
//
// No TPU kernel stands behind it: honours_tpu decodes shuffman_vbbe21_zd
// only on the host (honours_tpu/codecs/huffman.py:49
// shuffman_decode_memory through native/huffdec.c:13 ht_huffman_decode),
// and this is its counterpart on the card.  The walk is the C's: a
// window of the next 22 stream bits (bit 0 the first) indexes a LUT of
// (symbol, code length); the symbol is emitted and the length consumed.
// Row b's stream starts at byte off[b] of its row of M bytes (a negative
// off reads as 0); bytes at or past M read as 0, and nothing past the row
// is read.  The walk stops at a zero length (a window no code starts, the
// C's corrupt-stream guard) and at a code that would run past the row's
// last byte (a cut stream; an off past M leaves no bits).  got[b] is the
// symbols decoded: count[b] (clamped to [0, N]) unless the walk stopped
// first.  Out row b holds them, then zeros to N.
//
// Tables (engine/huffdec_cuda.py decode_tables): lut, 2^22 entries of
// sym | len << 8 (uint16, 8 MiB, left in L2), and l1, 4,096 uint32
// entries over 12-bit windows: sym1 | len1 << 8 | sym2 << 16 | len12 << 24
// where the window holds a code of at most 12 bits (most symbols of
// nanopore residuals) and, where it holds the next code whole, that code
// (len12 the two codes' bits, else 0); 0 where the window holds no whole
// code, which sends the step to lut.
//
// Bound on this card: latency and issue of the walks.  Each symbol's
// start is known only once the symbol before it is decoded; the bytes
// (about 0.7 in, 1 out a symbol) are small.
// Design: the chunked, self-synchronising decode of common.cuh
// (htt_chunked): one block of 512 threads a read, each thread a chunk of
// 256 stream bits (about 45 symbols), a tile of 131,072 bits staged in
// shared memory at a time, l1 copied into shared memory once.  Huffman
// codes resynchronise within a few codes, so on the runner's streams a
// tile needs one or two fix-point rounds.  The stops are properties of a
// bit position (a zero length, or a code past the row's end), so the
// walk from a position still depends on it alone: a walk that meets one
// exits with STOP, and the chunks after it take no symbols.  Past the
// stream's last nonzero byte the walk is the zero window's code repeated
// to the row's end, counted without walking.  The speculation and the
// emit take two symbols a step where l1 holds both; a code longer than
// 12 bits (2.4% of them) reads lut in L2 (a second level for them in
// shared memory gained nothing on the H100: PERF.md, row C).
//
// Output ownership: stated in common.cuh (htt_chunked): each symbol byte
// is written by the thread whose chunk holds the symbol's code, in words
// where a whole aligned word is that thread's; the symbols past the last
// chunk's (the zero window's) and the zero tail [got, N) by whole words
// across the block and their unaligned end bytes by thread 0, which also
// writes got[b].  Each block writes only its own row.

#include "common.cuh"

namespace {

using namespace htt_chunked;

constexpr int L1_BITS = 12;
constexpr int L1_WORDS = 1 << L1_BITS;
constexpr int LUT_BITS = 22;
constexpr unsigned L1_MASK = (1u << L1_BITS) - 1u;
constexpr unsigned long long LUT_MASK = (1ull << LUT_BITS) - 1ull;

struct Huffman {
  const unsigned* l1;   // shared memory
  const uint16_t* lut;  // device memory
  unsigned limit;       // the stream bits the row holds

  // the codes at bit p: 0 at a stop; else the first code's length len1
  // and symbol (the low byte of sym), and 2 where l1 holds the next code
  // too and it ends inside the row (len the two codes' bits, sym's
  // second byte the second symbol), else 1 (len = len1)
  __device__ __forceinline__ unsigned step(const Source& s, unsigned p,
                                           unsigned& len1, unsigned& len,
                                           unsigned& sym) const {
    const unsigned w = s.peek32(p);
    unsigned e = l1[w & L1_MASK];
    unsigned n = (e >> 8) & 31u;
    if (n == 0) {  // a code longer than 12 bits, or none
      e = __ldg(lut + (w & LUT_MASK));
      n = e >> 8;
      if (n == 0 || p + n > limit) return 0;
      len1 = len = n;
      sym = e & 0xFFu;
      return 1;
    }
    if (p + n > limit) return 0;
    len1 = len = n;
    sym = e & 0xFFu;
    const unsigned n12 = e >> 24;
    if (n12 == 0 || p + n12 > limit) return 1;
    len = n12;
    sym |= (e >> 8) & 0xFF00u;
    return 2;
  }
  // from bit e past the stream's last nonzero byte: the zero window's
  // code up to the row's end (none where no code is all zeros)
  __device__ __forceinline__ void tail(unsigned e, unsigned& n,
                                       unsigned& sym) const {
    const unsigned z = __ldg(lut);
    n = (z >> 8) ? (limit - e) / (z >> 8) : 0u;
    sym = z & 0xFFu;
  }
};

__global__ void __launch_bounds__(THREADS, 2)
    huffman_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                          const int* __restrict__ off,
                          const int* __restrict__ count, int N,
                          const unsigned* __restrict__ l1g,
                          const uint16_t* __restrict__ lut,
                          uint8_t* __restrict__ out, int* __restrict__ got) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* l1 = smem;  // then the decode's words
  // 16 KiB in 16-byte pieces (the wrapper checks l1g is 16-byte aligned)
  for (int j = threadIdx.x; j < L1_WORDS / 4; j += THREADS)
    reinterpret_cast<uint4*>(l1)[j] =
        __ldg(reinterpret_cast<const uint4*>(l1g) + j);
  __syncthreads();

  const long long b = blockIdx.x;
  const unsigned cnt = static_cast<unsigned>(min(max(count[b], 0), N));
  const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
  const unsigned limit = static_cast<unsigned>(8 * (M - start));
  Source src = make_source(stream + b * M, M, start);
  const Huffman code{l1, lut, limit};
  const unsigned n = decode_row(code, src, 0u, limit, cnt,
                                out + b * static_cast<long long>(N),
                                static_cast<unsigned>(N), smem + L1_WORDS);
  if (threadIdx.x == 0) got[b] = static_cast<int>(n);
}

}  // namespace

HTT_EXPORT int htt_huffman_decode(const void* stream, long long B,
                                  long long M, const void* off,
                                  const void* count, long long N,
                                  const void* l1, const void* lut, void* out,
                                  void* got, void* cuda_stream) {
  if (B > 0) {
    constexpr int bytes = 4 * (L1_WORDS + SMEM_WORDS);
    static bool smem_set[64];
    htt_smem_limit_once(huffman_decode_kernel, bytes, smem_set);
    huffman_decode_kernel<<<static_cast<unsigned>(B), THREADS, bytes,
                            static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M,
        static_cast<const int*>(off), static_cast<const int*>(count),
        static_cast<int>(N), static_cast<const unsigned*>(l1),
        static_cast<const uint16_t*>(lut), static_cast<uint8_t*>(out),
        static_cast<int*>(got));
  }
  return static_cast<int>(cudaGetLastError());
}
