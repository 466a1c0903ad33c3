// Kernel C: static-Huffman decode of one LSB-first bit stream per read;
// and C2, its entry with a table of its own for each read.
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
// C2 (huffman_decode_rows) keeps C's contract and walk with a table for
// each row (huffman_vb*_zd's per-read tables, honours_tpu/codecs/
// huffman.py:39 huffman_decode_memory on the host: native/huffdec.c:13's
// LUT walk, and a search of the codes above 24 bits), codes of 1 to 32
// bits a symbol.  A row's table comes as lengths (-1 for an absent
// symbol) and codes; entries of length 0 or above 32, or with code bits
// above their length, never match, except that a table whose present
// symbols all have length 0 (a lone symbol's) decodes count copies of
// its lowest one.  The block builds the row's l1 in shared memory (as C's,
// from the codes of up to 12 bits) and, for the longer codes, a list
// sorted by their low 12 bits: where a 12-bit window starts no short code
// but starts long ones, its l1 word holds their run in the list, start |
// count << 16 (length bits 0), and the step searches that run.  The tail
// takes the row's zero-window code.  For a table that is not prefix-free,
// which code a window takes is unspecified.
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

// C2's code: a row's l1 and its long codes, in shared memory
constexpr int SYMS = 256;
struct RowHuffman {
  const unsigned* l1;
  const unsigned* lcode;  // the long codes, sorted by their low 12 bits
  const unsigned* lmeta;  // sym | len << 8 of each
  unsigned limit;
  unsigned zlen, zsym;  // the zero window's code (zlen 0: none)

  // the long code at window w, whose l1 word is e; false where none
  __device__ __forceinline__ bool search(unsigned w, unsigned e, unsigned& n,
                                         unsigned& sym) const {
    const unsigned a = e & 0xFFu, z = a + ((e >> 16) & 0x1FFu);
    for (unsigned i = a; i < z; ++i) {
      const unsigned m = lmeta[i], L = m >> 8;
      const unsigned mask = L >= 32 ? ~0u : (1u << L) - 1u;
      if ((w & mask) == lcode[i]) {
        n = L;
        sym = m & 0xFFu;
        return true;
      }
    }
    return false;
  }
  __device__ __forceinline__ unsigned step(const Source& s, unsigned p,
                                           unsigned& len1, unsigned& len,
                                           unsigned& sym) const {
    const unsigned w = s.peek32(p);
    const unsigned e = l1[w & L1_MASK];
    unsigned n = (e >> 8) & 31;
    if (n == 0) {  // a code longer than 12 bits, or none
      if (!search(w, e, n, sym) || p + n > limit) return 0;
      len1 = len = n;
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
  __device__ __forceinline__ void tail(unsigned e, unsigned& n,
                                       unsigned& sym) const {
    n = zlen ? (limit - e) / zlen : 0u;
    sym = zsym;
  }
};

// C2's shared memory before the decode's words: l1, the long list
// (codes, metas), each symbol's sort key, and 4 words of the row's
// scalars
constexpr int ROW_TABLE_WORDS = L1_WORDS + 3 * SYMS + 4;

__global__ void __launch_bounds__(THREADS, 2)
    huffman_decode_rows_kernel(const uint8_t* __restrict__ stream,
                               long long M, const int* __restrict__ off,
                               const int* __restrict__ count, int N,
                               const int* __restrict__ lengths,
                               const long long* __restrict__ codes,
                               uint8_t* __restrict__ out,
                               int* __restrict__ got) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* l1 = smem;
  unsigned* lcode = l1 + L1_WORDS;
  unsigned* lmeta = lcode + SYMS;
  unsigned* key = lmeta + SYMS;
  unsigned* row_s = key + SYMS;  // lone symbol, zero code's len and sym,
                                 // and whether a present length is not 0
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  for (unsigned j = t; j < L1_WORDS; j += THREADS) l1[j] = 0;
  if (t == 0) {
    row_s[0] = ~0u;
    row_s[1] = row_s[2] = row_s[3] = 0;
  }
  __syncthreads();
  // each symbol's entry: short codes fill l1, long ones get a sort key
  unsigned L = 0, code = 0;
  bool present = false, usable = false;
  if (t < SYMS) {
    const int li = lengths[b * SYMS + t];
    const long long ci = codes[b * SYMS + t];
    present = li >= 0;
    usable = li >= 1 && li <= 32 && ci >= 0 && (ci >> li) == 0;
    L = usable ? static_cast<unsigned>(li) : 0u;
    code = static_cast<unsigned>(ci);
    key[t] = usable && L > L1_BITS ? (code & L1_MASK) << 8 | t : ~0u;
    if (usable && L <= L1_BITS)
      for (unsigned k = 0; k < (1u << (L1_BITS - L)); ++k)
        l1[code | k << L] = t | L << 8;
    if (present && li != 0) atomicOr(row_s + 3, 1u);  // not all length 0
  }
  __syncthreads();
  if (t < SYMS && present && row_s[3] == 0) atomicMin(row_s, t);
  // second codes where a window holds two short ones whole
  unsigned two[L1_WORDS / THREADS];
#pragma unroll
  for (int i = 0; i < L1_WORDS / THREADS; ++i) {
    const unsigned w = t + i * THREADS, e = l1[w], n1 = (e >> 8) & 31;
    two[i] = e;
    if (n1 >= 1 && n1 <= L1_BITS) {
      const unsigned e2 = l1[w >> n1], n2 = (e2 >> 8) & 31;
      if (n2 >= 1 && n1 + n2 <= L1_BITS)
        two[i] = e | (e2 & 0xFFu) << 16 | (n1 + n2) << 24;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < L1_WORDS / THREADS; ++i) l1[t + i * THREADS] = two[i];
  __syncthreads();
  // the long codes sorted by key; a run's first marks its window in l1
  if (t < SYMS && key[t] != ~0u) {
    const unsigned k = key[t], pre = k >> 8;
    unsigned rank = 0, first = 0, runs = 0;
    for (int j = 0; j < SYMS; ++j) {
      const unsigned kj = key[j];
      rank += kj < k;
      first += kj != ~0u && (kj >> 8) < pre;
      runs += kj != ~0u && (kj >> 8) == pre;
    }
    lcode[rank] = code;
    lmeta[rank] = t | L << 8;
    if (rank == first && l1[pre] == 0) l1[pre] = first | runs << 16;
  }
  __syncthreads();
  if (t == 0) {  // the zero window's code
    const unsigned e = l1[0];
    unsigned n = (e >> 8) & 31, sym = e & 0xFFu;
    if (n == 0 && !RowHuffman{l1, lcode, lmeta, 0, 0, 0}.search(0, e, n, sym))
      n = 0;
    row_s[1] = n;
    row_s[2] = sym;
  }
  __syncthreads();

  const unsigned cnt = static_cast<unsigned>(min(max(count[b], 0), N));
  uint8_t* row = out + b * static_cast<long long>(N);
  unsigned n;
  if (row_s[0] != ~0u) {  // a lone symbol of length 0
    n = cnt;
    fill(row, 0, cnt, row_s[0]);
    fill(row, cnt, static_cast<unsigned>(N), 0u);
  } else {
    const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
    const unsigned limit = static_cast<unsigned>(8 * (M - start));
    Source src = make_source(stream + b * M, M, start);
    const RowHuffman code_of{l1, lcode, lmeta, limit, row_s[1], row_s[2]};
    n = decode_row(code_of, src, 0u, limit, cnt, row,
                   static_cast<unsigned>(N), smem + ROW_TABLE_WORDS);
  }
  if (t == 0) got[b] = static_cast<int>(n);
}

}  // namespace

HTT_EXPORT int htt_huffman_decode_rows(const void* stream, long long B,
                                       long long M, const void* off,
                                       const void* count, long long N,
                                       const void* lengths, const void* codes,
                                       void* out, void* got,
                                       void* cuda_stream) {
  if (B > 0) {
    constexpr int bytes = 4 * (ROW_TABLE_WORDS + SMEM_WORDS);
    static bool smem_set[64];
    htt_smem_limit_once(huffman_decode_rows_kernel, bytes, smem_set);
    huffman_decode_rows_kernel<<<static_cast<unsigned>(B), THREADS, bytes,
                                 static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M,
        static_cast<const int*>(off), static_cast<const int*>(count),
        static_cast<int>(N), static_cast<const int*>(lengths),
        static_cast<const long long*>(codes), static_cast<uint8_t*>(out),
        static_cast<int*>(got));
  }
  return static_cast<int>(cudaGetLastError());
}

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
