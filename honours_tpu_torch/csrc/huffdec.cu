// Kernel C: static-Huffman decode of one LSB-first bit stream per read.
//
// No TPU kernel stands behind it: honours_tpu decodes shuffman_vbbe21_zd
// only on the host (honours_tpu/codecs/huffman.py:49
// shuffman_decode_memory through native/huffdec.c:13 ht_huffman_decode),
// and this is its counterpart on the card.  The walk is the C's: a
// window of the next 22 stream bits (bit 0 the first) indexes a LUT of
// (symbol, code length); the symbol is emitted and the length consumed.
// Row b's stream starts at byte off[b] of its row of M bytes; bytes at or
// past M read as 0, and nothing past the row is read.  The walk stops at
// a zero length (a window no code starts, the C's corrupt-stream guard)
// and at a code that would run past the row's last byte (a cut stream).
// got[b] is the symbols decoded: count[b] (clamped to [0, N]) unless the
// walk stopped first.  Out row b holds them, then zeros to N.
//
// Tables (engine/huffdec_cuda.py decode_tables): lut, 2^22 entries of
// sym | len << 8 (uint16, 8 MiB, left in L2), and l1, 4,096 uint32
// entries over 12-bit windows: sym1 | len1 << 8 | sym2 << 16 | len12 << 24
// where the window holds a code of at most 12 bits (most symbols of
// nanopore residuals) and, where it holds the next code whole, that code
// (len12 the two codes' bits, else 0); 0 where the window holds no whole
// code, which sends the step to lut.
//
// Bound on this card: latency.  Each symbol's start is known only once
// the symbol before it is decoded, so a read is one serial walk; its
// bytes (about 0.7 in, 1 out a symbol) are small.  With one thread of a
// block running, every instruction of a step waits on the one before.
// Design: one read a block, as kernel B (reads sharing a warp wait on
// each other's refills and long codes).  The block's 128 threads copy l1
// into shared memory; thread 0 then walks, with the 64-bit window of
// htt_serial::BitReader (refilled a word at a time to at least 33 bits,
// more than the 22 a step needs).  A step takes one lookup in shared
// memory and emits two symbols where l1 holds two (0.53 steps a symbol
// on chip_smoke.py's synthetic reads); its counters are 32-bit (the
// wrapper bounds M and N).  Symbols gather in a 64-bit register and
// leave as whole 32-bit words where N % 4 == 0 (the wrapper's rows are
// then word-aligned), else a byte at a time.  Each block writes only its
// own row.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int L1_BITS = 12;
constexpr int LUT_BITS = 22;
constexpr unsigned L1_MASK = (1u << L1_BITS) - 1u;
constexpr unsigned long long LUT_MASK = (1ull << LUT_BITS) - 1ull;

template <bool WORD>
__global__ void __launch_bounds__(THREADS)
    huffman_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                          const int* __restrict__ off,
                          const int* __restrict__ count, int N,
                          const unsigned* __restrict__ l1g,
                          const uint16_t* __restrict__ lut,
                          uint8_t* __restrict__ out, int* __restrict__ got) {
  __shared__ __align__(16) unsigned l1[1 << L1_BITS];
  // 16 KiB in 16-byte pieces (the wrapper checks l1g is 16-byte aligned)
  for (int j = threadIdx.x; j < (1 << L1_BITS) / 4; j += THREADS)
    reinterpret_cast<uint4*>(l1)[j] =
        __ldg(reinterpret_cast<const uint4*>(l1g) + j);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const long long b = blockIdx.x;
  const int cnt = min(max(count[b], 0), N);
  const long long start = off[b] < 0 ? 0 : off[b];
  // the stream bits the row holds from start on (M < 2^29)
  const unsigned limit =
      start < M ? static_cast<unsigned>(8 * (M - start)) : 0u;
  htt_serial::BitReader in{stream + b * M, M, start};
  uint8_t* o = out + b * static_cast<long long>(N);
  unsigned* o4 = reinterpret_cast<unsigned*>(o);

  in.start();
  unsigned used = 0;
  int i = 0;                   // symbols decoded
  unsigned long long acc = 0;  // WORD: the k symbols before i not stored
  int k = 0;
  while (i < cnt) {
    in.refill();
    unsigned e = l1[static_cast<unsigned>(in.buf) & L1_MASK];
    unsigned len = (e >> 8) & 31u;
    if (len == 0) {  // a code longer than 12 bits, or none
      e = __ldg(lut + (in.buf & LUT_MASK));
      len = e >> 8;
      if (len == 0) break;
    }
    if (used + len > limit) break;
    unsigned syms = e & 0xFFu;
    int n = 1;
    const unsigned len12 = e >> 24;
    if (len12 != 0 && i + 1 < cnt && used + len12 <= limit) {
      syms |= (e >> 8) & 0xFF00u;
      len = len12;
      n = 2;
    }
    used += len;
    in.drop(static_cast<int>(len));
    if (WORD) {
      acc |= static_cast<unsigned long long>(syms) << (8 * k);
      k += n;
      if (k >= 4) {
        o4[(i + n - k) >> 2] = static_cast<unsigned>(acc);
        acc >>= 32;
        k -= 4;
      }
    } else {
      o[i] = static_cast<uint8_t>(syms);
      if (n == 2) o[i + 1] = static_cast<uint8_t>(syms >> 8);
    }
    i += n;
  }
  got[b] = i;
  if (WORD) {
    int w = i - k;  // bytes stored as whole words
    if (k) {        // the last partial word, zeros after its symbols
      o4[w >> 2] = static_cast<unsigned>(acc);
      w += 4;
    }
    for (; w < N; w += 4) o4[w >> 2] = 0u;
  } else {
    for (; i < N; ++i) o[i] = 0;
  }
}

}  // namespace

HTT_EXPORT int htt_huffman_decode(const void* stream, long long B,
                                  long long M, const void* off,
                                  const void* count, long long N,
                                  const void* l1, const void* lut, void* out,
                                  void* got, void* cuda_stream) {
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>(B);
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    const auto* s = static_cast<const uint8_t*>(stream);
    const auto* of = static_cast<const int*>(off);
    const auto* c = static_cast<const int*>(count);
    const auto* t1 = static_cast<const unsigned*>(l1);
    const auto* t = static_cast<const uint16_t*>(lut);
    auto* o = static_cast<uint8_t*>(out);
    auto* g = static_cast<int*>(got);
    if (N % 4 == 0)
      huffman_decode_kernel<true><<<grid, THREADS, 0, st>>>(
          s, M, of, c, static_cast<int>(N), t1, t, o, g);
    else
      huffman_decode_kernel<false><<<grid, THREADS, 0, st>>>(
          s, M, of, c, static_cast<int>(N), t1, t, o, g);
  }
  return static_cast<int>(cudaGetLastError());
}
