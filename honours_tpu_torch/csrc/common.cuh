// Shared helpers for the honours_tpu_torch kernels (plain C interface,
// loaded with ctypes).  Every C entry launches on the stream it is given
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define HTT_EXPORT extern "C" __attribute__((visibility("default")))

HTT_EXPORT const char* htt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ unsigned htt_lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The 32-bit shared-window address of a pointer into shared memory.
__device__ __forceinline__ unsigned htt_shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies of 16 or 4 bytes from device memory to the shared
// address a (cp.async, Ampere and later), their commit and the wait on
// all but the newest N groups of this thread.
__device__ __forceinline__ void htt_cp_async16(unsigned a, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void htt_cp_async4(unsigned a, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void htt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void htt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block copies n bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory and waits for all of them.
__device__ __forceinline__ void htt_copy_to_shared(void* dst, const void* src,
                                                   long long n) {
  for (long long i = 16LL * threadIdx.x; i < n; i += 16LL * blockDim.x)
    htt_cp_async16(htt_shared_addr(dst) + static_cast<unsigned>(i),
                   static_cast<const char*>(src) + i);
  htt_cp_commit();
  htt_cp_wait<0>();
  __syncthreads();
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <typename F>
inline void htt_smem_limit_once(F* fn, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    if (dev >= 0 && dev < 64) done[dev] = true;
  }
}

// Loads from a shared address that neither compiler may drop, predicate
// or sink into a branch, so independent loads overlap.
__device__ __forceinline__ unsigned htt_lds_u8(unsigned a) {
  unsigned short v;
  asm volatile("ld.volatile.shared.u8 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ unsigned htt_lds_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint2 htt_lds_u32x2(unsigned a) {
  uint2 v;
  asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 htt_lds_u32x4(unsigned a) {
  uint4 v;
  asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

// Stores of a byte and of 16 zero bytes at the shared address a.
__device__ __forceinline__ void htt_sts_u8(unsigned a, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;\n"
               :: "r"(a), "h"(static_cast<unsigned short>(v)) : "memory");
}

__device__ __forceinline__ void htt_sts_zero16(unsigned a) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
               :: "r"(a), "r"(0u) : "memory");
}

// ---------------------------------------------------------------------------
// Single-pass decoupled look-back (Merrill & Garland) over a row's tiles
// (kernels 1 and 6): a tile's state is one 64-bit word in a zeroed
// scratch the wrapper allocates, flag and value written by one store.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long htt_ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void htt_st_status(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The tile of this block, counted in launch order.  A row of one tile
// waits on no other, so it takes blockIdx and needs no scratch; wider
// rows take an atomic ticket from the word after the launch's states, so
// that the tiles a block waits on were handed out earlier and already
// hold an SM.
__device__ __forceinline__ long long htt_take_ticket(
    unsigned long long* status, long long tiles) {
  __shared__ long long s_ticket;
  if (tiles == 1) return blockIdx.x;
  if (threadIdx.x == 0)
    s_ticket = static_cast<long long>(atomicAdd(status + gridDim.x, 1ull));
  __syncthreads();
  return s_ticket;
}

// ---------------------------------------------------------------------------
// The rANS decode walks' stream window and refill (kernels 4, 4b and 8)
// ---------------------------------------------------------------------------

namespace htt_walk {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned RANS_L = 1u << 23;
constexpr int RING = 2048;     // stream bytes a read keeps in shared memory
constexpr int SEG = 512;       // a ring segment: 16 bytes a lane
constexpr int SEG_SHIFT = 9;

// A read's window of the stream.  Ring coordinate a = p + delta holds row
// byte p (delta = the row's offset in its 16-byte line) at ring + a % RING
// (ring: a RING-aligned shared address), and bytes outside the row read as
// 0.  Segments seg, seg+1 are resident, seg+2 and seg+3 in flight.  The
// walk keeps pa = a mod 2^32 of its pointer; pa reaching edge (the start
// of seg+1) moves the window on.
struct Window {
  const uint8_t* row;
  long long delta, Mb, seg;
  unsigned ring, pa, edge;
  int k;

  // lane k's 16 bytes of segment q: copied when inside the row, zeros
  // when outside it, byte by byte at the row's two ends
  __device__ __forceinline__ void fill(long long q) {
    const long long lo = q * SEG + 16 * k - delta;  // row byte at the line start
    const unsigned dst = ring | static_cast<unsigned>((q * SEG + 16 * k) & (RING - 1));
    if (lo >= 0 && lo + 16 <= Mb) {
      htt_cp_async16(dst, row + lo);
    } else if (lo + 16 <= 0 || lo >= Mb) {
      htt_sts_zero16(dst);
    } else {
      for (int j = 0; j < 16; ++j)
        htt_sts_u8(dst + j, lo + j >= 0 && lo + j < Mb ? row[lo + j] : 0);
    }
    htt_cp_commit();
  }

  __device__ __forceinline__ void start(const uint8_t* row_, long long Mb_,
                                        unsigned ring_, long long ptr,
                                        int lane) {
    row = row_;
    delta = reinterpret_cast<uintptr_t>(row_) & 15;
    ring = ring_;
    Mb = Mb_;
    k = lane;
    seg = (ptr + delta) >> SEG_SHIFT;
    pa = static_cast<unsigned>(ptr + delta);
    edge = static_cast<unsigned>((seg + 1) * SEG);
#pragma unroll
    for (int q = 0; q < 4; ++q) fill(seg + q);
    htt_cp_wait<2>();
    __syncwarp();
  }

  __device__ __forceinline__ unsigned byte(unsigned off) const {
    return htt_lds_u8(ring | ((pa + off) & (RING - 1)));
  }

  // after the pointer moved (by less than SEG - 64 bytes since the last
  // call): on entering a new segment, fetch the one three ahead into the
  // slot just left
  __device__ __forceinline__ void keep_up() {
    if (static_cast<int>(pa - edge) >= 0) {
      ++seg;
      edge += SEG;
      __syncwarp();
      fill(seg + 3);
      htt_cp_wait<2>();
      __syncwarp();
    }
  }
};

// the RING-aligned shared address of warp w's ring, past `used` bytes of
// the block's dynamic shared memory (which has RING bytes to spare)
__device__ __forceinline__ unsigned ring_of(const uint8_t* sm, long long used,
                                            int w) {
  const unsigned a = htt_shared_addr(sm) + static_cast<unsigned>(used);
  return ((a + RING - 1) & ~static_cast<unsigned>(RING - 1)) + w * RING;
}

// Both refill rounds of one step: a lane below RANS_L takes a byte in lane
// order, and one that was below 2^15 (so still below RANS_L after it) a
// second one after every first.  The pointer moves by at most 64 bytes;
// the caller calls win.keep_up() before it has moved SEG - 64.
__device__ __forceinline__ unsigned refill(unsigned x, bool active,
                                           Window& win, unsigned lt) {
  const bool n1 = active && x < RANS_L;
  const bool n2 = active && x < (RANS_L >> 8);
  const unsigned m1 = __ballot_sync(FULL, n1);
  const unsigned m2 = __ballot_sync(FULL, n2);
  const unsigned c1 = __popc(m1);
  const unsigned b1 = win.byte(__popc(m1 & lt));
  const unsigned b2 = win.byte(c1 + __popc(m2 & lt));
  x = n2 ? (x << 16) | (b1 << 8) | b2 : n1 ? (x << 8) | b1 : x;
  win.pa += c1 + __popc(m2);
  return x;
}

// bytes v (one each) into g[0, n)
__device__ __forceinline__ void put_bytes(uint8_t* g, const unsigned* v,
                                          int n) {
#pragma unroll
  for (int j = 0; j < n; ++j)
    g[j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));
}

// g[i, T) = sym: byte stores up to g's next 16-byte line, then lines
// (a warp's byte stores hit 32 rows, 32 sectors each)
__device__ __forceinline__ void fill_tail(uint8_t* g, int i, int T,
                                          unsigned sym) {
  const int head = min(T - i, static_cast<int>(
      (16 - (reinterpret_cast<uintptr_t>(g + i) & 15)) & 15));
  for (int j = 0; j < head; ++j) g[i + j] = static_cast<uint8_t>(sym);
  i += head;
  const unsigned s4 = (sym & 255u) * 0x01010101u;
  for (; i + 16 <= T; i += 16)
    *reinterpret_cast<uint4*>(g + i) = make_uint4(s4, s4, s4, s4);
  for (; i < T; ++i) g[i] = static_cast<uint8_t>(sym);
}

}  // namespace htt_walk

// ---------------------------------------------------------------------------
// Chunked, self-synchronising decode of LSB-first prefix-code streams
// (kernels B and C), after Weissenberger and Schmidt (2018).
//
// One block decodes one row.  The row's stream bits [0, E) are cut into
// tiles of TILE_BITS, taken one after another, and a tile into THREADS
// chunks of CHUNK_BITS, chunk j to thread j.  The walk from a bit position
// depends on that position alone (a code policy's step reads the bits
// there, and for C the stop conditions are properties of the position),
// so two walks that meet a common codeword start agree from there on.
//   1. Speculate: thread j walks from its chunk's first bit (the tile's
//      true entry for the chunk holding it) until its position reaches the
//      chunk's end, recording the codeword starts it visits in a bitmap
//      (one bit a stream bit, shared memory), their count and its exit
//      position (STOP where the walk met a stop).
//   2. Synchronise: round after round, thread j takes thread j-1's exit e
//      as its entry.  If e is past its chunk, the chunk holds no start
//      (count 0, exit e); if e is a start in its bitmap, the walk from e is
//      its own from there (count = the starts from e on, exit unchanged);
//      else it walks again from e until it meets a start of its old walk
//      (or its chunk's end), rewriting the bitmap up to there.  Rounds
//      repeat, under __syncthreads_or, until no exit changes.  After round
//      r chunks 0..r are exact, so this ends, whatever the codes' lengths
//      (a garbage rice run has no bound).
//   3. Scan: an exclusive block scan of the counts gives each chunk's
//      first symbol; the tile's total adds to the row's.
//   4. Emit: thread j walks its chunk again from its true entry and writes
//      its symbols; the next tile starts at the tile's last chunk's exit.
// The chunks cover the stream up to its last nonzero byte, found first
// (a row's stream is mostly followed by zero padding).  Over zero bits
// both codes are of one length, so a walk in the wrong phase there never
// meets the true one; instead the walk's rest from its exit e past the
// last nonzero byte is known without walking it: the zero window's code
// (Code::tail) repeated up to the stream's end.  Chunks past the last
// nonzero byte take no part in the rounds, and a tile's exit is that of
// its last chunk before it.  The row's walk ends at a stop, at the end of
// the stream's bits, or once `count` symbols are decoded; got =
// min(count, symbols decoded).
//
// Output ownership (no byte has two writers): thread j of the tile whose
// symbols start at S writes row bytes [S + start_j, S + start_j + count_j)
// cut to [0, got), in 32-bit words where a whole aligned word lies inside
// that range and bytes elsewhere.  After the last tile the block writes
// [S, got) (the tail's symbols, S the symbols of all tiles) and then
// [got, N) (zeros), each range's aligned words by thread (word index mod
// THREADS) and its unaligned bytes at either end by thread 0.  Symbol
// ranges of one tile are disjoint (the scan), tiles follow each other,
// and every range lies below the next.
//
// Shared by kernels B, C and N.  decode_tiles is steps 1-4 over a
// stream's tiles, generic over the chunk size (Geometry: B and C take
// CHUNK_BITS, N 64), the code (its step), the sink that takes symbols
// [0, cnt) (a chunk's symbols through a writer of its own, and the end of
// symbol cnt - 1) and a span: a tile reaches at most `span` bits past its
// entry, rounded up to a chunk, so a stream that the caller knows to be
// short walks only the chunks it needs.  decode_row is B's and C's row:
// the last nonzero byte, decode_tiles over whole tiles into the row's
// bytes (RowSink), then the tail and the zeros.
// Kernel N (csrc/flac.cu) calls decode_tiles on each flac block's Rice
// codes with a sink of residuals in shared memory and its own tail.
// ---------------------------------------------------------------------------

namespace htt_chunked {

constexpr int THREADS = 512;
constexpr int CHUNK_BITS = 256;  // kernels B and C
constexpr int WARPS = THREADS / 32;
constexpr unsigned STOP = 0xffffffffu;  // the exit of a walk that stopped

// The decode's layout at CB bits a chunk (B and C: CHUNK_BITS; N: its
// own).  A tile's stream words in shared memory: its bits, a word of
// alignment and a spill of 128 bytes for the codes that cross its end
// (longer ones, only in garbage, read device memory).  Word r of the
// stage lies at (r % CHUNK_WORDS) * STAGE_COLS + r / CHUNK_WORDS: a
// thread's chunk is column j, so the lanes of a warp, each walking its
// own chunk, read distinct banks; STAGE_COLS = 32 / CHUNK_WORDS mod 32
// keeps the staging stores (CHUNK_WORDS words a row of consecutive
// lanes) on distinct banks too.  Dynamic shared memory of the decode, in
// 32-bit words: bitmap, stage, two exit buffers, warp sums.
template <int CB>
struct Geometry {
  static constexpr int CHUNK_BITS = CB;
  static constexpr int CHUNK_WORDS = CB / 32;
  static constexpr unsigned TILE_BITS = THREADS * CB;
  static constexpr int STAGE_WORDS = TILE_BITS / 32 + 4 + 32;
  static constexpr int STAGE_COLS =
      (STAGE_WORDS / CHUNK_WORDS + 32) / 32 * 32 + 32 / CHUNK_WORDS;
  static constexpr int STAGE_SIZE = CHUNK_WORDS * STAGE_COLS;
  static constexpr int SUMS_AT = CHUNK_WORDS * THREADS + STAGE_SIZE +
                                 2 * THREADS;
  static constexpr int SMEM_WORDS = SUMS_AT + WARPS;
  static_assert(CB % 64 == 0 && THREADS % 32 == 0, "word chunks");
  static_assert((STAGE_WORDS - 1) / CHUNK_WORDS < STAGE_COLS &&
                STAGE_COLS % 32 == 32 / CHUNK_WORDS, "stage columns");
};
using Wide = Geometry<CHUNK_BITS>;
constexpr int SMEM_WORDS = Wide::SMEM_WORDS;

// One row's stream: byte j is row[start + j] while start + j < M, else 0.
// Words are read in aligned coordinates: aligned byte a is stream byte
// a - lo, lo = (row + start) mod 16, so aligned word i lies at the 4-byte
// aligned address base + 4i (base = row + start - lo).  A tile's words
// [w0, w0 + nw) sit in shared memory, laid out as G's stage; others are
// loaded, nothing outside the stream's bytes is read.
template <class G>
struct SourceOf {
  const uint8_t* base;
  unsigned lo, hi;  // aligned bytes [lo, hi) hold the stream
  const unsigned* stage;
  unsigned w0, nw;

  __device__ __forceinline__ unsigned byte_at(unsigned a) const {
    return a >= lo && a < hi ? __ldg(base + a) : 0u;
  }
  __device__ __forceinline__ unsigned global_word(unsigned i) const {
    const unsigned a = 4u * i;
    if (a >= lo && a + 4 <= hi)
      return __ldg(reinterpret_cast<const unsigned*>(base + a));
    return byte_at(a) | byte_at(a + 1) << 8 | byte_at(a + 2) << 16 |
           byte_at(a + 3) << 24;
  }
  __device__ __forceinline__ unsigned staged(unsigned r) const {
    return stage[(r % G::CHUNK_WORDS) * G::STAGE_COLS + r / G::CHUNK_WORDS];
  }
  // the stream bits from bit p on, bit p lowest: 64 of them, or 32
  __device__ __forceinline__ unsigned long long peek64(unsigned p) const {
    const unsigned q = 8 * lo + p, i = q >> 5, sh = q & 31, r = i - w0;
    unsigned x, y, z;
    if (__builtin_expect(r < nw && r + 2 < nw, 1)) {
      x = staged(r);
      y = staged(r + 1);
      z = staged(r + 2);
    } else {
      x = global_word(i);
      y = global_word(i + 1);
      z = global_word(i + 2);
    }
    return static_cast<unsigned long long>(__funnelshift_r(y, z, sh)) << 32 |
           __funnelshift_r(x, y, sh);
  }
  __device__ __forceinline__ unsigned peek32(unsigned p) const {
    const unsigned q = 8 * lo + p, i = q >> 5, sh = q & 31, r = i - w0;
    unsigned x, y;
    if (__builtin_expect(r < nw && r + 1 < nw, 1)) {
      x = staged(r);
      y = staged(r + 1);
    } else {
      x = global_word(i);
      y = global_word(i + 1);
    }
    return __funnelshift_r(x, y, sh);
  }
};

using Source = SourceOf<Wide>;  // kernels B and C

// the stream of a row of M bytes from byte start (0 <= start <= M < 2^28)
template <class G = Wide>
__device__ __forceinline__ SourceOf<G> make_source(const uint8_t* row,
                                                   long long M,
                                                   long long start) {
  SourceOf<G> s;
  const unsigned lo = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(row + start) & 15);
  s.base = row + start - lo;
  s.lo = lo;
  s.hi = lo + static_cast<unsigned>(M - start);
  s.stage = nullptr;
  s.w0 = 0;
  s.nw = 0;
  return s;
}

// The block copies nw <= STAGE_WORDS words of the tile from bit tb on
// into the stage (coalesced loads, zeros outside the stream).
template <class G>
__device__ __forceinline__ void stage_tile(SourceOf<G>& s, unsigned* stage,
                                           unsigned tb, unsigned nw) {
  s.stage = stage;
  s.w0 = (s.lo + tb / 8) >> 2;
  s.nw = nw;
  for (unsigned r = threadIdx.x; r < nw; r += THREADS)
    stage[(r % G::CHUNK_WORDS) * G::STAGE_COLS + r / G::CHUNK_WORDS] =
        s.global_word(s.w0 + r);
  __syncthreads();
}

// A thread's chunk [c, end) of the tile (empty where end <= c) and its
// walk: entry, exit (STOP where it stopped) and the starts it holds.
struct Chunk {
  unsigned c, end, entry, exit, count;
};

// Bitmap word w of this thread's chunk (bit r: chunk bit 32w + r), words
// interleaved across the block's threads so a warp's like accesses hit
// 32 banks.  Bits in [entry, end) are the walk's starts there; bits below
// the entry are never read.
__device__ __forceinline__ unsigned* bm_word(unsigned* bm, unsigned w) {
  return bm + w * THREADS + threadIdx.x;
}

// starts held from chunk bit r on
template <class G>
__device__ __forceinline__ unsigned popc_from(unsigned* bm, unsigned r) {
  unsigned n = __popc(*bm_word(bm, r >> 5) & (~0u << (r & 31)));
  for (unsigned w = (r >> 5) + 1; w < G::CHUNK_WORDS; ++w)
    n += __popc(*bm_word(bm, w));
  return n;
}

// Walk from e (ch.c <= e < ch.end) until the chunk's end, a stop, or
// (SYNC) a start of the old walk at or past valid_from (its entry),
// writing the bitmap from e to where it ended.  A code's step
// (Code::step) may decode two codes where its window holds both; the
// speculation (no SYNC) takes both when the second starts in the chunk
// and in the same bitmap word, and reads no bitmap word: it clears the
// words after e's first and stores each word's starts as it leaves it.
// The re-walks (SYNC) are short and take one code a step.
template <bool SYNC, class G, class Code>
__device__ __forceinline__ void walk(const Code& code, const SourceOf<G>& src,
                                     unsigned* bm, Chunk& ch, unsigned e,
                                     unsigned valid_from) {
  unsigned p = e, n = 0, cw = (e - ch.c) >> 5, acc = 0;
  unsigned old = SYNC ? *bm_word(bm, cw) : 0u;
  if (!SYNC)
    for (unsigned x = cw + 1; x < G::CHUNK_WORDS; ++x) *bm_word(bm, x) = 0;
  bool synced = false, stopped = false;
  while (p < ch.end) {
    const unsigned r = p - ch.c, w = r >> 5;
    if (w != cw) {  // word cw walked past: its starts are acc
      *bm_word(bm, cw) = acc;
      if (SYNC) {
        for (unsigned x = cw + 1; x < w; ++x) *bm_word(bm, x) = 0;
        old = *bm_word(bm, w);
      }
      cw = w;
      acc = 0;
    }
    const unsigned bit = 1u << (r & 31);
    if (SYNC && p >= valid_from && (old & bit)) {
      synced = true;
      break;
    }
    unsigned len1, len, sym;
    const unsigned k = code.step(src, p, len1, len, sym);
    if (k == 0) {
      stopped = true;
      break;
    }
    acc |= bit;
    const unsigned r2 = r + len1;  // the second code's chunk bit
    if (!SYNC && k == 2 && p + len1 < ch.end && (r2 >> 5) == w) {
      acc |= 1u << (r2 & 31);
      n += 2;
      p += len;
    } else {
      ++n;
      p += len1;
    }
  }
  if (synced) {  // new starts below p, the old walk's from p on
    *bm_word(bm, cw) = (old & (~0u << ((p - ch.c) & 31))) | acc;
    ch.count = n + popc_from<G>(bm, p - ch.c);
  } else {  // no start after the walk's last
    *bm_word(bm, cw) = acc;
    if (SYNC)
      for (unsigned x = cw + 1; x < G::CHUNK_WORDS; ++x) *bm_word(bm, x) = 0;
    ch.count = n;
    ch.exit = stopped ? STOP : p;
  }
  ch.entry = e;
}

// exclusive scan of v over the block; *total gets the sum
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* sums,
                                               unsigned* total) {
  const unsigned lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned s = lane < WARPS ? sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) sums[lane] = s;
  }
  __syncthreads();
  *total = sums[WARPS - 1];
  return (wid ? sums[wid - 1] : 0u) + x - v;
}

// Bytes [i, i + m) of a row written in order: whole aligned 32-bit words
// inside the range as words, the bytes before the first and after the
// last as bytes.
struct RowWriter {
  uint8_t* row;
  unsigned i, head_end, body_end, acc;

  __device__ __forceinline__ RowWriter(uint8_t* r, unsigned i0, unsigned m)
      : row(r), i(i0), acc(0) {
    const unsigned mis = (4u - static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(r + i0) & 3)) & 3u;
    head_end = i0 + min(mis, m);
    body_end = head_end + ((i0 + m - head_end) & ~3u);
  }
  __device__ __forceinline__ void put(unsigned x) {
    if (i < head_end || i >= body_end) {
      row[i] = static_cast<uint8_t>(x);
    } else {
      const unsigned sh = 8 * ((i - head_end) & 3);
      acc |= (x & 0xffu) << sh;
      if (sh == 24) {
        *reinterpret_cast<unsigned*>(row + i - 3) = acc;
        acc = 0;
      }
    }
    ++i;
  }
};

// 1 + the aligned index of the stream's last nonzero byte, 0 where it
// has none: the block reads 16-byte groups from the stream's end down,
// LAST_GROUPS a thread a pass, until a pass finds one.
constexpr int LAST_GROUPS = 4;
template <class G>
__device__ __forceinline__ unsigned last_nonzero(const SourceOf<G>& s,
                                                 unsigned* top) {
  const int g_lo = static_cast<int>(s.lo / 16);
  int g_hi = static_cast<int>((s.hi + 15) / 16);
  if (threadIdx.x == 0) *top = 0;
  __syncthreads();
  for (; g_hi > g_lo; g_hi -= THREADS * LAST_GROUPS) {
    unsigned hit = 0;
#pragma unroll
    for (int x = 0; x < LAST_GROUPS; ++x) {
      const int g = g_hi - 1 - static_cast<int>(threadIdx.x) - x * THREADS;
      if (g < g_lo) break;
      const unsigned a = 16u * g;
      uint4 v;
      if (a >= s.lo && a + 16 <= s.hi) {
        v = __ldg(reinterpret_cast<const uint4*>(s.base + a));
      } else {
        v.x = s.global_word(a / 4);
        v.y = s.global_word(a / 4 + 1);
        v.z = s.global_word(a / 4 + 2);
        v.w = s.global_word(a / 4 + 3);
      }
      const unsigned h = v.w ? 12 + (39 - __clz(v.w)) / 8
                         : v.z ? 8 + (39 - __clz(v.z)) / 8
                         : v.y ? 4 + (39 - __clz(v.y)) / 8
                         : v.x ? (39 - __clz(v.x)) / 8 : 0u;
      if (h && !hit) hit = a + h;  // the highest group first
    }
    if (hit) atomicMax(top, hit);
    if (__syncthreads_or(hit)) return *top;
  }
  return 0;
}

// row[a, b) = byte: its whole aligned words across the block, its
// unaligned bytes at either end by thread 0
__device__ __forceinline__ void fill(uint8_t* row, unsigned a, unsigned b,
                                     unsigned byte) {
  if (a >= b) return;
  const unsigned mis = (4u - static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(row + a) & 3)) & 3u;
  const unsigned w = min(a + mis, b);
  const unsigned z = w + ((b - w) & ~3u);
  if (threadIdx.x == 0) {
    for (unsigned i = a; i < w; ++i) row[i] = static_cast<uint8_t>(byte);
    for (unsigned i = z; i < b; ++i) row[i] = static_cast<uint8_t>(byte);
  }
  const unsigned v = (byte & 0xffu) * 0x01010101u;
  for (unsigned i = w + 4 * threadIdx.x; i < z; i += 4 * THREADS)
    *reinterpret_cast<unsigned*>(row + i) = v;
}

// A row of bytes as decode_tiles' sink: a chunk's symbols through a
// RowWriter; the end of the last symbol is not needed.
struct RowSink {
  uint8_t* row;
  __device__ __forceinline__ RowWriter writer(unsigned i, unsigned m) const {
    return RowWriter(row, i, m);
  }
  __device__ __forceinline__ void last(unsigned) const {}
};

// Steps 1-4 over the stream's tiles: the walk from bit `entry` over the
// stream's E bits until it passes E (or stopped) or has walked cnt
// symbols; symbol i < cnt goes to the sink, and the chunk that emits
// symbol cnt - 1 hands the sink the bit after it (sink.last).  A tile
// reaches at most span bits past its entry, rounded up to a chunk, and
// stages only the words it reaches; span 0 takes whole tiles (B and C,
// whose code then folds to that of whole tiles alone).
// Returns the symbols walked (more than cnt where the last tile went on);
// `entry` becomes the walk's exit (STOP where it stopped).  Every thread
// of the block calls it.  On return the tiles' shared memory is still in
// use: the caller's next write to it follows a barrier.
template <class G, class Code, class Sink>
__device__ __forceinline__ unsigned decode_tiles(const Code& code,
                                                 SourceOf<G>& src,
                                                 unsigned& entry,
                                                 unsigned E, unsigned cnt,
                                                 unsigned span,
                                                 const Sink& sink,
                                                 unsigned* smem) {
  unsigned* bm = smem;
  unsigned* stage = bm + G::CHUNK_WORDS * THREADS;
  unsigned* exits = stage + G::STAGE_SIZE;
  unsigned* sums = smem + G::SUMS_AT;
  constexpr unsigned CB = G::CHUNK_BITS, TILE = G::TILE_BITS;
  const unsigned t = threadIdx.x;
  unsigned S = 0;  // symbols before the tile
  while (entry < E && S < cnt) {  // STOP >= E
    const unsigned tb = entry - entry % TILE;
    const unsigned reach =
        span ? min(tb + TILE, (entry + span + CB - 1) / CB * CB) : tb + TILE;
    const unsigned te = min(E, reach);  // the tile's chunks end here
    __syncthreads();  // the last tile is done with the stage and exits
    stage_tile(src, stage, tb,
               span ? (reach - tb) / 32 + (G::STAGE_WORDS - TILE / 32)
                    : static_cast<unsigned>(G::STAGE_WORDS));

    // 1. speculate
    Chunk ch;
    ch.c = tb + t * CB;
    ch.end = min(ch.c + CB, te);
    const unsigned e0 = max(ch.c, entry);
    if (e0 >= ch.end) {
      ch.entry = ch.exit = e0;
      ch.count = 0;
    } else {
      walk<false>(code, src, bm, ch, e0, ch.end);
    }
    exits[t] = ch.exit;
    __syncthreads();

    // 2. synchronise
    unsigned cur = 0;
    for (;;) {
      const unsigned e = t ? exits[cur * THREADS + t - 1] : ch.entry;
      bool moved = false;
      if (e != ch.entry && ch.c < te) {
        const unsigned was = ch.exit;
        if (e >= ch.end) {
          ch.entry = ch.exit = e;
          ch.count = 0;
        } else if (e >= ch.entry &&
                   (*bm_word(bm, (e - ch.c) >> 5) >> ((e - ch.c) & 31) & 1)) {
          ch.count = popc_from<G>(bm, e - ch.c);
          ch.entry = e;
        } else {
          walk<true>(code, src, bm, ch, e, ch.entry);
        }
        moved = ch.exit != was;
      }
      cur ^= 1;
      exits[cur * THREADS + t] = ch.exit;
      if (!__syncthreads_or(moved)) break;
    }

    // 3. scan
    unsigned total;
    const unsigned first_sym = S + block_scan(ch.count, sums, &total);

    // 4. emit, cut at cnt
    if (ch.count && first_sym < cnt) {
      const unsigned m = min(ch.count, cnt - first_sym);
      auto out = sink.writer(first_sym, m);
      unsigned p = ch.entry;
      for (unsigned i = 0; i < m;) {
        unsigned len1, len, sym;
        if (code.step(src, p, len1, len, sym) == 2 && i + 1 < m) {
          out.put(sym);
          out.put(sym >> 8);
          i += 2;
          p += len;
        } else {
          out.put(sym);
          ++i;
          p += len1;
        }
      }
      if (first_sym + m == cnt) sink.last(p);
    }
    S += total;
    // the exit of the tile's last chunk that starts below te
    entry = exits[cur * THREADS + min((te - 1 - tb) / CB,
                                      static_cast<unsigned>(THREADS - 1))];
  }
  return S;
}

// Decode one row: the walk from bit `first` over the stream's E bits, at
// most cnt symbols into row[0, got), then zeros to N.  Returns got.
// Every thread of the block calls it.
template <class Code>
__device__ __forceinline__ unsigned decode_row(const Code& code,
                                               SourceOf<Wide>& src,
                                               unsigned first, unsigned E,
                                               unsigned cnt, uint8_t* row,
                                               unsigned N, unsigned* smem) {
  unsigned* sums = smem + Wide::SUMS_AT;
  // the bits past the stream's last nonzero byte are zeros
  const unsigned top = cnt ? last_nonzero(src, sums) : 0u;
  E = min(E, top ? 8 * (top - src.lo) : 0u);
  unsigned entry = first;
  const unsigned S = decode_tiles(code, src, entry, E, cnt, 0u,
                                  RowSink{row}, smem);
  unsigned got = min(S, cnt);
  if (entry != STOP && S < cnt) {  // the walk's rest over zero bits
    unsigned n, sym;
    code.tail(entry, n, sym);
    got = S + min(n, cnt - S);
    fill(row, S, got, sym);
  }
  fill(row, got, N, 0u);
  return got;
}

}  // namespace htt_chunked
