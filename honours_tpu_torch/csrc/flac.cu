// Kernel N: the flac decode, a block of threads a read.
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
// byte after the last of its blen - order codes.  Samples: the warm-up,
// then x[j] = r + the order-th fixed prediction from x[j - 1 .. j -
// order], which is the host's repeated integration (the same values mod
// 2^16), written as int16.  Row b holds n[b] samples (clamped to [0, L]),
// zeros to L.  A byte at or past the row's end reads as 0, so a cut
// stream decodes without a fault.  A header the press never writes (mode
// 5-14, an order not below the block's length, k above 30) ends the row's
// walk: its samples from that block on are 0.
//
// Design: one block of 512 threads a read; the read's flac blocks stay a
// walk, each block's header found from the block before, and the work
// inside a block is split across the threads.
//   - Rice codes: the chunked, self-synchronising decode of common.cuh
//     (htt_chunked::decode_tiles, shared with kernels B and C: its tiles,
//     chunks, bitmaps, fix-point rounds and scan, here at chunks of 64
//     bits, Geometry<CHUNK>), over the block's Rice bits from the byte
//     after its warm-up.  A unary run ends at the first zero whatever bit
//     it starts on, so walks from the chunk starts meet the true walk
//     within a few codes, and the rounds need no bound on a code's length
//     (a garbage run has none).  A tile reaches only (k + 1 + SLACK_BITS)
//     bits a code and SLACK_TAIL bits past its entry (on synthetic reads
//     a code's unary run averages 0.6-1.7 ones at the press's k), at most
//     32,768 bits; a region longer than that (the press's are shorter
//     than the verbatim form, 1 + 2 blen bytes), or garbage, goes on tile
//     by tile.  Chunks of 64 bits (about 11 codes) keep the two dependent
//     walks a block short: on the H100 at the bucket 0.27 ms, against 0.31
//     at 128 bits and 0.42 at B's and C's 256 (PERF.md §6).  Past the
//     row's last nonzero byte (found once a row) every code is a zero and
//     k zero bits, 1 + k bits and z = 0, so the walk stops there and the
//     rest of the codes follows without a walk.
//   - The sink (Residuals) writes code i's residual, unzigzagged, into
//     the block's buffer in shared memory at column order + i, and the
//     chunk that emits the last code hands over the bit after it: the
//     next header is that bit's byte, rounded up.
//   - Integration: order <= 4 inclusive scans across the block in
//     wrapping uint32 over columns [o + 1, blen) plus D^o[0], the o-th
//     difference of the warm-up, which goes to column o (o = order - 1 ..
//     0): the host's integrations.  Columns are padded (a word after every
//     32) so a thread's 8 consecutive columns sit on distinct banks.
//   - Then the block's int16 samples leave the buffer coalesced; a
//     verbatim block is copied by all threads, the zeros to L too.
//
// Bound on this card: what stays serial, a read's blocks (16 at L =
// 65,536): each block's header, its tile's staging, the speculation (a
// chunk's walk of dependent steps), a fix-point round or two, the scan,
// the emit walk and the integration's scans.  The bytes (about 1 a sample
// in, 2 a sample out) are small beside it.
//
// Output ownership: block b writes row b's L samples and nothing else: a
// sample of a predictor block by the thread of its column (j mod 512),
// of a verbatim block and of the zeros past the walk likewise.

#include "common.cuh"

namespace {

using namespace htt_chunked;

constexpr long long BLOCK = 4096;
constexpr unsigned VERBATIM = 15;
constexpr unsigned MAX_ORDER = 4;
constexpr unsigned MAX_K = 30;
// the decode's chunks and tiles
constexpr int CHUNK = 64;
using Narrow = Geometry<CHUNK>;
// a tile's reach past its entry: (k + 1 + SLACK_BITS) bits a code plus
// SLACK_TAIL bits
constexpr int SLACK_BITS = 2;
constexpr int SLACK_TAIL = 1024;
// the block's residuals and samples, a pad word after every 32
constexpr int BUF_WORDS = BLOCK + BLOCK / 32;
constexpr int COLS = BLOCK / THREADS;  // consecutive columns a thread scans
constexpr int FLAC_SMEM_WORDS = Narrow::SMEM_WORDS + BUF_WORDS + 1;
static_assert(4 * FLAC_SMEM_WORDS <= 48 * 1024, "the default shared memory");

__device__ __forceinline__ unsigned padded(unsigned j) { return j + (j >> 5); }

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

// flac's Rice code at bit p: q ones, a zero, k value bits LSB-first
struct Rice {
  int k;
  __device__ __forceinline__ unsigned step(const SourceOf<Narrow>& s,
                                           unsigned p,
                                           unsigned& len1, unsigned& len,
                                           unsigned& sym) const {
    unsigned long long w = s.peek64(p);
    unsigned q = 0;
    while (static_cast<unsigned>(w) == 0xFFFFFFFFu) {  // 32 ones or more
      q += 32;
      w = s.peek64(p + q);
    }
    const unsigned t = __ffs(~static_cast<unsigned>(w)) - 1;  // ones left
    const unsigned v = static_cast<unsigned>(w >> (t + 1)) & ((1u << k) - 1u);
    q += t;
    len1 = len = q + 1 + k;
    sym = (q << k) | v;
    return 1;
  }
};

// code i's residual at column base + i of the block's buffer
struct Residuals {
  unsigned* buf;
  unsigned base;
  unsigned* end;  // the bit after the last code
  struct Writer {
    unsigned* buf;
    unsigned j;
    __device__ __forceinline__ void put(unsigned z) {
      buf[padded(j++)] = (z >> 1) ^ (0u - (z & 1u));
    }
  };
  __device__ __forceinline__ Writer writer(unsigned i, unsigned) const {
    return Writer{buf, base + i};
  }
  __device__ __forceinline__ void last(unsigned p) const { *end = p; }
};

// columns [lo, n) of buf += first + the inclusive sum of those before
// them; column lo - 1 = first.  Every thread calls it.
__device__ __forceinline__ void integrate(unsigned* buf, unsigned lo,
                                          unsigned n, unsigned first,
                                          unsigned* sums) {
  const unsigned c0 = COLS * threadIdx.x;
  unsigned v[COLS], acc = 0;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const unsigned j = c0 + i;
    if (j >= lo && j < n) acc += buf[padded(j)];
    v[i] = acc;
  }
  unsigned total;
  const unsigned before = block_scan(acc, sums, &total) + first;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const unsigned j = c0 + i;
    if (j >= lo && j < n) buf[padded(j)] = v[i] + before;
  }
  if (threadIdx.x == 0) buf[padded(lo - 1)] = first;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
    flac_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                       const int* __restrict__ n, long long L,
                       int16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* sums = smem + Narrow::SUMS_AT;
  unsigned* buf = smem + Narrow::SMEM_WORDS;
  unsigned* end_bit = buf + BUF_WORDS;
  const unsigned t = threadIdx.x;
  const long long b = blockIdx.x;
  const uint8_t* row = stream + b * M;
  const Row r{row, M};
  int16_t* o = out + b * L;
  const long long m = min(max(static_cast<long long>(n[b]), 0LL), L);
  // row bytes [T, M) are zeros
  long long T = 0;
  if (m > 0) {
    const SourceOf<Narrow> whole = make_source<Narrow>(row, M, 0);
    const unsigned top = last_nonzero(whole, sums);
    T = top ? top - whole.lo : 0;
  }
  long long off = 0, pos = 0;
  while (pos < m) {
    const long long blen = min(BLOCK, m - pos);
    const unsigned mode = r.byte(off);
    if (mode == VERBATIM) {
      for (long long j = t; j < blen; j += THREADS)
        o[pos + j] = static_cast<int16_t>(r.u16(off + 1 + 2 * j));
      off += 1 + 2 * blen;
      pos += blen;
      continue;
    }
    const unsigned k = r.byte(off + 1);
    if (mode > MAX_ORDER || mode >= blen || k > MAX_K) break;
    const unsigned order = mode;
    const unsigned cnt = static_cast<unsigned>(blen) - order;
    const long long s = off + 2 + 2 * order;
    SourceOf<Narrow> src = make_source<Narrow>(row, M, min(s, M));
    const unsigned E = T > s ? static_cast<unsigned>(8 * (T - s)) : 0u;
    unsigned entry = 0;
    const unsigned S = decode_tiles(
        Rice{static_cast<int>(k)}, src, entry, E, cnt,
        min(Narrow::TILE_BITS, cnt * (k + 1 + SLACK_BITS) + SLACK_TAIL),
        Residuals{buf, order, end_bit}, smem);
    __syncthreads();  // the residuals and the end are written
    unsigned end;
    if (S < cnt) {  // codes [S, cnt) lie in the zero bits
      for (unsigned i = S + t; i < cnt; i += THREADS)
        buf[padded(order + i)] = 0;
      end = entry + (cnt - S) * (1 + k);
      __syncthreads();
    } else {
      end = *end_bit;
    }
    // the warm-up's differences at 0: d[0] is D^o[0] after o rounds
    unsigned d[MAX_ORDER];
    for (unsigned j = 0; j < MAX_ORDER; ++j)
      d[j] = j < order ? r.u16(off + 2 + 2 * j) : 0u;
    unsigned first[MAX_ORDER];
    for (unsigned lvl = 0; lvl < MAX_ORDER; ++lvl) {
      first[lvl] = d[0];
      for (unsigned j = 0; j + 1 < MAX_ORDER; ++j) d[j] = d[j + 1] - d[j];
    }
    for (int lvl = static_cast<int>(order) - 1; lvl >= 0; --lvl)
      integrate(buf, lvl + 1, static_cast<unsigned>(blen), first[lvl], sums);
    for (long long j = t; j < blen; j += THREADS)
      o[pos + j] = static_cast<int16_t>(buf[padded(static_cast<unsigned>(j))]);
    off = s + (static_cast<long long>(end) + 7) / 8;
    pos += blen;
    __syncthreads();  // the buffer is read before the next block writes it
  }
  for (long long j = pos + t; j < L; j += THREADS) o[j] = 0;
}

}  // namespace

HTT_EXPORT int htt_flac_decode(const void* stream, long long B, long long M,
                               const void* n, long long L, void* out,
                               void* cuda_stream) {
  if (B > 0 && L > 0) {
    constexpr int bytes = 4 * FLAC_SMEM_WORDS;
    flac_decode_kernel<<<static_cast<unsigned>(B), THREADS, bytes,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M, static_cast<const int*>(n), L,
        static_cast<int16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
