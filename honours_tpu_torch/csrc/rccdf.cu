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
// Kernel F, the encode.  Bound on this card: each lane is a serial chain
// of ceil(n / 16) steps, walked from the row's end: a renormalisation
// (emit the state's low byte while x >= f << 19, at most twice) and a
// division, x' = (x / f) * 4096 + x % f + c.  That chain stays serial;
// the bytes (about 1 in, 0.6 out a coded byte) are small beside it.
// Design: a block of 160 threads a row (five warps timed 2-3% faster
// than four or three, tools/kernel_variants.py); lanes 0-15 of warp 0
// walk the 16 rANS lanes and keep everything else off the chain:
// - The row's bytes reach shared memory from its end in chunks of 256
//   lane steps (4 KiB), double-buffered: warp 0 issues chunk q - 1's
//   cp.async (16-byte blocks, so a stage holds the row's misalignment
//   too) before it walks chunk q.  A step's symbol and its table entry
//   are loaded from shared memory two steps ahead of their use.
// - The table entry of a symbol (shared memory, built by the block) is
//   f << 19, ryg's reciprocal of f (rans_byte.h rcp_freq / rcp_shift, as
//   kernel 3: ceil(2^(31+s) / f) with s = ceil(log2 f), and 0 for f = 1,
//   whose quotient is x itself through a mask), c and 4096 - f, so the
//   step is a compare pair, a select, a multiply-high, a shift and a
//   multiply-add: x' = x + q (4096 - f) + c.  The reciprocal is exact for
//   x < 2^31, f in [1, 4096] (tests/test_torch_rccdf_model.py), and a
//   valid table (f >= 1 for a coded byte, f + c <= 4096) keeps x below
//   f << 19 before the division.  A lane with no byte at the row's last
//   step takes f = 4096, c = 0 there, which leaves x as it is.
// - Emitted bytes go to a ring of 1,024 bytes a lane in shared memory,
//   at ring byte ~e (e the lane's emission count), so that the ring
//   mirrors the lane's run in stream order, which is the emission order
//   reversed.  After each chunk the warp flushes the lanes' full 4-byte
//   words to the lane's run in the wrapper's scratch (cap bytes a lane,
//   a multiple of 4 and at least 2 ceil(N / 16); the run ends at cap),
//   a coalesced word store a word; the last flush takes the partial
//   word too.
// - Meanwhile warps 1-4 write zeros over the row's columns [128, W).
//   Then the block copies each lane's run forward after the lane
//   lengths before it: a byte head to the next 4-byte boundary of out,
//   4-byte stores built from two aligned words of the scratch
//   (__funnelshift_r), a byte tail.
// Output ownership: each block writes only its own row and its lanes'
// scratch runs: the head (threads 0-15, a state and a length each), the
// zeros (warps 1-4) and, after a barrier, the lanes' runs (every thread,
// a lane after another), so every byte of out's row is written.
//
// Kernel G, the decode.  Bound on this card: each lane is a serial chain
// of ceil(n / 16) steps, x' = f (x >> 12) + (slot - lo) and a refill of
// up to two bytes while x' < 2^23; the bytes (about 0.6 in, 1 out a coded
// byte) are small beside it.  Design: a block of 256 threads a row; lanes
// 0-15 of warp 0 walk the 16 rANS lanes, and everything else is kept off
// their chains:
// - The state is 32 bits.  It starts as 4 bytes (< 2^32); the slot's
//   symbol is the first whose high end passes the slot, so lo <= slot;
//   every f is in [0, 4096], so x' <= 4096 (2^20 - 1) + 4095 < 2^32; a
//   refill happens only below 2^23 and stays below 2^31.  So the plain
//   version's int64 walk never wraps, and uint32 gives its bytes exactly
//   (tests/test_torch_rccdf_model.py holds a model of this step to it).
// - One lookup a step, keyed by the slot alone: the block builds a table
//   of 4,096 8-byte entries (f, slot - lo) and a parallel u8 table of the
//   symbols, 16 slots a thread (a binary search for the first, then a walk
//   over the high ends); a slot past the table's sum takes symbol 255 with
//   its f (0 or not) and slot - lo, as the plain version's lookup does.
//   (A 4-byte entry f | (slot - lo) << 13, unpacked on the chain, took
//   0.246 ms at the bucket against the 8-byte entry's 0.234.)
// - A lane's stream bytes wait in its ring in shared memory (1,024 bytes,
//   the row's 16-byte blocks by cp.async, a block that is not wholly
//   inside the row byte by byte, 0 outside it).  A step loads the two
//   bytes at its read offset whatever the compare decides, so those loads
//   overlap the table's, and a refill is a funnel shift of (x', b0 b1) by
//   0, 8 or 16 bits (a select of the three took 0.235 ms at the bucket
//   against the funnel shift's 0.216).  The lane refills its ring every RS =
//   128 steps, up to 1,024 bytes past its read offset, and waits for that
//   copy only RS steps later: the RS steps read at most 2 RS bytes, and a
//   ring of at least 4 RS + 15 bytes never runs dry.  (A 64-bit register
//   window of the next bytes, topped up a word at a time from the ring,
//   took 0.33 ms at the bucket against the select's 0.235.)
// - The decoded bytes go to a tile of 32 steps (512 bytes, two of them
//   alternating) in shared memory, which the lanes store as 16-byte words
//   when the output row is 16-byte aligned (byte stores, coalesced, when
//   not).  Meanwhile warps 1-7 write zeros from the walk's last tile to
//   the row's end.
// Output ownership: each block writes only its own row: bytes [0, end) of
// the tiles (end = the tiles' 512-byte steps, cut at N) by warp 0's lanes,
// a tile after a __syncwarp, and [end, N) by warps 1-7, so every byte of
// out's row is written once; the wrapper allocates out with torch.empty.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K = 16;
constexpr int PROB_BITS = 12;
constexpr int SLOTS = 1 << PROB_BITS;
constexpr unsigned RANS_L = 1u << 23;
constexpr int RENORM_SHIFT = 23 - PROB_BITS + 8;
constexpr int HEAD = 8 * K;

// kernel F's block and buffers
constexpr int ETHREADS = 160;
constexpr int CS = 256;                // lane steps a staged chunk
constexpr int CHUNK = CS * K;          // its bytes of the row
constexpr int STAGE = CHUNK + 16;      // a chunk's 16-byte blocks
constexpr int RING = 1024;             // > 2 CS + 4: a chunk's bytes + 4
constexpr int RING_WORDS = RING / 4;
constexpr int RING_STRIDE = RING + 4;  // lane rings a bank apart

// The table entry of a symbol of frequency f and low end c: (f << 19,
// the reciprocal, c, 4096 - f | shift << 16 | (f == 1) << 24), f taken
// in [1, 4096] for the division.
__device__ __forceinline__ uint4 symbol_entry(int f, int c) {
  const unsigned fd = static_cast<unsigned>(min(max(f, 1), SLOTS));
  const unsigned s = 32 - __clz(fd - 1);  // ceil(log2 fd)
  const unsigned rcp =
      fd < 2 ? 0u
             : static_cast<unsigned>(((1ull << (31 + s)) + fd - 1) / fd);
  const unsigned pack = (SLOTS - fd) | ((s - 1) & 31) << 16 |
                        static_cast<unsigned>(fd == 1) << 24;
  return make_uint4(static_cast<unsigned>(f) << RENORM_SHIFT, rcp,
                    static_cast<unsigned>(c), pack);
}

// One encode step of a lane: renormalise (its bytes to the ring at ~E
// and ~(E + 1), kept by advancing E), then divide by the reciprocal.
__device__ __forceinline__ unsigned encode_step(unsigned x, uint4 e,
                                                uint8_t* ring, unsigned& E) {
  const bool over1 = x >= e.x;
  const bool over2 = (x >> 8) >= e.x;  // implies over1
  ring[~E & (RING - 1)] = static_cast<uint8_t>(x);
  ring[~(E + 1) & (RING - 1)] = static_cast<uint8_t>(x >> 8);
  E += static_cast<unsigned>(over1) + static_cast<unsigned>(over2);
  const unsigned xs = over2 ? x >> 16 : over1 ? x >> 8 : x;
  const unsigned q = (__umulhi(xs, e.y) >> ((e.w >> 16) & 31)) |
                     (xs & (e.w >> 24 ? FULL : 0u));
  return xs + q * (e.w & 0x1FFFu) + e.z;
}

// Chunk q of the row (bytes [q CHUNK, min(n, (q + 1) CHUNK))) into stage
// st, as the 16-byte blocks that hold it, by the warp; one commit group a
// call, empty when q < 0.  A block holds a byte of the row, so it lies in
// the row's allocation, whose ends are 16-byte aligned.
__device__ __forceinline__ void stage_chunk(uint8_t* st, const uint8_t* row,
                                            long long n, long long q,
                                            unsigned lane) {
  if (q >= 0) {
    const uint8_t* a = row + q * CHUNK;
    const unsigned mis = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(a) & 15);
    const int blocks = static_cast<int>(
        (mis + min(static_cast<long long>(CHUNK), n - q * CHUNK) + 15) / 16);
    for (int k = lane; k < blocks; k += 32)
      htt_cp_async16(htt_shared_addr(st + 16 * k), a - mis + 16 * k);
  }
  htt_cp_commit();
}

// The warp writes lanes 0-15's emitted bytes [F, E) from their rings to
// their scratch runs, in full 4-byte words (and the partial last word
// when `last`): emission e lies at byte cap - 1 - e of the lane's run.
__device__ __forceinline__ void flush_rings(const uint8_t* ring_s,
                                            uint8_t* runs, long long cap,
                                            unsigned E, unsigned& F,
                                            bool last, unsigned lane) {
  for (int i = 0; i < K; ++i) {
    const unsigned Ei = __shfl_sync(FULL, E, i);
    const unsigned Fi = __shfl_sync(FULL, F, i);
    const unsigned* rw =
        reinterpret_cast<const unsigned*>(ring_s + i * RING_STRIDE);
    unsigned* top = reinterpret_cast<unsigned*>(runs + i * cap + cap) - 1;
    for (unsigned v = (Fi >> 2) + lane; v < (Ei + (last ? 3 : 0)) >> 2;
         v += 32)
      *(top - v) = rw[RING_WORDS - 1 - (v & (RING_WORDS - 1))];
  }
  F = E & ~3u;
}

// Threads tid, tid + nth, ... write zeros over p[0 .. nbytes).
__device__ __forceinline__ void zero_bytes(uint8_t* p, long long nbytes,
                                           unsigned tid, unsigned nth) {
  const long long h = min(nbytes, static_cast<long long>(
      (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  for (long long i = tid; i < h; i += nth) p[i] = 0;
  uint4* v = reinterpret_cast<uint4*>(p + h);
  const long long nv = (nbytes - h) >> 4;
  for (long long k = tid; k < nv; k += nth) v[k] = make_uint4(0, 0, 0, 0);
  for (long long i = h + 16 * nv + tid; i < nbytes; i += nth) p[i] = 0;
}

// Threads tid, tid + nth, ... copy src[0 .. n) to dst forward: bytes to
// dst's next 4-byte boundary, then 4-byte stores, each from the two
// aligned words of src that hold its bytes, then the last bytes.
__device__ __forceinline__ void copy_run(uint8_t* __restrict__ dst,
                                         const uint8_t* __restrict__ src,
                                         long long n, unsigned tid,
                                         unsigned nth) {
  const long long h = min(n, static_cast<long long>(
      (4 - (reinterpret_cast<uintptr_t>(dst) & 3)) & 3));
  for (long long i = tid; i < h; i += nth) dst[i] = src[i];
  const unsigned sm = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(src + h) & 3);
  const unsigned* sw = reinterpret_cast<const unsigned*>(src + h - sm);
  unsigned* dw = reinterpret_cast<unsigned*>(dst + h);
  const long long nw = (n - h) >> 2;
#pragma unroll 4
  for (long long k = tid; k < nw; k += nth)
    dw[k] = __funnelshift_r(sw[k], sm ? sw[k + 1] : 0u, 8 * sm);
  for (long long i = h + 4 * nw + tid; i < n; i += nth) dst[i] = src[i];
}

__global__ void __launch_bounds__(ETHREADS)
    rccdf_encode_kernel(const uint8_t* __restrict__ data, long long N,
                        const int* __restrict__ dlen,
                        const int* __restrict__ freqs,
                        const int* __restrict__ cum, uint8_t* __restrict__ out,
                        long long W, long long* __restrict__ blen,
                        uint8_t* __restrict__ scratch, long long cap) {
  __shared__ uint4 ent_s[256];
  __shared__ __align__(16) uint8_t stage_s[2][STAGE];
  __shared__ __align__(16) uint8_t ring_s[K * RING_STRIDE];
  __shared__ long long len_s[K], start_s[K];
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  for (unsigned s = t; s < 256; s += ETHREADS)
    ent_s[s] = symbol_entry(freqs[b * 256 + s], cum[b * 256 + s]);
  __syncthreads();
  const long long n = min(max(static_cast<long long>(dlen[b]), 0LL), N);
  const uint8_t* row = data + b * N;
  uint8_t* orow = out + b * W;
  uint8_t* runs = scratch + b * K * cap;
  if (t < 32) {
    const long long steps = (n + K - 1) / K;
    const long long last = n > t ? (n - 1 - t) / K : -1;  // the lane's
    const unsigned mis = static_cast<unsigned>(  // every chunk's
        reinterpret_cast<uintptr_t>(row) & 15);
    uint8_t* ring = ring_s + (t & (K - 1)) * RING_STRIDE;
    const uint4 idle = symbol_entry(SLOTS, 0);
    unsigned x = RANS_L, E = 0, F = 0;
    const long long top = steps > 0 ? (steps - 1) / CS : -1;
    stage_chunk(stage_s[top & 1], row, n, top, t);
    for (long long q = top; q >= 0; --q) {
      stage_chunk(stage_s[(q - 1) & 1], row, n, q - 1, t);
      htt_cp_wait<1>();
      __syncwarp();
      if (t < K) {
        // steps q CS + j, j from hi - 1 down to 0; entries two ahead
        const uint8_t* st = stage_s[q & 1] + mis + t;
        const int hi = static_cast<int>(min(steps - q * CS,
                                            static_cast<long long>(CS)));
        const long long lane_hi = last - q * CS;  // j <= lane_hi: a byte
        uint4 e0 = ent_s[st[(hi - 1) * K]];
        uint4 e1 = ent_s[st[max(hi - 2, 0) * K]];
        for (int j = hi - 1; j >= 0; --j) {
          const uint4 e2 = ent_s[st[max(j - 2, 0) * K]];
          x = encode_step(x, j <= lane_hi ? e0 : idle, ring, E);
          e0 = e1;
          e1 = e2;
        }
      }
      __syncwarp();
      flush_rings(ring_s, runs, cap, E, F, q == 0, t);
    }
    // the lanes' starts: an exclusive scan of their lengths
    const long long len = t < K ? E : 0;
    long long start = len;
#pragma unroll
    for (int o = 1; o < K; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, start, o);
      if (t >= static_cast<unsigned>(o)) start += y;
    }
    const long long total = __shfl_sync(FULL, start, K - 1);
    if (t < K) {
      for (int i = 0; i < 4; ++i) {
        orow[4 * t + i] = static_cast<uint8_t>(x >> (8 * i));
        orow[4 * K + 4 * t + i] = static_cast<uint8_t>(len >> (8 * i));
      }
      len_s[t] = len;
      start_s[t] = start - len;
    }
    if (t == 0) blen[b] = HEAD + total;
  } else {
    zero_bytes(orow + HEAD, W - HEAD, t - 32, ETHREADS - 32);
  }
  __syncthreads();  // runs flushed, zeros written
  for (int i = 0; i < K; ++i)
    copy_run(orow + HEAD + start_s[i], runs + i * cap + cap - len_s[i],
             len_s[i], t, ETHREADS);
}

// stream[b, pos] or 0 outside the row
__device__ __forceinline__ unsigned byte_at(const uint8_t* row, long long M,
                                            long long pos) {
  return pos >= 0 && pos < M ? row[pos] : 0u;
}

// kernel G's block and its dynamic shared memory: the slot table (f, slot
// - lo), the slots' symbols, the lanes' rings, two output tiles, and the
// table's high ends, low ends, frequencies and warp sums while it is built
constexpr int DTHREADS = 256;
constexpr int RS = 128;                // lane steps between ring refills
constexpr int LRING = 1024;            // a lane's ring: >= 4 RS + 15
constexpr int TT = 32;                 // lane steps a tile
constexpr int TILE = TT * K;           // a tile's bytes of the row
constexpr int OFF_SYM = 8 * SLOTS;
constexpr int OFF_RING = OFF_SYM + SLOTS;
constexpr int OFF_TILE = OFF_RING + K * LRING;
constexpr int OFF_CUM = OFF_TILE + 2 * TILE;
constexpr int DSMEM = OFF_CUM + 3 * 256 * 4 + 4 * (DTHREADS / 32);
static_assert(LRING >= 4 * RS + 15 && RS % TT == 0, "ring too small");

// The lane's stream blocks [from, to) (byte offsets from its 16-byte
// aligned base a0, multiples of 16) into its ring: a block wholly inside
// the row by cp.async, any other byte by byte, 0 outside the row.  One
// commit group.
__device__ __forceinline__ void fill_ring(uint8_t* ring, const uint8_t* row,
                                          long long M, long long a0,
                                          unsigned from, unsigned to) {
  for (unsigned o = from; o < to; o += 16) {
    const long long p = a0 + o;
    uint8_t* dst = ring + (o & (LRING - 1));
    if (p >= 0 && p + 16 <= M) {
      htt_cp_async16(htt_shared_addr(dst), row + p);
    } else {
      for (int j = 0; j < 16; ++j) dst[j] = static_cast<uint8_t>(
          byte_at(row, M, p + j));
    }
  }
  htt_cp_commit();
}

// One lane step from state x: the slot's entry and symbol (one lookup),
// x' = f (x >> 12) + (slot - lo), then k = 0, 1 or 2 refill bytes from
// the ring at read offset rp (x' < 2^23, and x' < 2^15 for the second),
// loaded before the compare and shifted in below x'.  An inactive step
// changes nothing and gives byte 0.
__device__ __forceinline__ unsigned decode_step(unsigned& x, unsigned& rp,
                                                unsigned ring_a, unsigned ent_a,
                                                unsigned sym_a, bool active) {
  const unsigned slot = x & (SLOTS - 1);
  const uint2 e = htt_lds_u32x2(ent_a + 8 * slot);
  const unsigned s = htt_lds_u8(sym_a + slot);
  const unsigned b0 = htt_lds_u8(ring_a + (rp & (LRING - 1)));
  const unsigned b1 = htt_lds_u8(ring_a + ((rp + 1) & (LRING - 1)));
  const unsigned y = e.x * (x >> PROB_BITS) + e.y;
  const unsigned k = static_cast<unsigned>(y < RANS_L) +
                     static_cast<unsigned>(y < (1u << 15));
  if (active) {
    x = __funnelshift_l((b0 << 24) | (b1 << 16), y, 8 * k);
    rp += k;
  }
  return active ? s : 0u;
}

// Tile q of the row (bytes [q TILE, min(N, (q + 1) TILE))) from shared
// memory to orow by lanes 0-15: 16-byte words when the row is aligned and
// the tile whole, else bytes.
__device__ __forceinline__ void flush_tile(uint8_t* orow, long long N,
                                           long long q, const uint8_t* tl,
                                           unsigned lane, bool aligned) {
  const long long at = q * TILE;
  const int n = static_cast<int>(min(static_cast<long long>(TILE), N - at));
  if (aligned && n == TILE) {
    const uint4* src = reinterpret_cast<const uint4*>(tl);
    uint4* dst = reinterpret_cast<uint4*>(orow + at);
#pragma unroll
    for (int j = 0; j < TILE / 16; j += K) dst[j + lane] = src[j + lane];
  } else {
    for (int j = lane; j < n; j += K) orow[at + j] = tl[j];
  }
}

__global__ void __launch_bounds__(DTHREADS)
    rccdf_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                        const int* __restrict__ off,
                        const int* __restrict__ count, long long N,
                        const int* __restrict__ freqs,
                        uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sm[];
  uint2* ent = reinterpret_cast<uint2*>(sm);
  uint8_t* syms = sm + OFF_SYM;
  int* hi_s = reinterpret_cast<int*>(sm + OFF_CUM);
  int* lo_s = hi_s + 256;
  int* f_s = lo_s + 256;
  int* wsum = f_s + 256;
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  const unsigned lane = t & 31;
  const uint8_t* row = stream + b * M;
  uint8_t* orow = out + b * N;
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  const long long nst = (cnt + K - 1) / K;  // lane 0's steps
  const long long tiles = (nst + TT - 1) / TT;

  // the lanes' states and starts, and their rings' first fill
  unsigned x = 0, mis = 0;
  long long a0 = 0;
  if (t < 32) {
    const long long base = off[b];
    long long len = 0;
    if (t < K) {
      for (int i = 0; i < 4; ++i) {
        x |= byte_at(row, M, base + 4 * t + i) << (8 * i);
        len |= static_cast<long long>(
                   byte_at(row, M, base + 4 * K + 4 * t + i)) << (8 * i);
      }
    }
    long long start = len;
#pragma unroll
    for (int o = 1; o < K; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, start, o);
      if (t >= static_cast<unsigned>(o)) start += y;
    }
    const long long p0 = base + HEAD + start - len;
    mis = static_cast<unsigned>(
        (reinterpret_cast<uintptr_t>(row) + static_cast<uintptr_t>(p0)) & 15);
    a0 = p0 - mis;
    if (t < K && tiles > 0)
      fill_ring(sm + OFF_RING + t * LRING, row, M, a0, 0, LRING);
  }

  // the slot table: cumulative frequencies by a block scan, then 16 slots
  // a thread
  const int f = freqs[b * 256 + t];
  int inc = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= static_cast<unsigned>(o)) inc += y;
  }
  if (lane == 31) wsum[t >> 5] = inc;
  __syncthreads();
  for (unsigned i = 0; i < (t >> 5); ++i) inc += wsum[i];
  hi_s[t] = inc;
  lo_s[t] = inc - f;
  f_s[t] = f;
  __syncthreads();
  {
    const int slot0 = static_cast<int>(16 * t);
    int a = 0, z = 256;  // the first symbol whose high end passes slot0
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (hi_s[mid] > slot0) z = mid;
      else a = mid + 1;
    }
    int s = min(a, 255);
#pragma unroll 4
    for (int slot = slot0; slot < slot0 + 16; ++slot) {
      while (s < 255 && hi_s[s] <= slot) ++s;
      ent[slot] = make_uint2(static_cast<unsigned>(f_s[s]),
                             static_cast<unsigned>(slot - lo_s[s]));
      syms[slot] = static_cast<uint8_t>(s);
    }
  }
  __syncthreads();

  const long long end = min(N, tiles * TILE);
  if (t >= 32) {
    zero_bytes(orow + end, N - end, t - 32, DTHREADS - 32);
    return;
  }
  if (t >= K) return;

  // lanes 0-15 walk
  const unsigned ring_a = htt_shared_addr(sm + OFF_RING + t * LRING);
  const unsigned ent_a = htt_shared_addr(ent);
  const unsigned sym_a = htt_shared_addr(syms);
  uint8_t* tile_s = sm + OFF_TILE;
  const unsigned tile_a = htt_shared_addr(tile_s);
  const bool aligned = (reinterpret_cast<uintptr_t>(orow) & 15) == 0;
  const long long full = cnt / K;  // steps every lane takes
  htt_cp_wait<0>();
  unsigned rp = mis, fetched = LRING;  // the lane's read offset from a0
  for (long long q = 0; q < tiles; ++q) {
    if (q > 0 && q % (RS / TT) == 0) {
      // the copy started RS steps ago has landed; fetch up to a ring past
      // the read offset (the ring's bytes below it are spent)
      htt_cp_wait<0>();
      const unsigned to = (rp & ~15u) + LRING;
      fill_ring(sm + OFF_RING + t * LRING, row, M, a0, fetched, to);
      fetched = to;
    }
    const long long t0 = q * TT;
    const unsigned tq = tile_a + static_cast<unsigned>(q & 1) * TILE + t;
    if (t0 + TT <= full) {
#pragma unroll 8
      for (int j = 0; j < TT; ++j)
        htt_sts_u8(tq + j * K,
                   decode_step(x, rp, ring_a, ent_a, sym_a, true));
    } else {
      for (int j = 0; j < TT; ++j) {
        const bool active = (t0 + j) * K + t < cnt;
        htt_sts_u8(tq + j * K,
                   decode_step(x, rp, ring_a, ent_a, sym_a, active));
      }
    }
    __syncwarp(0xffffu);
    flush_tile(orow, N, q, tile_s + (q & 1) * TILE, t, aligned);
  }
}

}  // namespace

HTT_EXPORT int htt_rccdf_encode(const void* data, long long B, long long N,
                                const void* dlen, const void* freqs,
                                const void* cum, void* out, long long W,
                                void* blen, void* scratch, long long cap,
                                void* cuda_stream) {
  if (cap % 4 != 0 || cap < 2 * ((N + K - 1) / K) || W < HEAD + 2 * N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    rccdf_encode_kernel<<<static_cast<unsigned>(B), ETHREADS, 0,
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
  static bool smem_set[64];
  if (B > 0) {
    htt_smem_limit_once(rccdf_decode_kernel, DSMEM, smem_set);
    rccdf_decode_kernel<<<static_cast<unsigned>(B), DTHREADS, DSMEM,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M, static_cast<const int*>(off),
        static_cast<const int*>(count), N, static_cast<const int*>(freqs),
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
