// Kernels D and E: the adaptive binary range coder of the rc, rcc and
// rccm codecs, encode (rc_encode) and decode (rc_decode), each templated
// over the three byte models.
//
// No TPU kernel stands behind them: honours_tpu runs this coder on the
// host only (honours_tpu/native/rangecoder.c, through codecs/rc.py and
// codecs/stall.py), and these are its counterparts on the card, as
// kernels B and C are for the host's rice and Huffman decoders.  The
// arithmetic is rangecoder.c's, bit for bit:
//   - coder: 32-bit range, 64-bit low with a carry cache; the encoder
//     emits a leading cache byte that the decoder skips; a read past the
//     stream gives 0 (dec_byte);
//   - o0 / o1 (MODEL 0 / 1): one 11-bit probability of a 0 a tree node
//     (o1: a tree a previous byte), adapted by shift 5;
//   - cm (MODEL 2): cm_predict / cm_update.  Four 16-bit counters (o0,
//     o1, the slow o1s and order-2, cnt << 12 | p), stretched and mixed
//     by int weights chosen by the partial byte and the previous byte's
//     top 3 bits (a long long dot product >> 16, here in two int halves,
//     clamped to +-4095; the weights accumulate with no clamp, wrapping
//     as the C's int does),
//     then two APM stages; right shifts of negative ints are arithmetic,
//     as the C's are on every compiler the reference runs on.
// The C's order-2 table is one 64 MB epoch-tagged table; a fresh cell
// reads as (cnt 0, p 2048) and every write leaves cnt >= 1, so each read
// here owns a uint16 table of 2^24 cells filled with 2048 by the wrapper.
//
// Bound on this card: the chain of one read.  Every bit's probability
// depends on every bit before it, so a read is one serial chain of
// 8 x bytes steps; a cm step is six table lookups one after another's
// result (the counters and weights, their stretch, squash, apm1, the
// stretch of its output, apm2) with the mixer's integer chain between.
// The bytes moved (a read in, its stream out) are small beside that.
//
// Design: a warp a read; cm READS reads a block (2 reads an SM, so a
// bucket of 256 reads runs in one wave on 132 SMs), o0 / o1 as below.
// The encoder's bit takes no branch, nor does its renormalisation but
// where it emits bytes, nor cm's decoder's (it reads the next two stream
// bytes before the bit is known); cm's decoder loads both children's
// nodes before a bit is known.
//   - o0 / o1: lane 0 codes the read alone.  A bit is one probability
//     load and a few integer steps, so warp syncs at every byte boundary
//     would cost as much as the byte.  o0's table [256] lives in shared
//     memory; o1's [256][256] is the read's device state, coded in place
//     (a byte reads and writes one 512-byte row, which stays in L1).
//   - cm: every table that fits lives in shared memory, set by the
//     kernel: o0 [256], apm1 and apm2 [256][33], the weights [8][256][4]
//     (65.5 KiB a read) and, a block, SQUASH, STRETCH and SS =
//     STRETCH[SQUASH] (one lookup where the C takes two).
//   - cm: within a byte every node of the bit tree has cells of its own
//     (see "cm." below), so the lanes compute nodes side by side: the
//     encoder's 8 on lanes 0-7; the decoder's 31 of bits 0-4, then the 7
//     below where bit 4 led, each lane updating those of its nodes the
//     byte passed.  The serial part is the coder and the apm2 stage, on
//     lane 0; the encoder runs it on known bits, apm2 first, then the
//     coder.
//   - cm: o1, o1s [256][256] and o2 [2^16][256] stay in device memory
//     (layout below, filled by the wrapper).  The <= 255 cells one byte's
//     bit tree touches are one 512-byte row of each, selected by the
//     previous bytes (key prev1, and prev1 << 8 | prev2 for o2).  Rows
//     are cached in shared-memory slots by key (Rows: a set of S slots a
//     table group, least recently used out, a lane a slot's key and
//     rank, looked up by one ballot).  A key found in a slot is coded
//     there, so a row that repeats (a run repeats both keys at distance
//     1, ABAB at 2, ABCABC at 3) is never fetched while an earlier byte's
//     copy is live; an evicted row is written back by the lanes, lane j
//     its 16-byte chunk j, and a later fetch of that key loads chunk j on
//     the same lane with plain loads after those plain stores, so
//     program order alone makes it read the written cells.  The encoder
//     knows every byte: while byte i is coded, the lanes load byte i+1's
//     missing rows into registers and store them into their slot after
//     it (never byte i's slot: that one is the most recently used).  The
//     decoder learns byte i+1's keys when byte i ends and pays one round
//     trip a missing row.  The input (encoder) and the coder stream
//     (decoder) come through the warp's cp.async window
//     (htt_walk::Window); bytes outside the row read 0.
//
// Device state (rangecoder_cuda.py allocates and fills it, a row a read,
// uint16 cells): o0 none; o1 [B][O1_CELLS] filled with 1024; cm
// [B][DEV_CM_CELLS]: o1 at 0, o1s at DEV_O1S, o2 at DEV_O2, filled with
// 2048.  SQUASH [8192] and STRETCH [4096] (int16) from the wrapper.
// Encode: data [B][N] u8, n [B] int32 (clamped to [0, N]) -> out [B][W]
// u8 (zeroed by the wrapper), len [B] int64.  Row b's stream may take
// cap = n + n / 2 + slack bytes (native._encode's buffer at slack 1024);
// a row whose stream would pass it writes nothing past it, is zeroed and
// gets len -1 (the wrapper raises).  Decode: stream [B][M] u8, off [B],
// count [B] int32 -> out [B][N] u8 (zeroed by the wrapper): row b's
// first count bytes (clamped to [0, N]) from the coder stream at byte
// off (clamped to [0, M]); bytes at or past M read as 0.

#include "common.cuh"

namespace {

using htt_walk::FULL;
using htt_walk::RING;
using htt_walk::Window;

constexpr unsigned PROB_BITS = 11;
constexpr unsigned TOP = 1u << 24;
constexpr int APM_N = 33;
constexpr int W_CELLS = 2048 * 4;
constexpr int W_INIT = (1 << 16) / 4;
constexpr int ROW = 256;  // cells of a row: one byte's bit-tree contexts

// device state, cells of a read's row
constexpr long long O1_CELLS = 65536;
constexpr long long DEV_O1S = 65536;
constexpr long long DEV_O2 = 2 * 65536;
constexpr long long O2_CELLS = 1LL << 24;
constexpr long long DEV_CM_CELLS = DEV_O2 + O2_CELLS;

// shared memory (cm): the reads' stream windows, the block's tables,
// then each read's state; (o0) a table a read
constexpr int READS = 2;         // reads (warps) a block
constexpr int CM_O1_SLOTS = 16;  // cm: o1 + o1s rows by prev1
constexpr int CM_O2_SLOTS = 8;   // cm: o2 rows by prev1 << 8 | prev2
constexpr int SM_RINGS = (READS + 1) * RING;  // RING to spare: alignment
constexpr int SM_SQUASH = SM_RINGS;           // int16 [8192]
constexpr int SM_SS = SM_SQUASH + 2 * 8192;   // int16 [8192]
constexpr int SM_STRETCH = SM_SS + 2 * 8192;  // int16 [4096]
constexpr int SM_CM_READS = SM_STRETCH + 2 * 4096;
// a cm read's state, bytes from its start
constexpr int SM_W = 0;
constexpr int SM_APM1 = SM_W + 4 * W_CELLS;
constexpr int SM_APM2 = SM_APM1 + 2 * 256 * APM_N;
constexpr int SM_O0 = SM_APM2 + 2 * 256 * APM_N;
constexpr int SM_NODES = SM_O0 + 2 * ROW;
constexpr int SM_SLOTS1 = SM_NODES + 4 * ROW;
constexpr int SM_SLOTS2 = SM_SLOTS1 + CM_O1_SLOTS * 2 * 2 * ROW;
constexpr int SM_CM_READ = SM_SLOTS2 + CM_O2_SLOTS * 2 * ROW;

constexpr int smem_cm() { return SM_CM_READS + READS * SM_CM_READ; }
static_assert(smem_cm() <= 232448, "cm: over a block's shared memory");
static_assert(SM_CM_READ % 16 == 0 && SM_SLOTS1 % 16 == 0 &&
                  SM_SLOTS2 % 16 == 0 && SM_CM_READS % 16 == 0,
              "16-byte chunks of rows and weight sets");

// A lane's 16 bytes of a row in device memory, loaded or stored where
// the code says (volatile: the load is issued before the byte it
// overlaps, the store before any later load of the same chunk).
__device__ __forceinline__ uint4 ld_chunk(const uint16_t* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_chunk(uint16_t* p, uint4 v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// S (2..32) shared-memory slots of T rows each, caching a read's rows of
// T device tables by key, least recently used out.  Lane j < S holds
// slot j's key (-1: empty) and rank (0: the most recently used); lanes
// past S hold rank >= S and key -1, so they never match nor go out.
template <int S, int T>
struct Rows {
  static_assert(S >= 2 && S <= 32, "slots");
  uint16_t* sm;    // S x T rows of ROW cells
  uint16_t* g[T];  // the read's device tables
  int lane, key, rank;
  int slot, next;  // the coding byte's slot, the next byte's
  int want, old;   // the next byte's key, its slot's former key
  bool miss;
  uint4 r[T];  // this lane's chunk of each row being fetched

  __device__ void start(uint16_t* sm_, uint16_t* const (&g_)[T], int lane_) {
    sm = sm_;
    for (int t = 0; t < T; ++t) g[t] = g_[t];
    lane = lane_;
    key = -1;
    rank = lane_;
    slot = next = 0;
    miss = false;
  }
  __device__ uint16_t* row(int t) const { return sm + (slot * T + t) * ROW; }
  __device__ uint4* chunk(int s, int t) const {
    return reinterpret_cast<uint4*>(sm + (s * T + t) * ROW) + lane;
  }
  // Take the slot of key k, as the most recently used: on a miss, the
  // least recently used slot (never the coding byte's: that one has rank
  // 0), whose key goes to old.
  __device__ void claim(int k) {
    const unsigned hit = __ballot_sync(FULL, key == k);
    next = __ffs(hit ? hit : __ballot_sync(FULL, rank == S - 1)) - 1;
    miss = hit == 0;
    old = __shfl_sync(FULL, key, next);
    const int was = __shfl_sync(FULL, rank, next);
    if (rank < was) ++rank;
    if (lane == next) {
      rank = 0;
      key = k;
    }
    want = k;
  }
  // On a miss: the claimed slot's rows written back, the wanted rows
  // loading into registers.
  __device__ void fetch() {
    if (miss) {
      if (old >= 0) {
#pragma unroll
        for (int t = 0; t < T; ++t)
          st_chunk(g[t] + old * ROW + 8 * lane, *chunk(next, t));
      }
#pragma unroll
      for (int t = 0; t < T; ++t)
        r[t] = ld_chunk(g[t] + want * ROW + 8 * lane);
    }
  }
  // The fetched rows into the claimed slot, which becomes the coding
  // byte's; the caller then syncs the warp.
  __device__ void land() {
    if (miss) {
#pragma unroll
      for (int t = 0; t < T; ++t) *chunk(next, t) = r[t];
    }
    miss = false;
    slot = next;
  }
};

struct Enc {
  unsigned long long low = 0;
  unsigned range = 0xFFFFFFFFu;
  unsigned cache = 0;
  unsigned long long cache_size = 1;
  uint8_t* out;
  long long pos = 0, cap;
  bool over = false;

  __device__ void put(unsigned b) {
    if (pos < cap)
      out[pos] = static_cast<uint8_t>(b);
    else
      over = true;
    ++pos;
  }
  __device__ void shift_low() {
    if (static_cast<unsigned>(low) < 0xFF000000u || (low >> 32) != 0) {
      const unsigned carry = static_cast<unsigned>(low >> 32);
      unsigned temp = cache;
      do {
        put((temp + carry) & 0xFFu);
        temp = 0xFFu;
      } while (--cache_size);
      cache = static_cast<unsigned>(low >> 24) & 0xFFu;
    }
    ++cache_size;
    low = static_cast<unsigned long long>(static_cast<unsigned>(low) << 8);
  }
  // a bit costs no branch but in the rare renormalisation (a range below
  // TOP after a bit is at least 2^13, so two shifts at most)
  __device__ void code(unsigned p, int bit) {
    const unsigned bound = (range >> PROB_BITS) * p;
    low += bit ? bound : 0u;
    range = bit ? range - bound : bound;
    if (__builtin_expect(range < TOP, 0)) {
      shift_low();
      range <<= 8;
      if (range < TOP) {
        shift_low();
        range <<= 8;
      }
    }
  }
  __device__ void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
  // the end of row b's encode (one thread): its length, or a zeroed row
  // and -1 past the cap
  __device__ void finish(long long* len, long long b) {
    flush();
    if (over) {
      for (long long i = 0; i < cap; ++i) out[i] = 0;
      len[b] = -1;
    } else {
      len[b] = pos;
    }
  }
};

// The coder stream a byte source at a time: a warp's shared window
// (cm), whose next two bytes the decoder reads before each bit (AHEAD),
// or the row in device memory read by one thread (o0 / o1), a byte when
// the renormalisation takes it (a load a bit would sit on the chain).
struct WindowBytes {
  static constexpr bool AHEAD = true;
  Window win;
  __device__ unsigned at(unsigned off) const { return win.byte(off); }
  __device__ void skip(unsigned k) { win.pa += k; }
};

struct RowBytes {
  static constexpr bool AHEAD = false;
  const uint8_t* in;
  long long pos, len;
  __device__ unsigned at(unsigned off) const {
    return pos + off < len ? in[pos + off] : 0u;
  }
  __device__ void skip(unsigned k) { pos += k; }
};

template <typename Bytes>
struct Dec {
  unsigned range = 0xFFFFFFFFu, code = 0;
  Bytes src;

  __device__ void init() {
    src.skip(1);  // the encoder's first cache byte
    for (int i = 0; i < 4; ++i) code = (code << 8) | src.at(i);
    src.skip(4);
  }
  // AHEAD: the renormalisation takes no branch, the next two stream bytes
  // read before the bit is known and taken as it needs them (a range
  // below TOP after a bit is at least 2^13, so two shifts at most).
  __device__ int bit(unsigned p) {
    unsigned b0 = 0, b1 = 0;
    if constexpr (Bytes::AHEAD) {
      b0 = src.at(0);
      b1 = src.at(1);
    }
    const unsigned bound = (range >> PROB_BITS) * p;
    bool one;
    if (code < bound) {
      range = bound;
      one = false;
    } else {
      code -= bound;
      range -= bound;
      one = true;
    }
    if constexpr (Bytes::AHEAD) {
      const bool s1 = range < TOP;
      code = s1 ? (code << 8) | b0 : code;
      range = s1 ? range << 8 : range;
      const bool s2 = range < TOP;
      code = s2 ? (code << 8) | b1 : code;
      range = s2 ? range << 8 : range;
      src.skip(static_cast<unsigned>(s1) + static_cast<unsigned>(s2));
    } else {
      while (range < TOP) {
        code = (code << 8) | src.at(0);
        src.skip(1);
        range <<= 8;
      }
    }
    return one;
  }
};

// The tree context of the byte's k-th bit (k = 0: the root, 1).
__device__ __forceinline__ unsigned ctx_of(unsigned byte, int k) {
  return (byte | 256u) >> (8 - k);
}

// ---------------------------------------------------------------------------
// o0 / o1: lane 0 of a read's warp codes it alone.  A bit is one
// probability load and the coder's few integer steps, so warp syncs at
// every byte would cost as much as the byte.  o0's [256] table lives in
// shared memory; o1's [256][256] is the read's row of the device state,
// read and written in place (a byte's 512-byte row stays in L1).  Reads
// a block: 2 for o1's encode, 1 for the others, each the faster of the
// two on an H100 at the main path's bucket (2 reads an SM either way;
// PERF.md section 6).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint16_t adapt(unsigned p, int bit) {
  return static_cast<uint16_t>(bit ? p - (p >> 5) : p + ((2048u - p) >> 5));
}

template <bool ORDER1, bool ENCODE>
__host__ __device__ constexpr int probs_reads() {
  return ORDER1 && ENCODE ? 2 : 1;
}

// this thread's read b, its warp w in the block and its lane, R reads a
// block
template <int R>
__device__ __forceinline__ void read_of(long long& b, int& w, int& lane) {
  if constexpr (R == 1) {
    b = blockIdx.x;
    w = 0;
    lane = threadIdx.x;
  } else {
    w = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    b = static_cast<long long>(blockIdx.x) * R + w;
  }
}

// read b's table of probabilities: o0's in shared memory (set by the
// warp), o1's in the device state
template <bool ORDER1>
__device__ uint16_t* probs_of(uint8_t* sm, uint16_t* state, long long b,
                              int w, int lane) {
  if constexpr (ORDER1) {
    return state + b * O1_CELLS;
  } else {
    uint16_t* t = reinterpret_cast<uint16_t*>(sm) + w * ROW;
    for (int i = lane; i < ROW; i += 32) t[i] = 1024;
    __syncwarp();
    return t;
  }
}

template <bool ORDER1>
__global__ void __launch_bounds__(32 * probs_reads<ORDER1, true>())
    rc_encode_probs(const uint8_t* __restrict__ data, long long N,
                    const int* __restrict__ n, uint8_t* __restrict__ out,
                    long long W, long long* __restrict__ len,
                    long long slack, uint16_t* state, long long B) {
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int R = probs_reads<ORDER1, true>();
  long long b;
  int w, lane;
  read_of<R>(b, w, lane);
  if (R > 1 && b >= B) return;
  uint16_t* probs = probs_of<ORDER1>(sm, state, b, w, lane);
  if (lane != 0) return;
  const long long cnt = min(max(static_cast<long long>(n[b]), 0LL), N);
  const uint8_t* in = data + b * N;
  Enc e;
  e.out = out + b * W;
  e.cap = min(cnt + cnt / 2 + slack, W);
  unsigned prev1 = 0;
  for (long long i = 0; i < cnt; ++i) {
    const unsigned byte = in[i];
    uint16_t* row = ORDER1 ? probs + (prev1 << 8) : probs;
    unsigned p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = row[ctx_of(byte, k)];
#pragma unroll
    for (int k = 0; k < 8; ++k) e.code(p[k], (byte >> (7 - k)) & 1);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[ctx_of(byte, k)] = adapt(p[k], (byte >> (7 - k)) & 1);
    prev1 = byte;
  }
  e.finish(len, b);
}

template <bool ORDER1>
__global__ void __launch_bounds__(32 * probs_reads<ORDER1, false>())
    rc_decode_probs(const uint8_t* __restrict__ stream, long long M,
                    const int* __restrict__ off,
                    const int* __restrict__ count, long long N,
                    uint8_t* __restrict__ out, uint16_t* state, long long B) {
  extern __shared__ __align__(16) uint8_t sm[];
  constexpr int R = probs_reads<ORDER1, false>();
  long long b;
  int w, lane;
  read_of<R>(b, w, lane);
  if (R > 1 && b >= B) return;
  uint16_t* probs = probs_of<ORDER1>(sm, state, b, w, lane);
  if (lane != 0) return;
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
  Dec<RowBytes> d;
  d.src = RowBytes{stream + b * M, start, M};
  d.init();
  uint8_t* o = out + b * N;
  unsigned prev1 = 0;
  for (long long i = 0; i < cnt; ++i) {
    uint16_t* row = ORDER1 ? probs + (prev1 << 8) : probs;
    unsigned ctx = 1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned p = row[ctx];
      const int bit = d.bit(p);
      row[ctx] = adapt(p, bit);
      ctx = 2 * ctx + bit;
    }
    const unsigned byte = ctx & 0xFFu;
    o[i] = static_cast<uint8_t>(byte);
    prev1 = byte;
  }
}

// ---------------------------------------------------------------------------
// cm.  Within one byte every node of the bit tree reads and writes cells
// of its own (its counters, weight set and apm1 row are chosen by its
// context), so a node's prediction up to the second APM stage depends
// only on the state as the byte found it, and its updates can come after
// the byte's coding: lanes compute nodes side by side (`node`, `update`).
// What stays serial is the coder and the apm2 stage, whose one row (by
// prev1) every bit of the byte reads and updates (`chain` when the bits
// are known, `walk` when they are decoded, on a node's 32 packed bits).
// ---------------------------------------------------------------------------

// cm: rangecoder.c cm_predict / cm_update, every table in shared memory
struct Mix {
  uint16_t *o0, *o1, *o1s, *o2;  // the o0 table, the byte's rows
  uint16_t* apm1;                // [256][33]
  uint16_t* apm2;                // the byte's row of [256][33] (prev1)
  int4* w;                       // the byte's 256 weight sets (prev1 >> 5)
  const short* squash;           // by t + 4096
  const short* ss;               // STRETCH[SQUASH[t + 4096]]
  const short* stretch;
  unsigned* nodes;  // [256] the byte's packed nodes (decoder)

  struct Node {
    unsigned ctx;
    unsigned cell[4];
    int st[4];
    int4 wv;
    int pm, a1, av[2], pr, s2;
  };

  __device__ static int crate(int cnt) {
    return cnt < 1 ? 1 : cnt < 3 ? 2 : cnt < 6 ? 3 : cnt < 10 ? 4 : 5;
  }
  // cm_predict up to the first APM stage and the stretch of its output
  __device__ Node node(unsigned ctx) const {
    Node n;
    n.ctx = ctx;
    n.cell[0] = o0[ctx];
    n.cell[1] = o1[ctx];
    n.cell[2] = o1s[ctx];
    n.cell[3] = o2[ctx];
    n.wv = w[ctx];
#pragma unroll
    for (int i = 0; i < 4; ++i) n.st[i] = stretch[n.cell[i] & 0xFFFu];
    // sum(w * st) >> 16 in 32-bit halves: w = hi * 2^16 + lo, so the sum
    // is 2^16 * sum(hi * st) + sum(lo * st), each within an int
    const int hi = (n.wv.x >> 16) * n.st[0] + (n.wv.y >> 16) * n.st[1] +
                   (n.wv.z >> 16) * n.st[2] + (n.wv.w >> 16) * n.st[3];
    const int lo = (n.wv.x & 0xFFFF) * n.st[0] + (n.wv.y & 0xFFFF) * n.st[1] +
                   (n.wv.z & 0xFFFF) * n.st[2] + (n.wv.w & 0xFFFF) * n.st[3];
    const int t = hi + (lo >> 16);
    const int mixed = (t < -4095 ? -4095 : (t > 4095 ? 4095 : t)) + 4096;
    n.pm = squash[mixed];
    const int s1 = ss[mixed] + 4096;
    n.a1 = static_cast<int>(ctx) * APM_N + (s1 >> 8);
    n.av[0] = apm1[n.a1];
    n.av[1] = apm1[n.a1 + 1];
    const int f1 = s1 & 255;
    n.pr = (n.pm + ((n.av[0] * (256 - f1) + n.av[1] * f1) >> 10)) >> 1;
    n.s2 = stretch[n.pr < 1 ? 1 : (n.pr > 4095 ? 4095 : n.pr)] + 4096;
    return n;
  }
  __device__ static unsigned pack(const Node& n) {
    return static_cast<unsigned>(n.pr) | static_cast<unsigned>(n.s2) << 12;
  }
  // apm2's stage from a node's pr and s2 and its two cells: the coder's
  // probability; an APM cell moved toward a bit
  __device__ static unsigned pc_of(int pr, int lo, int hi, int f2) {
    int p = (pr + ((lo * (256 - f2) + hi * f2) >> 10)) >> 1;
    p = p < 1 ? 1 : (p > 4094 ? 4094 : p);
    const unsigned pc = static_cast<unsigned>(4096 - p) >> 1;
    return pc < 1 ? 1 : (pc > 2046 ? 2046 : pc);
  }
  __device__ static int moved(int a, int bit) {
    return a + (((bit ? 4095 << 2 : 0) - a) >> 7);
  }
  // the encoder's serial stage of a node (its bit known): the coder's
  // probability, the two apm2 cells updated
  __device__ unsigned chain(unsigned v, int bit) {
    const int pr = static_cast<int>(v & 4095u), s2 = static_cast<int>(v >> 12);
    uint16_t* a = apm2 + (s2 >> 8);
    const int lo = a[0], hi = a[1];
    a[0] = static_cast<uint16_t>(moved(lo, bit));
    a[1] = static_cast<uint16_t>(moved(hi, bit));
    return pc_of(pr, lo, hi, s2 & 255);
  }
  // Lane 0 decodes BITS bits down the tree from ctx, each bit's packed
  // node in nodes[]; for all but the last bit both children's nodes are
  // loaded before the bit is known.
  template <int BITS, typename D>
  __device__ unsigned walk(D& d, unsigned ctx) {
    unsigned v = nodes[ctx];
#pragma unroll
    for (int k = 0; k < BITS; ++k) {
      unsigned c0 = 0, c1 = 0;
      if (k + 1 < BITS) {
        c0 = nodes[2 * ctx];
        c1 = nodes[2 * ctx + 1];
      }
      const int pr = static_cast<int>(v & 4095u);
      uint16_t* a = apm2 + (v >> 20);
      const int lo = a[0], hi = a[1];
      const int bit =
          d.bit(pc_of(pr, lo, hi, static_cast<int>(v >> 12) & 255));
      a[0] = static_cast<uint16_t>(moved(lo, bit));
      a[1] = static_cast<uint16_t>(moved(hi, bit));
      ctx = 2 * ctx + bit;
      v = bit ? c1 : c0;
    }
    return ctx;
  }
  // cm_update but apm2's cells
  __device__ void update(const Node& n, int bit) const {
    uint16_t* const c[4] = {o0 + n.ctx, o1 + n.ctx, o1s + n.ctx, o2 + n.ctx};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int cnt = static_cast<int>(n.cell[i] >> 12);
      int p = static_cast<int>(n.cell[i] & 0xFFFu);
      const int r = i == 2 ? 8 : crate(cnt);  // o0, o1, o2 cap 5: crate's
      if (bit)
        p += (4096 - p) >> r;
      else
        p -= p >> r;
      if (p > 4095) p = 4095;
      if (cnt < 15) ++cnt;
      *c[i] = static_cast<uint16_t>((cnt << 12) | p);
    }
    const int err = (bit << 12) - n.pm;
    int4 v = n.wv;  // int accumulation, wrapping
    v.x = static_cast<int>(static_cast<unsigned>(v.x) +
                           static_cast<unsigned>((n.st[0] * err) >> 10));
    v.y = static_cast<int>(static_cast<unsigned>(v.y) +
                           static_cast<unsigned>((n.st[1] * err) >> 10));
    v.z = static_cast<int>(static_cast<unsigned>(v.z) +
                           static_cast<unsigned>((n.st[2] * err) >> 10));
    v.w = static_cast<int>(static_cast<unsigned>(v.w) +
                           static_cast<unsigned>((n.st[3] * err) >> 10));
    w[n.ctx] = v;
    const int target = bit ? 4095 << 2 : 0;
    apm1[n.a1] = static_cast<uint16_t>(n.av[0] + ((target - n.av[0]) >> 7));
    apm1[n.a1 + 1] =
        static_cast<uint16_t>(n.av[1] + ((target - n.av[1]) >> 7));
  }
};

// a read's cm model, set up by its warp: state in shared memory, row slots
struct Model {
  Mix m;
  Rows<CM_O1_SLOTS, 2> r1;  // o1, o1s
  Rows<CM_O2_SLOTS, 1> r2;  // o2
  uint16_t* apm2;
  int4* w;

  __device__ void start(uint8_t* sm, uint16_t* state, int wi, int lane) {
    uint8_t* me = sm + SM_CM_READS + wi * SM_CM_READ;
    m.squash = reinterpret_cast<const short*>(sm + SM_SQUASH);
    m.ss = reinterpret_cast<const short*>(sm + SM_SS);
    m.stretch = reinterpret_cast<const short*>(sm + SM_STRETCH);
    w = reinterpret_cast<int4*>(me + SM_W);
    m.apm1 = reinterpret_cast<uint16_t*>(me + SM_APM1);
    apm2 = reinterpret_cast<uint16_t*>(me + SM_APM2);
    m.o0 = reinterpret_cast<uint16_t*>(me + SM_O0);
    m.nodes = reinterpret_cast<unsigned*>(me + SM_NODES);
    for (int i = lane; i < W_CELLS / 4; i += 32)
      w[i] = make_int4(W_INIT, W_INIT, W_INIT, W_INIT);
    for (int i = lane; i < 256 * APM_N; i += 32) {
      const int k = i % APM_N;
      const int idx = min((k - 16) * 256 + 4096, 8191);
      const uint16_t v = static_cast<uint16_t>(m.squash[idx] << 2);
      m.apm1[i] = v;
      apm2[i] = v;
    }
    for (int i = lane; i < ROW; i += 32) m.o0[i] = 2048;
    uint16_t* const g1[2] = {state, state + DEV_O1S};
    uint16_t* const g2[1] = {state + DEV_O2};
    r1.start(reinterpret_cast<uint16_t*>(me + SM_SLOTS1), g1, lane);
    r2.start(reinterpret_cast<uint16_t*>(me + SM_SLOTS2), g2, lane);
    rows_for(0, 0);
    r1.land();
    r2.land();
    __syncwarp();
  }
  // the next byte's rows, given its previous two bytes
  __device__ void rows_for(unsigned p1, unsigned p2) {
    r1.claim(p1);  // both votes, then both groups' copies
    r2.claim((p1 << 8) | p2);
    r1.fetch();
    r2.fetch();
  }
  __device__ void land() {
    r1.land();
    r2.land();
  }
  __device__ void use_rows(unsigned prev1) {
    m.o1 = r1.row(0);
    m.o1s = r1.row(1);
    m.o2 = r2.row(0);
    m.apm2 = apm2 + prev1 * APM_N;
    m.w = w + ((prev1 >> 5) << 8);  // weight set ctx << 3 | prev1 >> 5
  }
};

// the block's SQUASH, SS and STRETCH
__device__ void load_tables(uint8_t* sm, const short* tables) {
  short* sq = reinterpret_cast<short*>(sm + SM_SQUASH);
  short* st = reinterpret_cast<short*>(sm + SM_STRETCH);
  short* ss = reinterpret_cast<short*>(sm + SM_SS);
  for (int i = threadIdx.x; i < 8192 + 4096; i += blockDim.x)
    (i < 8192 ? sq[i] : st[i - 8192]) = tables[i];
  __syncthreads();
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) ss[i] = st[sq[i]];
  __syncthreads();
}

// Whether tree context ctx (1-255) lies on byte's path, and the bit the
// byte takes there.
__device__ __forceinline__ bool on_path(unsigned ctx, unsigned byte) {
  return ctx_of(byte, 31 - __clz(ctx)) == ctx;
}
__device__ __forceinline__ int bit_at(unsigned ctx, unsigned byte) {
  return (byte >> (7 - (31 - __clz(ctx)))) & 1;
}

__global__ void __launch_bounds__(32 * READS)
    rc_encode_cm(const uint8_t* __restrict__ data, long long N,
                 const int* __restrict__ n, uint8_t* __restrict__ out,
                 long long W, long long* __restrict__ len, long long slack,
                 uint16_t* state, long long B,
                 const short* __restrict__ tables) {
  extern __shared__ __align__(16) uint8_t sm[];
  load_tables(sm, tables);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * READS + w;
  if (b >= B) return;
  const long long cnt = min(max(static_cast<long long>(n[b]), 0LL), N);
  Model md;
  md.start(sm, state + b * DEV_CM_CELLS, w, lane);
  Window in;
  in.start(data + b * N, cnt, htt_walk::ring_of(sm, 0, w), 0, lane);
  Enc e;
  e.out = out + b * W;
  e.cap = min(cnt + cnt / 2 + slack, W);
  unsigned prev1 = 0;
  for (long long i = 0; i < cnt; ++i) {
    const unsigned byte = in.byte(0);
    ++in.pa;
    md.use_rows(prev1);
    if (i + 1 < cnt) md.rows_for(byte, prev1);  // loads overlap the byte
    // lane k < 8: the node of bit k; lane 0 then runs the byte's bits
    // through the apm2 stage and the coder
    Mix::Node nd;
    unsigned v = 0;
    if (lane < 8) {
      nd = md.m.node(ctx_of(byte, lane));
      v = Mix::pack(nd);
    }
    unsigned pk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) pk[k] = __shfl_sync(FULL, v, k);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        pk[k] = md.m.chain(pk[k], (byte >> (7 - k)) & 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) e.code(pk[k], (byte >> (7 - k)) & 1);
    }
    if (lane < 8) md.m.update(nd, (byte >> (7 - lane)) & 1);
    md.land();
    __syncwarp();
    in.keep_up();
    prev1 = byte;
  }
  if (lane == 0) e.finish(len, b);
}

__global__ void __launch_bounds__(32 * READS)
    rc_decode_cm(const uint8_t* __restrict__ stream, long long M,
                 const int* __restrict__ off, const int* __restrict__ count,
                 long long N, uint8_t* __restrict__ out, uint16_t* state,
                 long long B, const short* __restrict__ tables) {
  extern __shared__ __align__(16) uint8_t sm[];
  load_tables(sm, tables);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * READS + w;
  if (b >= B) return;
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
  Model md;
  md.start(sm, state + b * DEV_CM_CELLS, w, lane);
  Dec<WindowBytes> d;
  d.src.win.start(stream + b * M, M, htt_walk::ring_of(sm, 0, w), start,
                  lane);
  d.init();
  d.src.win.keep_up();
  uint8_t* o = out + b * N;
  unsigned prev1 = 0;
  for (long long i = 0; i < cnt; ++i) {
    md.use_rows(prev1);
    // the nodes of bits 0-4 (contexts 1-31), one a lane; lane 0 decodes
    // those bits; then the 7 nodes of bits 5-7 below where it got.  Each
    // lane keeps its nodes and updates those on the byte's path.
    Mix::Node n1, n2;
    if (lane < 31) {
      n1 = md.m.node(lane + 1);
      md.m.nodes[lane + 1] = Mix::pack(n1);
    }
    __syncwarp();
    unsigned ctx = 1;
    if (lane == 0) ctx = md.m.walk<5>(d, 1u);
    ctx = __shfl_sync(FULL, ctx, 0);
    if (lane < 7) {
      n2 = md.m.node(lane == 0  ? ctx
                     : lane < 3 ? 2 * ctx + (lane - 1)
                                : 4 * ctx + (lane - 3));
      md.m.nodes[n2.ctx] = Mix::pack(n2);
    }
    __syncwarp();
    if (lane == 0) ctx = md.m.walk<3>(d, ctx);
    const unsigned byte = __shfl_sync(FULL, ctx, 0) & 0xFFu;
    d.src.win.pa = __shfl_sync(FULL, d.src.win.pa, 0);
    if (lane == 0) o[i] = static_cast<uint8_t>(byte);
    if (i + 1 < cnt) md.rows_for(byte, prev1);  // loads overlap the updates
    if (lane < 31 && on_path(n1.ctx, byte))
      md.m.update(n1, bit_at(n1.ctx, byte));
    if (lane < 7 && on_path(n2.ctx, byte))
      md.m.update(n2, bit_at(n2.ctx, byte));
    md.land();
    __syncwarp();
    d.src.win.keep_up();
    prev1 = byte;
  }
}

// a kernel's dynamic shared memory, its limit raised once a device
template <typename F>
int smem_for(F* kernel, bool (&done)[64], int bytes) {
  htt_smem_limit_once(kernel, bytes, done);
  return bytes;
}

// an o0 / o1 kernel over B reads, probs_reads a block (o0: a table each
// in shared memory)
template <bool ORDER1, bool ENCODE, typename F, typename... A>
void launch_probs(F* kernel, long long B, cudaStream_t st, A... args) {
  constexpr int r = probs_reads<ORDER1, ENCODE>();
  kernel<<<static_cast<unsigned>((B + r - 1) / r), 32 * r,
           ORDER1 ? 0 : r * 2 * ROW, st>>>(args...);
}

}  // namespace

HTT_EXPORT int htt_rc_encode(long long model, const void* data, long long B,
                             long long N, const void* n, void* out,
                             long long W, void* len, long long slack,
                             void* state, const void* tables,
                             void* cuda_stream) {
  if (B > 0) {
    static bool done[64];
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* nn = static_cast<const int*>(n);
    auto* o = static_cast<uint8_t*>(out);
    auto* l = static_cast<long long*>(len);
    auto* s = static_cast<uint16_t*>(state);
    const auto* t = static_cast<const short*>(tables);
    auto st = static_cast<cudaStream_t>(cuda_stream);
    const unsigned g = static_cast<unsigned>((B + READS - 1) / READS);
    if (model == 0)
      launch_probs<false, true>(rc_encode_probs<false>, B, st, d, N, nn, o,
                                W, l, slack, s, B);
    else if (model == 1)
      launch_probs<true, true>(rc_encode_probs<true>, B, st, d, N, nn, o, W,
                               l, slack, s, B);
    else
      rc_encode_cm<<<g, 32 * READS,
                     smem_for(rc_encode_cm, done, smem_cm()), st>>>(
          d, N, nn, o, W, l, slack, s, B, t);
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_rc_decode(long long model, const void* stream, long long B,
                             long long M, const void* off, const void* count,
                             long long N, void* out, void* state,
                             const void* tables, void* cuda_stream) {
  if (B > 0) {
    static bool done[64];
    const auto* in = static_cast<const uint8_t*>(stream);
    const auto* of = static_cast<const int*>(off);
    const auto* c = static_cast<const int*>(count);
    auto* o = static_cast<uint8_t*>(out);
    auto* s = static_cast<uint16_t*>(state);
    const auto* t = static_cast<const short*>(tables);
    auto st = static_cast<cudaStream_t>(cuda_stream);
    const unsigned g = static_cast<unsigned>((B + READS - 1) / READS);
    if (model == 0)
      launch_probs<false, false>(rc_decode_probs<false>, B, st, in, M, of, c,
                                 N, o, s, B);
    else if (model == 1)
      launch_probs<true, false>(rc_decode_probs<true>, B, st, in, M, of, c, N,
                                o, s, B);
    else
      rc_decode_cm<<<g, 32 * READS,
                     smem_for(rc_decode_cm, done, smem_cm()), st>>>(
          in, M, of, c, N, o, s, B, t);
  }
  return static_cast<int>(cudaGetLastError());
}
