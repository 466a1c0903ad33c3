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
//     top 3 bits (a long long dot product >> 16, clamped to +-4095; the
//     weights accumulate with no clamp, wrapping as the C's int does),
//     then two APM stages; right shifts of negative ints are arithmetic,
//     as the C's are on every compiler the reference runs on.
// The C's order-2 table is one 64 MB epoch-tagged table; a fresh cell
// reads as (cnt 0, p 2048) and every write leaves cnt >= 1, so each row
// here owns a uint16 table of 2^24 cells filled with 2048 by the wrapper.
//
// Layout (rangecoder_cuda.py allocates and fills it, a row each):
//   o0 / o1: probs [B][256] / [B][65536] uint16, filled with 1024;
//   cm: small [B][CM_SMALL] uint16 (o0 [256], o1 [256][256], o1s
//       [256][256], apm1 [256][33], apm2 [256][33]), o2 [B][2^24] uint16,
//       w [B][2048][4] int32; SQUASH [8192] and STRETCH [4096] (int16)
//       from the wrapper, copied to shared memory by each block.
// Encode: data [B][N] u8, n [B] int32 (clamped to [0, N]) -> out [B][W]
// u8 (zeroed by the wrapper), len [B] int64.  Row b's stream may take
// cap = n + n / 2 + slack bytes (native._encode's buffer at slack 1024);
// a row whose stream would pass it writes nothing past it, is zeroed and
// gets len -1 (the wrapper raises).  Decode: stream [B][M] u8, off [B],
// count [B] int32 -> out [B][N] u8 (zeroed by the wrapper): row b's
// first count bytes (clamped to [0, N]) from the coder stream at byte
// off (clamped to [0, M]); bytes at or past M read as 0.
//
// Bound on this card: the chain of one read.  Every bit's probability
// depends on every bit before it, so a read is one serial chain of
// 8 x bytes steps, and a step of cm reads five tables in device memory
// one after another's result (the counters, order-2 cell and weights
// together, then apm1, then apm2) with shared-memory lookups between.
// The bytes moved (a read in, its stream out) are small beside that.
// Design: one thread a read, one read a block (so that each read has an
// SM's L1 and schedulers to itself; blocks of 2, 8 and 32 reads were
// slower on an H100); the
// model's tables stay in device memory, SQUASH and STRETCH in shared
// memory.  A faster design (several reads sharing an SM's cycles, the
// hot tables in shared memory) is later work.

#include "common.cuh"

namespace {

constexpr unsigned PROB_BITS = 11;
constexpr unsigned TOP = 1u << 24;
constexpr int APM_N = 33;
constexpr long long CM_O0 = 0;
constexpr long long CM_O1 = 256;
constexpr long long CM_O1S = 256 + 65536;
constexpr long long CM_APM1 = CM_O1S + 65536;
constexpr long long CM_APM2 = CM_APM1 + 256 * APM_N;
constexpr long long CM_SMALL = CM_APM2 + 256 * APM_N;
constexpr long long O2_CELLS = 1LL << 24;
constexpr long long W_CELLS = 2048 * 4;

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
  __device__ void code(unsigned p, int bit) {
    const unsigned bound = (range >> PROB_BITS) * p;
    if (!bit) {
      range = bound;
    } else {
      low += bound;
      range -= bound;
    }
    while (range < TOP) {
      shift_low();
      range <<= 8;
    }
  }
  __device__ void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct Dec {
  unsigned range = 0xFFFFFFFFu, code = 0;
  const uint8_t* in;
  long long pos = 0, len;

  __device__ unsigned next() { return pos < len ? in[pos++] : 0u; }
  __device__ void init() {
    next();  // the encoder's first cache byte
    for (int i = 0; i < 4; ++i) code = (code << 8) | next();
  }
  __device__ int bit(unsigned p) {
    const unsigned bound = (range >> PROB_BITS) * p;
    int b;
    if (code < bound) {
      range = bound;
      b = 0;
    } else {
      code -= bound;
      range -= bound;
      b = 1;
    }
    while (range < TOP) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return b;
  }
};

// o0 / o1: the probability of a 0 at a tree node, adapted by shift 5
template <bool ORDER1>
struct Adaptive {
  uint16_t* probs;
  uint16_t* cell = nullptr;
  unsigned prev = 0;

  __device__ unsigned predict(unsigned ctx) {
    cell = probs + (ORDER1 ? (prev << 8) : 0u) + ctx;
    return *cell;
  }
  __device__ void update(int bit) {
    const unsigned p = *cell;
    *cell = static_cast<uint16_t>(bit ? p - (p >> 5) : p + ((2048u - p) >> 5));
  }
  __device__ void next_byte(unsigned b) { prev = b; }
};

// cm: rangecoder.c cm_predict / cm_update
struct Mix {
  uint16_t* small;
  uint16_t* o2;
  int* w;
  const short* squash;   // shared, by t + 4096
  const short* stretch;  // shared
  unsigned prev1 = 0, prev2 = 0;
  uint16_t* c[4];
  unsigned cell[4];
  int st[4];
  int mixed;
  int* wp;
  uint16_t* a[4];

  __device__ static int crate(int cnt) {
    return cnt < 1 ? 1 : cnt < 3 ? 2 : cnt < 6 ? 3 : cnt < 10 ? 4 : 5;
  }
  __device__ static int apm(const uint16_t* lo, int f) {
    return (static_cast<int>(lo[0]) * (256 - f) + static_cast<int>(lo[1]) * f)
           >> 10;
  }
  __device__ unsigned predict(unsigned ctx) {
    c[0] = small + CM_O0 + ctx;
    c[1] = small + CM_O1 + (prev1 << 8) + ctx;
    c[2] = small + CM_O1S + (prev1 << 8) + ctx;
    c[3] = o2 + ((prev1 << 16) | (prev2 << 8) | ctx);
    wp = w + (((ctx << 3) | (prev1 >> 5)) << 2);
    long long t = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cell[i] = *c[i];
      st[i] = stretch[cell[i] & 0xFFFu];
      t += static_cast<long long>(wp[i]) * st[i];
    }
    t >>= 16;
    t = t < -4095 ? -4095 : (t > 4095 ? 4095 : t);
    mixed = static_cast<int>(t);
    const int pm = squash[mixed + 4096];
    const int s1 = stretch[pm] + 4096;
    a[0] = small + CM_APM1 + ctx * APM_N + (s1 >> 8);
    a[1] = a[0] + 1;
    const int pr = (pm + apm(a[0], s1 & 255)) >> 1;
    const int s2 = stretch[pr < 1 ? 1 : (pr > 4095 ? 4095 : pr)] + 4096;
    a[2] = small + CM_APM2 + prev1 * APM_N + (s2 >> 8);
    a[3] = a[2] + 1;
    int p = (pr + apm(a[2], s2 & 255)) >> 1;
    p = p < 1 ? 1 : (p > 4094 ? 4094 : p);
    unsigned pc = static_cast<unsigned>(4096 - p) >> 1;
    return pc < 1 ? 1 : (pc > 2046 ? 2046 : pc);
  }
  __device__ void update(int bit) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int cnt = static_cast<int>(cell[i] >> 12);
      int p = static_cast<int>(cell[i] & 0xFFFu);
      const int r = i == 2 ? 8 : crate(cnt);  // o0, o1, o2 cap 5: crate's
      if (bit)
        p += (4096 - p) >> r;
      else
        p -= p >> r;
      if (p > 4095) p = 4095;
      if (cnt < 15) ++cnt;
      *c[i] = static_cast<uint16_t>((cnt << 12) | p);
    }
    const int err = (bit << 12) - squash[mixed + 4096];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // int accumulation, wrapping
      wp[i] = static_cast<int>(static_cast<unsigned>(wp[i]) +
                               static_cast<unsigned>((st[i] * err) >> 10));
    const int target = bit ? 4095 << 2 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *a[j] = static_cast<uint16_t>(*a[j] + ((target - *a[j]) >> 7));
  }
  __device__ void next_byte(unsigned b) {
    prev2 = prev1;
    prev1 = b;
  }
};

struct Scratch {
  uint16_t* probs;  // o0 / o1 tables, or cm's small tables
  uint16_t* o2;
  int* w;
};

template <int MODEL>
struct ModelOf;
template <>
struct ModelOf<0> {
  using T = Adaptive<false>;
  static constexpr long long ROW = 256;
};
template <>
struct ModelOf<1> {
  using T = Adaptive<true>;
  static constexpr long long ROW = 65536;
};
template <>
struct ModelOf<2> {
  using T = Mix;
};

// The block's SQUASH / STRETCH in shared memory (cm only), and row b's
// model over its scratch.
template <int MODEL>
__device__ typename ModelOf<MODEL>::T make_model(const Scratch& s,
                                                 const short* tables,
                                                 short* sh, long long b) {
  typename ModelOf<MODEL>::T m;
  if constexpr (MODEL == 2) {
    m.small = s.probs + b * CM_SMALL;
    m.o2 = s.o2 + b * O2_CELLS;
    m.w = s.w + b * W_CELLS;
    m.squash = sh;
    m.stretch = sh + 8192;
  } else {
    m.probs = s.probs + b * ModelOf<MODEL>::ROW;
  }
  return m;
}

template <int MODEL>
__device__ void load_tables(const short* tables, short* sh) {
  if constexpr (MODEL == 2) {
    for (int i = 0; i < 8192 + 4096; ++i) sh[i] = tables[i];
  }
}

template <int MODEL>
__global__ void rc_encode_kernel(const uint8_t* __restrict__ data,
                                 long long N,
                                 const int* __restrict__ n,
                                 uint8_t* __restrict__ out, long long W,
                                 long long* __restrict__ len, long long slack,
                                 Scratch s, const short* __restrict__ tables) {
  __shared__ short sh[MODEL == 2 ? 8192 + 4096 : 1];
  load_tables<MODEL>(tables, sh);
  const long long b = blockIdx.x;
  const long long cnt = min(max(static_cast<long long>(n[b]), 0LL), N);
  auto m = make_model<MODEL>(s, tables, sh, b);
  Enc e;
  e.out = out + b * W;
  e.cap = min(cnt + cnt / 2 + slack, W);
  const uint8_t* in = data + b * N;
  for (long long i = 0; i < cnt; ++i) {
    const unsigned byte = in[i];
    unsigned ctx = 1;
    for (int k = 7; k >= 0; --k) {
      const int bit = (byte >> k) & 1;
      e.code(m.predict(ctx), bit);
      m.update(bit);
      ctx = (ctx << 1) | bit;
    }
    m.next_byte(byte);
  }
  e.flush();
  if (e.over) {
    for (long long i = 0; i < e.cap; ++i) e.out[i] = 0;
    len[b] = -1;
  } else {
    len[b] = e.pos;
  }
}

template <int MODEL>
__global__ void rc_decode_kernel(const uint8_t* __restrict__ stream,
                                 long long M,
                                 const int* __restrict__ off,
                                 const int* __restrict__ count, long long N,
                                 uint8_t* __restrict__ out, Scratch s,
                                 const short* __restrict__ tables) {
  __shared__ short sh[MODEL == 2 ? 8192 + 4096 : 1];
  load_tables<MODEL>(tables, sh);
  const long long b = blockIdx.x;
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  const long long start = min(max(static_cast<long long>(off[b]), 0LL), M);
  auto m = make_model<MODEL>(s, tables, sh, b);
  Dec d;
  d.in = stream + b * M + start;
  d.len = M - start;
  d.init();
  uint8_t* o = out + b * N;
  for (long long i = 0; i < cnt; ++i) {
    unsigned ctx = 1;
    for (int k = 0; k < 8; ++k) {
      const int bit = d.bit(m.predict(ctx));
      m.update(bit);
      ctx = (ctx << 1) | bit;
    }
    o[i] = static_cast<uint8_t>(ctx);
    m.next_byte(ctx & 0xFFu);
  }
}

}  // namespace

HTT_EXPORT int htt_rc_encode(long long model, const void* data, long long B,
                             long long N, const void* n, void* out,
                             long long W, void* len, long long slack,
                             void* probs, void* o2, void* w,
                             const void* tables, void* cuda_stream) {
  if (B > 0) {
    const Scratch s{static_cast<uint16_t*>(probs), static_cast<uint16_t*>(o2),
                    static_cast<int*>(w)};
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* nn = static_cast<const int*>(n);
    auto* o = static_cast<uint8_t*>(out);
    auto* l = static_cast<long long*>(len);
    const auto* t = static_cast<const short*>(tables);
    auto st = static_cast<cudaStream_t>(cuda_stream);
    const unsigned g = static_cast<unsigned>(B);  // one read a block
    if (model == 0)
      rc_encode_kernel<0><<<g, 1, 0, st>>>(d, N, nn, o, W, l, slack, s, t);
    else if (model == 1)
      rc_encode_kernel<1><<<g, 1, 0, st>>>(d, N, nn, o, W, l, slack, s, t);
    else
      rc_encode_kernel<2><<<g, 1, 0, st>>>(d, N, nn, o, W, l, slack, s, t);
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_rc_decode(long long model, const void* stream, long long B,
                             long long M, const void* off, const void* count,
                             long long N, void* out, void* probs, void* o2,
                             void* w, const void* tables,
                             void* cuda_stream) {
  if (B > 0) {
    const Scratch s{static_cast<uint16_t*>(probs), static_cast<uint16_t*>(o2),
                    static_cast<int*>(w)};
    const auto* in = static_cast<const uint8_t*>(stream);
    const auto* of = static_cast<const int*>(off);
    const auto* c = static_cast<const int*>(count);
    auto* o = static_cast<uint8_t*>(out);
    const auto* t = static_cast<const short*>(tables);
    auto st = static_cast<cudaStream_t>(cuda_stream);
    const unsigned g = static_cast<unsigned>(B);  // one read a block
    if (model == 0)
      rc_decode_kernel<0><<<g, 1, 0, st>>>(in, M, of, c, N, o, s, t);
    else if (model == 1)
      rc_decode_kernel<1><<<g, 1, 0, st>>>(in, M, of, c, N, o, s, t);
    else
      rc_decode_kernel<2><<<g, 1, 0, st>>>(in, M, of, c, N, o, s, t);
  }
  return static_cast<int>(cudaGetLastError());
}
