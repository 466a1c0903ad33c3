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
// of steps (a table lookup, a multiply and a refill from the lane's
// bytes), ceil(n / 16) steps a row; the bytes (about 0.6 in, 1 out a
// coded byte) are small beside it.  Design: one warp a row, its 16 lanes
// on threads 0-15.  The decode builds the row's slot -> symbol table
// (4,096 bytes, a binary search a slot over the cumulative frequencies)
// and the lanes' starts (a shuffle scan of their lengths), then each lane
// walks its bytes forward.  It holds its states as int64 with
// two's-complement wrap and arithmetic right shifts, as PyTorch's int64
// does, so a corrupt stream decodes to the same bytes on both routes.
// Output ownership: the decode writes byte t * 16 + i of its row by lane
// i; the wrapper zeroes the output first.

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

__global__ void __launch_bounds__(32)
    rccdf_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                        const int* __restrict__ off,
                        const int* __restrict__ count, long long N,
                        const int* __restrict__ freqs,
                        uint8_t* __restrict__ out) {
  __shared__ long long f_s[256], lo_s[256], hi_s[256];
  __shared__ uint8_t lut[SLOTS];
  const long long b = blockIdx.x;
  const unsigned t = threadIdx.x;
  // cumulative frequencies: 8 symbols a thread, then a shuffle scan
  long long part = 0;
  for (int i = 0; i < 8; ++i) {
    const long long f = freqs[b * 256 + 8 * t + i];
    f_s[8 * t + i] = f;
    part += f;
  }
  long long inc = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (t >= static_cast<unsigned>(o)) inc += y;
  }
  long long acc = inc - part;
  for (int i = 0; i < 8; ++i) {
    lo_s[8 * t + i] = acc;
    acc += f_s[8 * t + i];
    hi_s[8 * t + i] = acc;
  }
  __syncwarp();
  // slot -> the first symbol whose high end passes it (255 past the sum)
  for (unsigned slot = t; slot < SLOTS; slot += 32) {
    int a = 0, z = 256;  // the answer lies in [a, z]
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (hi_s[mid] > static_cast<long long>(slot)) z = mid;
      else a = mid + 1;
    }
    lut[slot] = static_cast<uint8_t>(min(a, 255));
  }
  __syncwarp();

  const uint8_t* row = stream + b * M;
  const long long base = off[b];
  const long long cnt = min(max(static_cast<long long>(count[b]), 0LL), N);
  unsigned long long x = 0;
  long long len = 0;
  if (t < K) {
    for (int i = 0; i < 4; ++i) {
      x |= static_cast<unsigned long long>(byte_at(row, M, base + 4 * t + i))
           << (8 * i);
      len |= static_cast<long long>(
                 byte_at(row, M, base + 4 * K + 4 * t + i)) << (8 * i);
    }
  }
  long long start = len;
#pragma unroll
  for (int o = 1; o < K; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, start, o);
    if (t >= static_cast<unsigned>(o)) start += y;
  }
  if (t >= K) return;
  long long pos = base + HEAD + start - len;
  uint8_t* orow = out + b * N;
  for (long long i = t; i < cnt; i += K) {
    const unsigned slot = static_cast<unsigned>(x) & (SLOTS - 1);
    const unsigned s = lut[slot];
    const long long q = static_cast<long long>(x) >> PROB_BITS;
    x = static_cast<unsigned long long>(f_s[s]) *
            static_cast<unsigned long long>(q) +
        slot - static_cast<unsigned long long>(lo_s[s]);
    orow[i] = static_cast<uint8_t>(s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (static_cast<long long>(x) < static_cast<long long>(RANS_L)) {
        x = (x << 8) | byte_at(row, M, pos);
        ++pos;
      }
    }
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
  if (B > 0)
    rccdf_decode_kernel<<<static_cast<unsigned>(B), 32, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), M, static_cast<const int*>(off),
        static_cast<const int*>(count), N, static_cast<const int*>(freqs),
        static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
