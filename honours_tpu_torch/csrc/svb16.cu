// Kernels 5 and 6: svb16 (the VBZ container's 1-or-2-byte stream VByte)
// encode and decode.
//
// Kernel 5 replaces honours_tpu/engine/svb16_fused.py svb16_encode_fused
// (pallas_call at :153); kernel 6 replaces svb16_decode_fused (pallas_call
// at :266).  Per row of n samples (n clamped to [0, L]):
//   v[j]   = zigzag(s[j] - s[j-1]) in uint16 (s[-1] = 0), or s[j] as
//            uint16 when zd is off;
//   two[j] = v[j] >= 256;
//   stream = ceil(n/8) key bytes (bit j%8 of byte j/8 is two[j], LSB
//            first), then each sample's field: its low byte, and its high
//            byte when two[j].  Field j starts at kl + j + e(j), kl =
//            ceil(n/8), e = exclusive count of two.
// Encode writes [B, L/8 + 2L] bytes, zero past the row's length, and the
// length kl + n + ntwo.  Decode inverts it to [B, L] int16, zero past n;
// kl always comes from n, and every stream read outside the row gives 0,
// so a truncated stream decodes to garbage without faulting.
//
// The TPU kernels cannot scatter: they move every field with log-shift
// walks in VMEM, build the key bytes with a stride-8 compaction and align
// the ragged key area with 128-lane dynamic stores.  Hopper scatters and
// gathers bytes natively, so each field's offset is a scan and one store
// or load; a thread's 16 consecutive two-byte flags are exactly its 2 key
// bytes.
// Bound on this card: bytes.  Encode reads 2 B per live sample and writes
// the whole row, L/8 + 2L bytes; decode reads the stream to its length
// and writes 2 B per sample; a few integer operations per sample.
// Both kernels cut every row into tiles (kernel 1's compaction in
// permute.cu does the same), so the grid is rows x tiles and one wide row
// fills the card as well as many short ones; a row of several tiles hands
// them out by an atomic ticket in launch order, so every tile a block
// waits on already holds an SM.  The count of two-byte fields before a
// tile comes from a single-pass decoupled look-back over one 64-bit word
// per tile (flag and value in one store) in a zeroed scratch from the
// wrapper; rows of one tile take none.
// Kernel 5's design: tiles of ETILE = 128 threads x 16 samples.
// - A thread loads its 16 samples as two 16-byte vectors where the row is
//   aligned (scalar loads elsewhere; a sig view may start at any even
//   address), and for zd the sample before them: a delta needs only the
//   previous sample, so encode carries nothing across tiles but the count.
// - Its 16 two-byte flags are exactly its 2 key bytes, stored at once; a
//   popcount and one block scan give the tile's count c_t and each
//   thread's place in the tile; the look-back gives E_t, the count before
//   the tile.
// - The tile's fields are one span of nt + c_t bytes (nt: its samples
//   below n) from kl + t0 + E_t.  The block stages it in shared memory at
//   its 16-byte line phase, then stores whole aligned lines that lie
//   inside the span and the bytes of the partial lines at its two ends.
// One writer for every byte.  Row of n live samples (n clamped to
// [0, L]), kl = ceil(n/8), N2 = the row's two-byte count, len = kl + n +
// N2, W = L/8 + 2L; tile t holds samples [t0, t0 + nt), t0 = t * ETILE,
// and E_{t+1} = E_t + c_t:
//   [0, kl)         key bytes: byte k by the tile holding sample 8k
//                   (ETILE % 8 == 0, so no key byte straddles two tiles);
//   [kl, len)       fields: tile t writes [kl + t0 + E_t,
//                   kl + t0 + nt + E_{t+1});
//   [len, kl + 2n)  zeros: tile t writes [kl + 2n - (t0 + nt - E_{t+1}),
//                   kl + 2n - (t0 - E_t)), its nt - c_t bytes counted back
//                   from kl + 2n (every live tile before the last is full,
//                   so t0 - E_t one-byte fields lie before tile t); the
//                   ranges are disjoint and together cover [len, kl + 2n),
//                   so the zero tail waits on no later tile;
//   [kl + 2n, W)    zeros known without a count: tile t writes its
//                   columns [t * EWT, (t + 1) * EWT), EWT = ETILE/8 +
//                   2 ETILE, of it, tiles past n included, with no wait.
// Every live tile writes 2 nt bytes of fields and zeros.  A 16-byte store
// covers only bytes of its own tile's range (lines wholly inside it;
// bytes at its ends), key bytes are byte stores, and out_len[row] is
// written by the tile holding sample n - 1 (by tile 0 when n = 0).  A
// tile past n publishes no state and waits on none: no live tile waits
// on it, since only later tiles, also past n, lie after it.
// Kernel 6's design: tiles of DTILE = 128 threads x 16 samples.
// - A thread reads its two key bytes; a popcount and one block scan give
//   the tile-local count of two-byte fields before each thread, and the
//   look-back the count before the tile: the tile publishes its count at
//   once and its inclusive count when known.
// - The tile's fields are one span of at most 2 x DTILE bytes from
//   kl + tile start + count before; the block copies it into shared
//   memory as 16-byte lines (byte by byte, zeros outside the row, at the
//   row's ends), so a cut stream decodes to garbage without a fault, and
//   each thread reads its fields there.
// - zd: the running sum mod 2^16 of the deltas is a second carry, known
//   only once the tile has read its fields.  It rides on the same word
//   as two more states (inclusive count and sum aggregate, then both
//   inclusive): one store publishes both carries and one load reads
//   both, where a second chain would double the look-back's polling
//   loads; a tile's sum look-back starts after its count look-back has
//   ended, so the states only rise.  With zd off the word stops at its
//   second state.
// - Each thread writes its 16 int16 as two 16-byte stores where aligned;
//   a tile past n writes its zeros and takes part in no look-back (no
//   tile that waits lies after it).

#include "common.cuh"

namespace {

constexpr int ET = 128;            // encode: threads a tile
constexpr int EEPT = 16;           // encode: samples a thread
constexpr int ETILE = 2048;
static_assert(ETILE == ET * EEPT && ETILE % 8 == 0,
              "a tile is 16 samples a thread and whole key bytes");
constexpr int ESPAN = 2 * ETILE + 16;  // a tile's fields, from a line start
// columns of [kl + 2n, W) an encode tile owns
constexpr long long EWT = ETILE / 8 + 2 * ETILE;
constexpr int DT = 128;            // decode: threads a tile
constexpr int DEPT = 16;           // decode: samples a thread
constexpr int DTILE = 2048;
static_assert(DTILE == DT * DEPT, "a tile is 16 samples a thread");
constexpr int SPAN = 2 * DTILE + 32;  // a tile's fields, from a line start
constexpr unsigned FULL = 0xffffffffu;
// look-back word: count of two-byte fields in bits 0-31, (decode, zd) the
// sum mod 2^16 in bits 32-47, the state from bit 48; encode uses the first
// two states
constexpr int ST_SHIFT = 48;
constexpr unsigned COUNT_AGG = 1, COUNT_INCL = 2, SUM_AGG = 3, SUM_INCL = 4;

// Block-wide exclusive sum of one int per thread (NT threads); *total
// gets the block's sum.  Every thread of the block must call it.
template <int NT>
__device__ int block_excl_sum(int v, int* warp_sums, int* total_smem,
                              int* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < NW ? warp_sums[lane] : 0;
    int s = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < NW) warp_sums[lane] = s - c;
    if (lane == 31) *total_smem = s;
  }
  __syncthreads();
  const int r = warp_sums[warp] + incl - v;
  *total = *total_smem;
  __syncthreads();  // warp_sums and the total are rewritten by the next call
  return r;
}

// Warp 0: the sum of field (s >> shift) & vmask over the tiles before
// tile t, back to the nearest one whose state is at least `incl`; waits
// on tiles whose state is below `ready`.
__device__ __forceinline__ unsigned look_back(const unsigned long long* st,
                                              long long t, unsigned ready,
                                              unsigned incl, int shift,
                                              unsigned vmask) {
  const int lane = threadIdx.x;
  unsigned excl = 0;
  for (long long jb = t - 1;; jb -= 32) {
    const long long idx = jb - lane;
    unsigned long long s = static_cast<unsigned long long>(incl) << ST_SHIFT;
    if (idx >= 0) {
      do { s = htt_ld_status(st + idx); } while ((s >> ST_SHIFT) < ready);
    }
    const unsigned in = __ballot_sync(FULL, (s >> ST_SHIFT) >= incl);
    const int stop = in ? __ffs(in) - 1 : 31;
    unsigned add = lane <= stop ? static_cast<unsigned>(s >> shift) & vmask : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) add += __shfl_xor_sync(FULL, add, d);
    excl += add;
    if (in) return excl;
  }
}

__device__ __forceinline__ unsigned long long state_word(unsigned state,
                                                         unsigned count,
                                                         unsigned sum) {
  return (static_cast<unsigned long long>(state) << ST_SHIFT)
         | (static_cast<unsigned long long>(sum & 0xFFFFu) << 32) | count;
}

// samples [j0, j0 + DEPT) of a row of L, two a word in v (sample j0 + 2k
// in the low half of v[k]): as two 16-byte stores when aligned and whole
__device__ __forceinline__ void store_samples(int16_t* o, long long j0,
                                              long long L,
                                              const unsigned (&v)[DEPT / 2]) {
  int16_t* p = o + j0;
  if (j0 + DEPT <= L && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < DEPT; ++k)
      if (j0 + k < L) p[k] = static_cast<int16_t>(v[k >> 1] >> (16 * (k & 1)));
  }
}

__device__ __forceinline__ unsigned unzigzag(unsigned z) {
  return ((z >> 1) ^ (0u - (z & 1u))) & 0xFFFFu;
}

// o[lo, hi) = 0 by the block: aligned 16-byte lines wholly inside the
// range, byte stores for the partial lines at its two ends
__device__ __forceinline__ void zero_bytes(uint8_t* o, long long lo,
                                           long long hi) {
  if (lo >= hi) return;
  const long long la =
      lo + ((16 - (reinterpret_cast<uintptr_t>(o + lo) & 15)) & 15);
  if (la + 16 > hi) {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) o[i] = 0;
    return;
  }
  const long long lb = la + ((hi - la) & ~15LL);
  if (lo + threadIdx.x < la) o[lo + threadIdx.x] = 0;
  if (lb + threadIdx.x < hi) o[lb + threadIdx.x] = 0;
  for (long long i = la + 16LL * threadIdx.x; i < lb; i += 16LL * blockDim.x)
    *reinterpret_cast<uint4*>(o + i) = make_uint4(0, 0, 0, 0);
}

// As kernel 6: small tiles, 16 to an SM, hide each other's waits on
// device memory (ticket, samples, look-back); tiles of 4096 samples, or
// 12 tiles an SM, were no faster (PERF.md §6, kernel 5 variants).
__global__ void __launch_bounds__(ET, 16)
svb16_encode_kernel(const int16_t* __restrict__ sig,
                    const int* __restrict__ n_in, long long L, long long W,
                    long long tiles, int zd, uint8_t* __restrict__ out,
                    int* __restrict__ out_len,
                    unsigned long long* __restrict__ status) {
  __shared__ __align__(16) uint8_t s_span[ESPAN];
  __shared__ int warp_sums[ET / 32];
  __shared__ int total_smem;
  __shared__ unsigned s_carry;
  const long long g = htt_take_ticket(status, tiles);
  const long long row = g / tiles, t = g % tiles;
  const int16_t* s = sig + row * L;
  uint8_t* o = out + row * W;
  const long long n = min(max(static_cast<long long>(n_in[row]), 0LL), L);
  const long long kl = (n + 7) >> 3;
  const long long t0 = t * ETILE;
  if (t0 >= n) {  // zeros of [kl + 2n, W) only; no tile waits on this one
    zero_bytes(o, max(kl + 2 * n, t * EWT), min(W, (t + 1) * EWT));
    if (n == 0 && t == 0 && threadIdx.x == 0) out_len[row] = 0;
    return;
  }

  // the thread's samples [j0, j0 + EEPT), two a word (sample j0 + 2k in
  // the low half of w[k]), zero from n on; then v, zigzag of the deltas
  // for zd, and bit k of `bits` when sample j0 + k takes two bytes
  const long long j0 = t0 + static_cast<long long>(threadIdx.x) * EEPT;
  unsigned w[EEPT / 2];
#pragma unroll
  for (int k = 0; k < EEPT / 2; ++k) w[k] = 0;
  unsigned bits = 0;
  if (j0 < n) {
    const int16_t* p = s + j0;
    if (j0 + EEPT <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[0];
      const uint4 b = reinterpret_cast<const uint4*>(p)[1];
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < EEPT; ++k)
        if (j0 + k < n)
          w[k >> 1] |= static_cast<unsigned>(static_cast<uint16_t>(p[k]))
                       << (16 * (k & 1));
    }
    unsigned prev = zd && j0 > 0 ? static_cast<uint16_t>(p[-1]) : 0u;
#pragma unroll
    for (int k = 0; k < EEPT; ++k) {
      const unsigned u = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
      unsigned v = u;
      if (zd) {
        const unsigned d = (u - prev) & 0xFFFFu;
        v = ((d << 1) ^ (0u - (d >> 15))) & 0xFFFFu;
        prev = u;
      }
      if (j0 + k >= n) v = 0;
      bits |= (v >= 256u ? 1u : 0u) << k;
      w[k >> 1] = (w[k >> 1] & (0xFFFF0000u >> (16 * (k & 1))))
                  | (v << (16 * (k & 1)));
    }
    // key bytes j0/8 and j0/8 + 1: byte k is written iff 8k < n
    o[j0 >> 3] = static_cast<uint8_t>(bits);
    if (j0 + 8 < n) o[(j0 >> 3) + 1] = static_cast<uint8_t>(bits >> 8);
  }
  int c_tile;
  const int e_thr = block_excl_sum<ET>(__popc(bits), warp_sums, &total_smem,
                                       &c_tile);
  unsigned long long* st = status + row * tiles;
  if (tiles > 1 && threadIdx.x == 0)
    htt_st_status(st + t, state_word(t > 0 ? COUNT_AGG : COUNT_INCL, c_tile, 0));
  zero_bytes(o, max(kl + 2 * n, t * EWT), min(W, (t + 1) * EWT));
  if (threadIdx.x < 32) {
    unsigned E = 0;
    if (tiles > 1 && t > 0) {
      E = look_back(st, t, COUNT_AGG, COUNT_INCL, 0, 0xFFFFFFFFu);
      if (threadIdx.x == 0)
        htt_st_status(st + t, state_word(COUNT_INCL, E + c_tile, 0));
    }
    if (threadIdx.x == 0) s_carry = E;
  }
  __syncthreads();
  const long long E = s_carry;
  const long long nt = min(n - t0, static_cast<long long>(ETILE));
  if (threadIdx.x == 0 && t0 + nt == n)
    out_len[row] = static_cast<int>(kl + n + E + c_tile);

  // the span [a0, a0 + len) of row bytes, staged from s_span[q0] on
  const long long a0 = kl + t0 + E;
  const int len = static_cast<int>(nt) + c_tile;
  const int q0 = static_cast<int>(reinterpret_cast<uintptr_t>(o + a0) & 15);
  int off = q0 + static_cast<int>(j0 - t0) + e_thr;
#pragma unroll
  for (int k = 0; k < EEPT; ++k) {
    if (j0 + k < n) {
      const unsigned v = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
      s_span[off] = static_cast<uint8_t>(v);
      if ((bits >> k) & 1u) s_span[off + 1] = static_cast<uint8_t>(v >> 8);
      off += 1 + static_cast<int>((bits >> k) & 1u);
    }
  }
  __syncthreads();
  const long long base = a0 - q0;
  const int lines = (q0 + len + 15) >> 4;
  for (int i = threadIdx.x; i < lines; i += ET) {
    const int b0 = 16 * i;
    if (b0 >= q0 && b0 + 16 <= q0 + len) {
      *reinterpret_cast<uint4*>(o + base + b0) =
          reinterpret_cast<const uint4*>(s_span)[i];
    } else {
      for (int j = max(b0, q0); j < min(b0 + 16, q0 + len); ++j)
        o[base + j] = s_span[j];
    }
  }
  // its share of [len, kl + 2n), counted back from kl + 2n
  const long long z1 = kl + 2 * n - (t0 - E);
  zero_bytes(o, z1 - (nt - c_tile), z1);
}

// Small tiles, many to an SM: a tile's time is mostly waits on device
// memory (ticket, key bytes, look-back, span), which 16 resident tiles of
// 128 threads (at most 32 registers each) hide from each other.  Tiles of
// 4096 or 8192 samples, 3-6 to an SM, were 18-31% slower (PERF.md, PR 6).
__global__ void __launch_bounds__(DT, 16)
svb16_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                    const int* __restrict__ n_in, long long L,
                    long long tiles, int zd, int16_t* __restrict__ out,
                    unsigned long long* __restrict__ status) {
  __shared__ __align__(16) uint8_t s_span[SPAN];
  __shared__ int warp_sums[DT / 32];
  __shared__ int total_smem;
  __shared__ unsigned s_carry;
  const long long g = htt_take_ticket(status, tiles);
  const long long row = g / tiles, t = g % tiles;
  const uint8_t* s = stream + row * M;
  int16_t* o = out + row * L;
  const long long n = min(max(static_cast<long long>(n_in[row]), 0LL), L);
  const long long t0 = t * DTILE;
  const long long j0 = t0 + static_cast<long long>(threadIdx.x) * DEPT;
  unsigned v[DEPT / 2];  // the samples, two a word
#pragma unroll
  for (int k = 0; k < DEPT / 2; ++k) v[k] = 0;
  if (t0 >= n) {  // all zeros, and no later tile of the row waits on it
    store_samples(o, j0, L, v);
    return;
  }
  const long long kl = (n + 7) >> 3;
  // bit k: sample j0 + k < n takes two bytes; live: the samples below n
  const unsigned live = j0 >= n ? 0u
                        : n - j0 >= DEPT ? 0xFFFFu
                                         : (1u << (n - j0)) - 1u;
  unsigned bits = 0;
  if (live) {
    const long long p = j0 >> 3;
    const unsigned b0 = p < M ? s[p] : 0u, b1 = p + 1 < M ? s[p + 1] : 0u;
    bits = (b0 | (b1 << 8)) & live;
  }
  int c_tile;
  const int e_thr = block_excl_sum<DT>(__popc(bits), warp_sums, &total_smem,
                                       &c_tile);
  unsigned long long* st = status + row * tiles;
  if (threadIdx.x < 32) {
    unsigned E = 0;
    if (tiles > 1) {
      if (t > 0) {
        if (threadIdx.x == 0) htt_st_status(st + t, state_word(COUNT_AGG, c_tile, 0));
        E = look_back(st, t, COUNT_AGG, COUNT_INCL, 0, 0xFFFFFFFFu);
      }
      if (threadIdx.x == 0)
        htt_st_status(st + t, state_word(COUNT_INCL, E + c_tile, 0));
    }
    if (threadIdx.x == 0) s_carry = E;
  }
  __syncthreads();
  const long long E = s_carry;

  // stage the span [a0, a0 + len) of row bytes from s_span[q0] on
  const long long a0 = kl + t0 + E;
  const long long len = min(n - t0, static_cast<long long>(DTILE)) + c_tile;
  const int q0 = static_cast<int>(reinterpret_cast<uintptr_t>(s + a0) & 15);
  const long long base = a0 - q0;
  const int lines = static_cast<int>((q0 + len + 15) >> 4);
  for (int i = threadIdx.x; i < lines; i += DT) {
    const long long lo = base + 16LL * i;
    uint4 w;
    if (lo >= 0 && lo + 16 <= M) {
      w = *reinterpret_cast<const uint4*>(s + lo);
    } else {
      unsigned b[4] = {0, 0, 0, 0};
      for (int j = 0; j < 16; ++j)
        if (lo + j >= 0 && lo + j < M)
          b[j >> 2] |= static_cast<unsigned>(s[lo + j]) << (8 * (j & 3));
      w = make_uint4(b[0], b[1], b[2], b[3]);
    }
    reinterpret_cast<uint4*>(s_span)[i] = w;
  }
  __syncthreads();

  int off = q0 + static_cast<int>(j0 - t0) + e_thr;
#pragma unroll
  for (int k = 0; k < DEPT; ++k) {
    const unsigned two = (bits >> k) & 1u;
    if ((live >> k) & 1u) {
      const unsigned f = s_span[off] | (two ? static_cast<unsigned>(s_span[off + 1]) << 8 : 0u);
      v[k >> 1] |= (zd ? unzigzag(f) : f) << (16 * (k & 1));
    }
    off += 1 + static_cast<int>(two);
  }

  if (zd) {  // v holds the deltas: prefix sums mod 2^16 across the row
    unsigned sum = 0;
#pragma unroll
    for (int k = 0; k < DEPT / 2; ++k) sum += (v[k] & 0xFFFFu) + (v[k] >> 16);
    int s_tile;
    const unsigned before = static_cast<unsigned>(block_excl_sum<DT>(
        static_cast<int>(sum), warp_sums, &total_smem, &s_tile));
    if (threadIdx.x < 32) {
      unsigned P = 0;
      const unsigned cnt = static_cast<unsigned>(E) + c_tile;
      if (tiles > 1) {
        if (t > 0) {
          if (threadIdx.x == 0)
            htt_st_status(st + t, state_word(SUM_AGG, cnt, s_tile));
          P = look_back(st, t, SUM_AGG, SUM_INCL, 32, 0xFFFFu);
        }
        if (threadIdx.x == 0)
          htt_st_status(st + t, state_word(SUM_INCL, cnt, P + s_tile));
      }
      if (threadIdx.x == 0) s_carry = P;
    }
    __syncthreads();
    unsigned run = s_carry + before;
#pragma unroll
    for (int k = 0; k < DEPT / 2; ++k) {
      const unsigned lo = run + (v[k] & 0xFFFFu);
      run = lo + (v[k] >> 16);
      v[k] = (((live >> (2 * k)) & 1u) ? lo & 0xFFFFu : 0u)
             | (((live >> (2 * k + 1)) & 1u) ? run << 16 : 0u);
    }
  }
  store_samples(o, j0, L, v);
}

}  // namespace

// status: B * tiles + 1 zeroed words (tile states, then the ticket), or
// null when tiles == 1
HTT_EXPORT int htt_svb16_encode(const void* sig, const void* n, long long B,
                                long long L, long long W, long long zd,
                                void* out, void* out_len, long long tiles,
                                void* status, void* stream) {
  if (B > 0 && tiles > 0) {
    svb16_encode_kernel<<<static_cast<unsigned>(B * tiles), ET, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(sig), static_cast<const int*>(n), L, W,
        tiles, static_cast<int>(zd), static_cast<uint8_t*>(out),
        static_cast<int*>(out_len), static_cast<unsigned long long*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}

// status: B * tiles + 1 zeroed words (tile states, then the ticket), or
// null when tiles == 1
HTT_EXPORT int htt_svb16_decode(const void* st, long long B, long long M,
                                const void* n, long long L, long long zd,
                                void* out, long long tiles, void* status,
                                void* stream) {
  if (B > 0 && tiles > 0) {
    svb16_decode_kernel<<<static_cast<unsigned>(B * tiles), DT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(st), M, static_cast<const int*>(n), L,
        tiles, static_cast<int>(zd), static_cast<int16_t*>(out),
        static_cast<unsigned long long*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}
