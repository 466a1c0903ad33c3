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
// or load; a warp's ballot over 32 consecutive samples is exactly its 4
// key bytes.
// Bound on this card: bytes.  Encode reads 2 B per sample and writes
// about 1.1; decode the reverse; a few integer operations per sample.
// Kernel 5's design: one block per row, the row walked in chunks of PT
// samples with a running count of two-byte fields.  Key, data and
// zero-fill writes of a row go to disjoint byte ranges ([0, kl),
// [kl, len), [len, W)), so no write order between threads matters.
// Kernel 6's design, as kernel 1's compaction (permute.cu): every row is
// cut into tiles of DTILE = 128 threads x 16 samples and the grid is
// rows x tiles, so one wide row fills the card as well as many short
// ones; a row of several tiles hands them out by an atomic ticket in
// launch order.
// - A thread reads its two key bytes; a popcount and one block scan give
//   the tile-local count of two-byte fields before each thread.  The
//   count before the tile comes from a single-pass decoupled look-back
//   over one 64-bit word per tile in a zeroed scratch from the wrapper
//   (rows of one tile take none): the tile publishes its count at once
//   and its inclusive count when known.
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

constexpr int PT = 512;
constexpr int DT = 128;            // decode: threads a tile
constexpr int DEPT = 16;           // decode: samples a thread
constexpr int DTILE = 2048;
static_assert(DTILE == DT * DEPT, "a tile is 16 samples a thread");
constexpr int SPAN = 2 * DTILE + 32;  // a tile's fields, from a line start
constexpr unsigned FULL = 0xffffffffu;
// decode look-back word: count of two-byte fields in bits 0-31, the zd
// sum mod 2^16 in bits 32-47, the state from bit 48
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

__global__ void __launch_bounds__(PT)
svb16_encode_kernel(const int16_t* __restrict__ sig,
                    const int* __restrict__ n_in, long long L, long long W,
                    int zd, uint8_t* __restrict__ out,
                    int* __restrict__ out_len) {
  __shared__ int warp_sums[PT / 32];
  __shared__ int total_smem;
  const long long row = blockIdx.x;
  const int16_t* s = sig + row * L;
  uint8_t* o = out + row * W;
  const long long n = min(max(static_cast<long long>(n_in[row]), 0LL), L);
  const long long kl = (n + 7) >> 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < n; base += PT) {
    const long long j = base + threadIdx.x;
    const bool valid = j < n;
    unsigned v = 0;
    if (valid) {
      const unsigned u = static_cast<uint16_t>(s[j]);
      if (zd) {
        const unsigned prev = j > 0 ? static_cast<uint16_t>(s[j - 1]) : 0u;
        const unsigned d = (u - prev) & 0xFFFFu;
        v = ((d << 1) & 0xFFFFu) ^ ((d >> 15) ? 0xFFFFu : 0u);
      } else {
        v = u;
      }
    }
    const bool two = v >= 256u;
    const unsigned m = __ballot_sync(0xffffffffu, two);
    if (lane == 0) {
      const long long k0 = (base + warp * 32) >> 3;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + i < kl) o[k0 + i] = static_cast<uint8_t>(m >> (8 * i));
    }
    int ntwo;
    const int e = block_excl_sum<PT>(two ? 1 : 0, warp_sums, &total_smem,
                                     &ntwo);
    if (valid) {
      const long long off = kl + j + carry + e;
      o[off] = static_cast<uint8_t>(v);
      if (two) o[off + 1] = static_cast<uint8_t>(v >> 8);
    }
    carry += ntwo;
  }
  const long long len = kl + n + carry;
  for (long long i = len + threadIdx.x; i < W; i += PT) o[i] = 0;
  if (threadIdx.x == 0) out_len[row] = static_cast<int>(len);
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

HTT_EXPORT int htt_svb16_encode(const void* sig, const void* n, long long B,
                                long long L, long long W, long long zd,
                                void* out, void* out_len, void* stream) {
  if (B > 0) {
    svb16_encode_kernel<<<static_cast<unsigned>(B), PT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(sig), static_cast<const int*>(n), L, W,
        static_cast<int>(zd), static_cast<uint8_t*>(out),
        static_cast<int*>(out_len));
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
