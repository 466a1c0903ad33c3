// Kernels I and J: MSB-first fixed-width bit packing and unpacking over
// ragged rows.
//
// No TPU kernel stands behind them: honours_tpu packs the uint family's
// and flat_uint_submin's fields on the host only (honours_tpu/kernels/
// bitpack.py:26 pack_bits and :38 unpack_bits, numpy bit matrices,
// reached through codecs/uintc.py and codecs/flats.py), and these are
// their counterparts on the card.  A row r is (its values at val_off[r],
// count[r] fields of width b = width[r], clamped to [0, 16]): field i
// holds the low b bits of value i, MSB-first at stream bits [i b, i b +
// b) of the row, the last byte padded with zeros in its low bits, as
// np.packbits does; the row's ceil(count b / 8) bytes sit at out_off[r].
// The uint codecs have one row a read, flat_uint_submin one a segment.
//
// Bound on this card: bytes.  I reads each value once (4 B) and writes
// each packed byte once, J the reverse; a field needs a few shifts and
// masks.
//
// Kernel I's design: a thread a group of 8 fields.  Eight fields of width
// b are exactly b whole bytes, so group g of a row is its bytes [g b, g b
// + b), packed with no division and no bit shared with another thread;
// the row's last group pads its missing fields with 0 and writes
// ceil(rem b / 8) bytes.  The wrapper gives the exclusive prefix of the
// rows' group counts (ceil(count / 8), 0 for b = 0), [R + 1] with the
// total last, read on the card, so the launch needs no host sync.  A
// grid-stride loop gives each warp 32 consecutive groups: lanes 0 and 1
// search the prefix for the rows of its first and last group, and a warp
// that straddles rows searches a thread a group between those two.  A
// thread reads its 8 values as two 16-byte loads where they are whole and
// aligned (scalar loads where not) and packs them into a 128-bit pair of
// registers, MSB-first.  A warp whose groups are all of one row stages
// their bytes in shared memory at the output's misalignment and stores
// them as aligned 16-byte words, with a byte head and tail; a warp that
// straddles rows stores each group's bytes from its thread.  (Without
// the staging, uint_zd's bucket took 0.067 ms against 0.062, turbopfor's
// and flats' rows, whose warps mostly straddle rows, 0.074 and 0.083
// against 0.080 and 0.090: the uint codecs launch I six times as often.)
//
// Kernel J's design mirrors I's: a thread a group of 8 fields, its input
// exactly the row's bytes [g b, g b + b), with no division.  The wrapper
// gives the exclusive prefix of the rows' group counts (ceil(count / 8) for
// every row, b = 0 too: such a row still writes its count zeros), [R + 1]
// with the total last, read on the card.  A grid-stride loop gives each warp
// 32 consecutive groups; the whole warp finds the rows of its first and last
// group by a 32-ary search of the prefix (warp_row_in: 2 rounds of 32 probes
// for uint's 256 rows, 4 for flats' 198,144 segment rows), and a warp that
// straddles rows searches a thread a group between those two.  A thread
// loads its group's bytes as the 5 aligned 4-byte words that cover them
// (neighbouring lanes' words overlap, so a warp's loads coalesce); a word
// that would touch memory outside [0, S) is read a byte at a time, those
// bytes as 0.  It takes its 16 bytes from the 5 words (a byte permute to
// big-endian and a funnel shift), zeroes the bytes at or past its row's
// in_len (so a cut stream reads 0 there), and extracts the 8 fields
// MSB-first from two 64-bit windows: fields 0-3 from bits [0, 64), fields
// 4-7 from bits [4 b, 4 b + 64).  The warp reconverges, then stores each
// group's fields as two 16-byte words where out + out_off[r] + 8 g is
// 16-byte aligned (uint's and turbopfor's rows when L is a multiple of 4,
// flats' when the step is one), else, and for a row's last group, a field at
// a time.  32 registers, 8 blocks an SM.  Ablations (PERF.md): without the
// reconvergence the stores went out diverged and took twice as long; a
// binary search on two lanes, 46 registers, a one-row warp's bytes staged in
// shared memory as 16-byte words (I's design), and a warp's fields staged
// there and stored as one run of 16-byte words were each slower.
//
// Output ownership: I writes row r's bytes only from the warps of r's
// groups: byte j from the thread of group j / b, or, in a warp whose
// groups are all of row r, from one lane of that warp; rows' byte ranges
// are the caller's to keep apart.  J writes out[out_off[r] + i] only from
// the thread of group (r, i / 8), each element once.

#include "common.cuh"

namespace {

// The row r with off[r] <= t < off[r + 1] of a non-decreasing prefix
// off with off[lo] <= t < off[hi].
__device__ __forceinline__ long long row_in(const long long* __restrict__ off,
                                            long long lo, long long hi,
                                            long long t) {
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (off[mid] <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

// The row of t in an [R + 1] prefix with off[0] = 0 and t < off[R].
__device__ __forceinline__ long long row_of(const long long* __restrict__ off,
                                            long long R, long long t) {
  return row_in(off, 0, R, t);
}

__device__ __forceinline__ int clamp_width(long long b) {
  return static_cast<int>(b < 0 ? 0 : (b > 16 ? 16 : b));
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int PTHREADS = 256;
constexpr int WSTAGE = 32 * 16 + 32;  // a warp's groups at the misalignment

// Byte j (0-15) of a group packed left-aligned in (hi, lo).
__device__ __forceinline__ unsigned group_byte(unsigned long long hi,
                                               unsigned long long lo, int j) {
  return static_cast<unsigned>(
      (j < 8 ? hi >> (56 - 8 * j) : lo >> (120 - 8 * j)) & 0xff);
}

__global__ void __launch_bounds__(PTHREADS)
    bitpack_kernel(const int* __restrict__ values,
                   const long long* __restrict__ val_off,
                   const long long* __restrict__ count,
                   const long long* __restrict__ width,
                   const long long* __restrict__ grp_off, long long R,
                   uint8_t* __restrict__ out,
                   const long long* __restrict__ out_off) {
  __shared__ __align__(16) uint8_t stage_s[PTHREADS / 32][WSTAGE];
  const long long total = grp_off[R];
  const unsigned lane = threadIdx.x & 31;
  uint8_t* stage = stage_s[threadIdx.x >> 5];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31u);
       base < total; base += stride) {
    // the rows of the warp's first and last group
    const long long last = min(base + 31, total - 1);
    long long rr = 0;
    if (lane < 2) rr = row_of(grp_off, R, lane ? last : base);
    const long long r0 = __shfl_sync(FULL, rr, 0);
    const long long r1 = __shfl_sync(FULL, rr, 1);
    const long long g = base + lane;
    const long long r = r0 == r1 || g > last ? r0 : row_in(grp_off, r0,
                                                            r1 + 1, g);
    const int b = clamp_width(width[r]);
    const long long gl = g - grp_off[r];  // the group within its row
    const int nf = static_cast<int>(min(8LL, count[r] - 8 * gl));
    const int nbytes = (nf * b + 7) >> 3;
    unsigned long long hi = 0, lo = 0;
    if (g <= last) {
      const int* v = values + val_off[r] + 8 * gl;
      int f[8];
      if (nf == 8 && (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
        const int4 a = reinterpret_cast<const int4*>(v)[0];
        const int4 c = reinterpret_cast<const int4*>(v)[1];
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = i < nf ? v[i] : 0;
      }
      // the fields' 8 b bits, MSB-first, right-aligned in (hi, lo), then
      // left-aligned
      const unsigned mask = (1u << b) - 1u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hi = (hi << b) | (lo >> (64 - b));
        lo = (lo << b) | (static_cast<unsigned>(f[i]) & mask);
      }
      const int sh = 128 - 8 * b;
      if (sh >= 64) {
        hi = lo << (sh - 64);
        lo = 0;
      } else if (sh > 0) {
        hi = (hi << sh) | (lo >> (64 - sh));
        lo <<= sh;
      }
    }
    if (r0 == r1) {
      // one row: stage the warp's bytes at the output's misalignment, then
      // aligned 16-byte words, bytes at the run's ends
      const long long g0 = base - grp_off[r0];
      const long long gz = last - grp_off[r0];
      const int fz = static_cast<int>(min(8LL, count[r0] - 8 * gz));
      const long long n_run = (gz - g0) * b + ((fz * b + 7) >> 3);
      uint8_t* dst = out + out_off[r0] + g0 * b;
      const unsigned mis = static_cast<unsigned>(
          reinterpret_cast<uintptr_t>(dst) & 15);
      if (g <= last)
        for (int j = 0; j < nbytes; ++j)
          stage[mis + lane * b + j] = static_cast<uint8_t>(
              group_byte(hi, lo, j));
      __syncwarp();
      const long long zend = mis + n_run;
      uint8_t* dst0 = dst - mis;
      for (long long k = lane; 16 * k < zend; k += 32) {
        const long long a = 16 * k;
        if (a >= mis && a + 16 <= zend) {
          *reinterpret_cast<uint4*>(dst0 + a) =
              *reinterpret_cast<const uint4*>(stage + a);
        } else {
          for (long long j = max(a, static_cast<long long>(mis));
               j < min(a + 16, zend); ++j)
            dst0[j] = stage[j];
        }
      }
      __syncwarp();
    } else if (g <= last) {
      uint8_t* dst = out + out_off[r] + gl * b;
      for (int j = 0; j < nbytes; ++j)
        dst[j] = static_cast<uint8_t>(group_byte(hi, lo, j));
    }
  }
}

// The row r with off[r] <= t < off[r + 1], lo <= r < hi, of a
// non-decreasing prefix with off[lo] <= t < off[hi], by the whole warp: a
// round probes 32 points of [lo, hi) (lane l at lo + (l + 1) span / 32),
// and the ballot of off[p] <= t, true for a prefix of the lanes, keeps
// the span between the last probe that holds and the next: a 32-ary
// search, 2 rounds for uint's 256 rows, 4 for flats' 198,144.
__device__ __forceinline__ long long warp_row_in(
    const long long* __restrict__ off, long long lo, long long hi,
    long long t, unsigned lane) {
  while (hi - lo > 1) {
    const long long span = hi - lo;
    const long long p = lo + ((static_cast<long long>(lane) + 1) * span >> 5);
    const int c = __popc(__ballot_sync(FULL, p < hi && off[p] <= t));
    const long long nlo = c ? lo + (static_cast<long long>(c) * span >> 5)
                            : lo;
    hi = lo + ((static_cast<long long>(c) + 1) * span >> 5);
    lo = nlo;
  }
  return lo;
}

constexpr int UTHREADS = 256;

// 4 bytes of the stream from x on, little-endian, a byte outside [0, S)
// reading as 0
__device__ __forceinline__ unsigned word_at(const uint8_t* __restrict__ s,
                                            long long S, long long x) {
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (x + k >= 0 && x + k < S) v |= static_cast<unsigned>(s[x + k]) << 8 * k;
  return v;
}

// The 16 bytes from byte o (0-3) of 5 little-endian words, big-endian: r[0]
// holds the first 4 bytes, the first in its top bits.
__device__ __forceinline__ void be128(const unsigned (&w)[5], unsigned o,
                                      unsigned (&r)[4]) {
  unsigned e[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) e[q] = __byte_perm(w[q], 0, 0x0123);
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = __funnelshift_l(e[q + 1], e[q], 8 * o);
}

__global__ void __launch_bounds__(UTHREADS, 8)
    bitunpack_kernel(const uint8_t* __restrict__ stream, long long S,
                     const long long* __restrict__ in_off,
                     const long long* __restrict__ in_len,
                     const long long* __restrict__ count,
                     const long long* __restrict__ width,
                     const long long* __restrict__ grp_off, long long R,
                     int* __restrict__ out,
                     const long long* __restrict__ out_off) {
  const long long total = grp_off[R];
  const unsigned lane = threadIdx.x & 31;
  const uintptr_t s_addr = reinterpret_cast<uintptr_t>(stream);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31u);
       base < total; base += stride) {
    // the rows of the warp's first and last group
    const long long last = min(base + 31, total - 1);
    const long long r0 = warp_row_in(grp_off, 0, R, base, lane);
    const long long r1 = warp_row_in(grp_off, r0, R, last, lane);
    const long long g = base + lane;
    const bool live = g <= last;
    const long long r = r0 == r1 || !live ? r0 : row_in(grp_off, r0,
                                                        r1 + 1, g);
    const unsigned b = static_cast<unsigned>(clamp_width(width[r]));
    const long long gl = g - grp_off[r];  // the group within its row
    unsigned wd[5] = {0, 0, 0, 0, 0}, o = 0;
    if (live && b) {
      const long long from = in_off[r] + gl * b;  // the group's first byte
      o = static_cast<unsigned>((s_addr + from) & 3);
      const long long x = from - o;
      if (x >= 0 && x + 20 <= S) {
        const unsigned* p = reinterpret_cast<const unsigned*>(stream + x);
#pragma unroll
        for (int q = 0; q < 5; ++q) wd[q] = p[q];
      } else {
#pragma unroll
        for (int q = 0; q < 5; ++q) wd[q] = word_at(stream, S, x + 4 * q);
      }
    }
    int f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    long long dst = 0;  // the group's first output element
    int nf = 0;         // and its fields
    if (live) {
      unsigned rb[4];
      be128(wd, o, rb);
      const long long lim = in_len[r] - gl * b;  // the group's bytes read
      if (lim < 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long k = lim - 4 * q;
          rb[q] = k <= 0 ? 0u
                  : k >= 4 ? rb[q]
                           : rb[q] & ~(FULL >> (8 * static_cast<int>(k)));
        }
      }
      const unsigned long long hi =
          static_cast<unsigned long long>(rb[0]) << 32 | rb[1];
      const unsigned long long lo =
          static_cast<unsigned long long>(rb[2]) << 32 | rb[3];
      const unsigned s4 = 4 * b;  // fields 4-7 from bits [4 b, 4 b + 64)
      const unsigned long long hi4 =
          s4 == 0 ? hi : s4 == 64 ? lo : hi << s4 | lo >> (64 - s4);
      const unsigned mask = (1u << b) - 1u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned sh = (64 - b * (q + 1)) & 63;
        f[q] = static_cast<int>(static_cast<unsigned>(hi >> sh) & mask);
        f[q + 4] = static_cast<int>(static_cast<unsigned>(hi4 >> sh) & mask);
      }
      nf = static_cast<int>(min(8LL, count[r] - 8 * gl));
      dst = out_off[r] + 8 * gl;
    }
    // reconverge before the stores, so a warp stores its groups together
    __syncwarp();
    if (live) {
      int* g8 = out + dst;
      if (nf == 8 && (reinterpret_cast<uintptr_t>(g8) & 15) == 0) {
        reinterpret_cast<int4*>(g8)[0] = make_int4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<int4*>(g8)[1] = make_int4(f[4], f[5], f[6], f[7]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < nf) g8[q] = f[q];
      }
    }
  }
}

}  // namespace

HTT_EXPORT int htt_bitpack_msb(const void* values, const void* val_off,
                               const void* count, const void* width,
                               const void* grp_off, long long R, void* out,
                               const void* out_off, long long blocks,
                               void* cuda_stream) {
  if (R > 0 && blocks > 0)
    bitpack_kernel<<<static_cast<unsigned>(blocks), PTHREADS, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(values),
        static_cast<const long long*>(val_off),
        static_cast<const long long*>(count),
        static_cast<const long long*>(width),
        static_cast<const long long*>(grp_off), R, static_cast<uint8_t*>(out),
        static_cast<const long long*>(out_off));
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_bitunpack_msb(const void* stream, long long S,
                                 const void* in_off, const void* in_len,
                                 const void* count, const void* width,
                                 const void* grp_off, long long R, void* out,
                                 const void* out_off, long long blocks,
                                 void* cuda_stream) {
  if (R > 0 && blocks > 0)
    bitunpack_kernel<<<static_cast<unsigned>(blocks), UTHREADS, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), S,
        static_cast<const long long*>(in_off),
        static_cast<const long long*>(in_len),
        static_cast<const long long*>(count),
        static_cast<const long long*>(width),
        static_cast<const long long*>(grp_off), R, static_cast<int*>(out),
        static_cast<const long long*>(out_off));
  return static_cast<int>(cudaGetLastError());
}
