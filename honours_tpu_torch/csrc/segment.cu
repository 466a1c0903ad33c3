// Kernel A: the stall segmenter, the first stall segment of each read.
//
// No TPU kernel stands behind it: it replaces the lax.scan of
// honours_tpu/segment/__init__.py find_stall_batch (:132), and its
// contract is the C oracle honours_tpu/native/segment.c ht_find_stall
// (:26-129) bit for bit in (exists, start, length), except that start and
// length are int32 as in the scan (the C truncates both to uint16).
// Per read of n samples (n clamped to [0, L]; n = 0 gives no segment):
// clamp each sample to [0, 1200]; mean = (serial float32 sum) / (float)n;
// sd = sqrtf((serial float32 sum of (a - mean)^2) / (float)n);
// top = mean + sd * 0.75f, bot = mean - sd * 0.75f; then the run state
// machine of segment.c:75-120 over the samples with bot < a < top in band.
//
// Rounding.  The C rounds every product and sum on its own (x86-64
// baseline, no FMA), in sample order.  nvcc contracts a * b + c into an
// FMA by default, so every operation of the two sums and of the
// thresholds is written with the _rn intrinsics, which are never
// contracted; division and square root are the IEEE ones.
//
// Bound on this card.  The bytes (2 a sample, read once) take 0.008 ms
// for a bucket of 256 x 65,536 samples at 3.35 TB/s; the work is a few
// operations a sample.  What bounds a read is its serial part: the C's
// two float32 sums are chains of n dependent adds (4 cycles each) and its
// state machine a chain of n steps.  The design below breaks both chains
// by the two invariants that follow: the serial part of a sum becomes
// about n / (GROUP x CHUNK) group steps, a few chunk steps and a few
// chunks walked add by add; the state machine becomes per-lane passes
// over 256 samples, block scans, and the few attempt ends that can emit,
// taken in order.
//
// Invariant 1 (the float32 sums compose by chunks).  Every term is >= 0
// (samples are clamped to [0, 1200]; (a - mean)^2 is rounded from a
// square), so the partial sums never decrease.  Let s be a partial sum in
// the binade [2^e, 2^(e+1)), ulp u = 2^(e-23); s is a multiple of u, and
// fl(s + t) depends on s only through (s / u) mod 2 (a tie rounds to the
// even multiple) as long as the result stays in the binade.  So a chunk
// of c terms maps every such s to s + D[e][(s / u) mod 2], with D[e][p] =
// walk(2^e + p u) - (2^e + p u), walk a serial __fadd_rn of the chunk's
// terms, provided s + T + (c + 1) u < 2^(e+1), T the chunk's exact sum:
// then no partial sum of the walk from s, nor from the binade's bottom,
// can round into the next binade (each add rounds by at most u / 2).
// Both ends of each walk lie in one binade, so D and s + D are exact.
// Where s + T <= 2^24 (sum 1 only: its terms are integers) every partial
// sum is an exact integer and the chunk adds T.
//
// Invariant 2 (the run machine is a chain of attempts).  segment.c:86
// and :92 (the window decrement) never fire: count is at most the in-band
// samples of the attempt + 5, and w = 50 + every in-band sample so far,
// so count < w.  Hence err only grows within an attempt, and an attempt
// that starts at in-band sample s (:78-80) ends at the 6th out-of-band
// sample after s, e (:94 or :115; the first five are :88-91), with count
// = e - s.  It emits (:94-111) if count >= 150, or count >= 37.5 while
// nsegs == 0; seg_end = e - run_err = (the last in-band sample before e)
// + 1.  The next attempt starts at the first in-band sample after e; an
// out-of-band sample outside an attempt changes nothing.  So the state
// that decides where attempts start and end is one of 7 (inseg == 0, or
// err = 0..5), which attempts there are does not depend on what they
// emit, and once nsegs reaches 2 (exists, start, length) can no longer
// change (:99-110): the machine stops there.
//
// Design: a block of THREADS a read; the read in tiles of TILE = THREADS x
// CHUNK samples, a chunk of CHUNK samples a thread.  Samples come straight
// from device memory, 64 a thread at a time in 16-byte loads from the
// first 16-byte boundary on; a tile's tables and in-band mask live in
// shared memory.
// Each sum, tile by tile:
//   1. every thread takes its chunk's exact sum T (an integer for sum 1,
//      a float64 sum of the float32 terms for sum 2), and a block scan
//      gives the exact sum P before the chunk;
//   2. every thread tabulates D for the binades e0 and e0 + 1, e0 that of
//      15/16 P (the float sum strays from P by at most n 2^-24 of itself,
//      3% at 2^19 samples), with the limit below which each entry holds;
//      the first lane of each GROUP chunks composes theirs into the
//      group's (a chunk's step depends on the parity alone);
//   3. warp 0 (every lane alike) composes the tile's chunks in order: a
//      group step, else a chunk step (the integer step or a table step),
//      else, where the binade was not tabulated or the limit fails (a
//      chunk that crosses a binade), the chunk walked add by add from a
//      copy of its terms in shared memory.  No result rests on the guess
//      of e0: a miss costs a walk.
// The run machine, tile by tile, over the in-band mask (a bit a sample,
// built by ballots):
//   4. every thread maps each of the 7 control states at its chunk's
//      start to the state at its end, for all 7 at once, sample by sample;
//   5. a block scan composes the maps in chunk order: each chunk's state
//      at its start, exact, and the tile's at its end;
//   6. every thread runs its chunk sample by sample from that state and
//      records the ends of count >= 38 (and that of the attempt open at
//      its start, whose start and last in-band sample come from two
//      block-wide running maxima: the latest start still open and the
//      latest in-band sample before the chunk); warp 0 takes the ends in
//      order through segment.c:94-111 until nsegs reaches 2.  The state,
//      start and last in-band sample open at the tile's end carry into
//      the next tile.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;           // a block a read
constexpr int CHUNK = 256;             // samples a chunk (a thread's)
constexpr int TILE = THREADS * CHUNK;  // samples a tile
constexpr int GROUP = 8;               // chunks a group step of the sums
constexpr int WARPS = THREADS / 32;
constexpr int WORDS = TILE / 32;       // in-band mask words a tile
constexpr double GUESS = 15.0 / 16.0;  // e0 is the binade of GUESS x P
constexpr float EXACT = 16777216.0f;   // 2^24: integers up to it are floats
constexpr float CLAMP_MAX = 1200.0f;
constexpr float CLAMP_MIN = 0.0f;
constexpr float STD_SCALE = 0.75f;
constexpr int SEG_DIST = 50;
constexpr int WINDOW = 150;
constexpr float STALL_LEN = 0.25f;
constexpr int MAX_ERR = 5;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clamp_sample(int s) {
  float v = static_cast<float>(s);
  if (v > CLAMP_MAX)
    v = CLAMP_MAX;
  else if (v < CLAMP_MIN)
    v = CLAMP_MIN;
  return v;
}

// The term of sum SUM for the clamped sample a: a (sum 1) or (a - mean)^2
// rounded as the C rounds it (sum 2).
template <int SUM>
__device__ __forceinline__ float term(float a, float mean) {
  if (SUM == 1) return a;
  const float d = __fsub_rn(a, mean);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ bool aligned16(const int16_t* p) {
  return !(reinterpret_cast<uintptr_t>(p) & 15);
}

// The 64 samples from p (16-byte aligned) as 32 words: eight 16-byte
// loads.
__device__ __forceinline__ void load64(const int16_t* p, unsigned (&w)[32]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int4 v = __ldg(q + j);
    w[4 * j] = static_cast<unsigned>(v.x);
    w[4 * j + 1] = static_cast<unsigned>(v.y);
    w[4 * j + 2] = static_cast<unsigned>(v.z);
    w[4 * j + 3] = static_cast<unsigned>(v.w);
  }
}

// f(a) for each clamped sample a of row[c0, c1), in order: from the first
// 16-byte boundary on (VEC: row + c0 is on one) 64 samples at a time, the
// next 64 loaded before the current ones are used, then 8 at a time.
template <bool VEC, typename F>
__device__ __forceinline__ void for_samples(const int16_t* row, long long c0,
                                            long long c1, F&& f) {
  long long i = c0;
  if (!VEC)
    for (; i < c1 && !aligned16(row + i); ++i) f(clamp_sample(__ldg(row + i)));
  if (i + 64 <= c1) {
    unsigned cur[32], nxt[32];
    load64(row + i, cur);
    for (; i + 64 <= c1; i += 64) {
      const bool more = i + 128 <= c1;
      if (more) load64(row + i + 64, nxt);
#pragma unroll
      for (int j = 0; j < 64; ++j)
        f(clamp_sample(static_cast<int16_t>(cur[j >> 1] >> (16 * (j & 1)))));
      if (more)
#pragma unroll
        for (int j = 0; j < 32; ++j) cur[j] = nxt[j];
    }
  }
#pragma unroll 2
  for (; i + 8 <= c1; i += 8) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + i));
    const unsigned w[4] = {static_cast<unsigned>(v.x),
                           static_cast<unsigned>(v.y),
                           static_cast<unsigned>(v.z),
                           static_cast<unsigned>(v.w)};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f(clamp_sample(static_cast<int16_t>(w[j >> 1] >> (16 * (j & 1)))));
  }
  for (; i < c1; ++i) f(clamp_sample(__ldg(row + i)));
}

// Exclusive prefix sum of v over the block (every thread's `total` the
// same float64 value, summed in the same order).
__device__ __forceinline__ double block_sum_scan(double v, double* wsum,
                                                 double& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  double before = 0.0, all = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const double s = wsum[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + (x - v);
}

// ---------------------------------------------------------------------------
// the sums (invariant 1)
// ---------------------------------------------------------------------------

// A chunk's tables, 32 bytes: two 16-byte loads for the composer.
struct __align__(16) ChunkTab {
  float d[4];    // D[e0 + k][p] at d[2k + p]
  float lim[2];  // D[e0 + k][.] holds for s < lim[k]
  float T;       // sum 1: the chunk's sum; sum 2: 0 iff every term is
  int e0;        // the lower tabulated binade (biased exponent)
};

struct SumTile {
  ChunkTab c[THREADS];
  ChunkTab grp[THREADS / GROUP];  // the same for GROUP chunks at once
};

// 2^(e - 150), the ulp of the binade of biased exponent e >= 1.
__device__ __forceinline__ float ulp_of(int e) {
  return e > 23 ? __uint_as_float(static_cast<unsigned>(e - 23) << 23)
                : __uint_as_float(1u << (e - 1));
}

// The chunk's exact sum: an integer (sum 1) or float64 (sum 2).
template <bool VEC, int SUM>
__device__ double chunk_total(const int16_t* row, long long c0, long long c1,
                              float mean) {
  if (SUM == 1) {
    int t = 0;
    for_samples<VEC>(row, c0, c1,
                     [&](float a) { t += static_cast<int>(a); });
    return t;
  }
  double t = 0.0;
  for_samples<VEC>(row, c0, c1, [&](float a) {
    t = __dadd_rn(t, static_cast<double>(term<2>(a, mean)));
  });
  return t;
}

// The tables of the chunk row[c0, c1): P the exact sum before the chunk,
// T the chunk's.  The four walks share one pass over the samples.
template <bool VEC, int SUM>
__device__ ChunkTab make_table(const int16_t* row, long long c0, long long c1,
                               double P, double T, float mean) {
  const unsigned g = __float_as_uint(__double2float_rn(P * GUESS));
  const int e0 = min(max(static_cast<int>(g >> 23), 1), 253);
  ChunkTab tb{{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f},
              static_cast<float>(T), e0};
  float b[4], acc[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float base = __uint_as_float(static_cast<unsigned>(e0 + k) << 23);
    const float u = ulp_of(e0 + k);
    b[2 * k] = base;
    b[2 * k + 1] = __fadd_rn(base, u);
    // s = 0 before the chunk (P = 0) is in no binade: no limit holds
    tb.lim[k] = P > 0.0 ? __double2float_rd(__dsub_rn(
                              __dsub_rn(2.0 * static_cast<double>(base), T),
                              __dmul_rn(CHUNK + 1.0, static_cast<double>(u))))
                        : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = b[k];
  for_samples<VEC>(row, c0, c1, [&](float a) {
    const float x = term<SUM>(a, mean);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], x);
  });
#pragma unroll
  for (int k = 0; k < 4; ++k) tb.d[k] = __fsub_rn(acc[k], b[k]);
  return tb;
}

// The tables of the group of GROUP chunks from thread t's, in t's lane:
// each entry the chunks' entries taken in turn from the binade's bottom
// (a chunk's step depends on the parity alone), valid where the group's
// own limit holds.  Tg is the group's exact sum; a group whose chunks
// tabulate other binades gets no table step.
__device__ ChunkTab group_table(const ChunkTab* c, double Tg, bool ok) {
  ChunkTab gt{{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f},
              static_cast<float>(Tg), 1};
  const int e0 = c[0].e0;
  for (int i = 1; i < GROUP; ++i) ok = ok && c[i].e0 == e0;
  if (!ok) return gt;
  gt.e0 = e0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float base = __uint_as_float(static_cast<unsigned>(e0 + k) << 23);
    const float u = ulp_of(e0 + k);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float b = __fadd_rn(base, p ? u : 0.0f);
      float x = b;
      for (int i = 0; i < GROUP; ++i)
        x = __fadd_rn(x, c[i].d[2 * k + (__float_as_uint(x) & 1)]);
      gt.d[2 * k + p] = __fsub_rn(x, b);
    }
    gt.lim[k] = __double2float_rd(__dsub_rn(
        __dsub_rn(2.0 * static_cast<double>(base), Tg),
        __dmul_rn(GROUP * CHUNK + 1.0, static_cast<double>(u))));
  }
  return gt;
}

// One step of s over a chunk or a group from its tables (d: D; x: lim[0],
// lim[1], T, e0), or false where none can be taken.
template <int SUM>
__device__ __forceinline__ bool table_step(float& s, float4 d, float4 x) {
  const float T = x.z;
  if (SUM == 1 && s <= EXACT - T) {
    s = __fadd_rn(s, T);  // every partial sum an integer <= 2^24: exact
    return true;
  }
  if (SUM == 2 && T == 0.0f) return true;  // every term 0: fl(s + 0) = s
  const unsigned bits = __float_as_uint(s);
  const int k = static_cast<int>(bits >> 23) - __float_as_int(x.w);
  const float lim = k == 0 ? x.x : x.y;
  const float off = k == 0 ? (bits & 1 ? d.y : d.x) : (bits & 1 ? d.w : d.z);
  if (bits >= 0x00800000u && (k == 0 || k == 1) && s < lim) {
    s = __fadd_rn(s, off);  // exact (invariant 1)
    return true;
  }
  return false;
}

// Warp 0, every lane alike: the serial float32 sum s carried through the
// tile's chunks 0..nch-1 (the tile starts at sample T0): a group step
// where its tables hold, else a chunk step, else the chunk walked.
template <int SUM>
__device__ float compose(float s, int nch, const SumTile& st,
                         const int16_t* row, long long T0, long long n,
                         float mean, float* scratch) {
  const int lane = threadIdx.x & 31;
  const float4* tab = reinterpret_cast<const float4*>(st.c);
  const float4* grp = reinterpret_cast<const float4*>(st.grp);
  for (int j = 0; j < nch;) {
    if (j % GROUP == 0 && j + GROUP <= nch &&
        table_step<SUM>(s, grp[2 * (j / GROUP)], grp[2 * (j / GROUP) + 1])) {
      j += GROUP;
      continue;
    }
    if (!table_step<SUM>(s, tab[2 * j], tab[2 * j + 1])) {
      // walked: the chunk's terms staged by the warp, added one by one
      const long long c0 = T0 + static_cast<long long>(j) * CHUNK;
      const int cnt = static_cast<int>(min(static_cast<long long>(CHUNK),
                                           n - c0));
      __syncwarp();
      for (int i = lane; i < CHUNK; i += 32)
        scratch[i] = i < cnt ? term<SUM>(clamp_sample(__ldg(row + c0 + i)),
                                         mean)
                             : 0.0f;  // fl(s + 0) = s
      __syncwarp();
      const float4* x4 = reinterpret_cast<const float4*>(scratch);
#pragma unroll 4
      for (int i = 0; i < CHUNK / 4; ++i) {
        const float4 v = x4[i];
        s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
      }
    }
    ++j;
  }
  return s;
}

// ---------------------------------------------------------------------------
// the run machine (invariant 2)
// ---------------------------------------------------------------------------

// An attempt's end: its first sample s (segment.c:79 seg_start), the
// out-of-band sample e that ends it and its last in-band sample li
// (seg_end = li + 1).
struct End {
  int s, e, li;
};

// Ends of count >= 38 a chunk can hold: the attempt open at its start,
// and at most CHUNK / 38 that start in it.
constexpr int MAX_ENDS = 1 + CHUNK / 38;

struct RunTile {
  unsigned mask[WORDS];  // bit i of word w: sample T0 + 32 w + i in band
  End ends[THREADS][MAX_ENDS];      // each chunk's ends that can emit
  unsigned char n_ends[THREADS];
};

struct Segs {
  int n = 0, fx = 0, fy = 0, ly = 0;  // nsegs, first_x, first_y, last_y

  // segment.c:94-111 at an attempt's end (:115 when it does not emit)
  __device__ __forceinline__ void end(const End& a) {
    const int count = a.e - a.s;
    if (n < 2 && (count >= WINDOW ||
                  (!n && static_cast<float>(count) >= WINDOW * STALL_LEN))) {
      const int seg_end = a.li + 1;  // :97, e - run_err
      if (n && a.s - ly < SEG_DIST) {
        ly = seg_end;  // :99-103, merge into the last segment
        if (n == 1) fy = seg_end;
      } else {
        ++n;  // :105-110
        ly = seg_end;
        if (n == 1) {
          fx = a.s;
          fy = seg_end;
        }
      }
    }
  }
};

// The run machine's control state before a sample: FREE (segment.c
// inseg == 0) or 1 + err inside an attempt (err 0..MAX_ERR).  A map of the
// 7 states holds each image in 3 bits.
constexpr int FREE = 0;
constexpr unsigned IDENTITY = 0 | 1 << 3 | 2 << 6 | 3 << 9 | 4 << 12 |
                              5 << 15 | 6 << 18;

__device__ __forceinline__ int apply(unsigned f, int st) {
  return static_cast<int>(f >> (3 * st) & 7);
}

// The map `f` then `g`.
__device__ __forceinline__ unsigned after(unsigned g, unsigned f) {
  unsigned h = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i)
    h |= static_cast<unsigned>(apply(g, apply(f, i))) << (3 * i);
  return h;
}

// Exclusive composition of the threads' maps in thread order (thread 0's
// first), and the block's whole map.
__device__ __forceinline__ unsigned block_map_scan(unsigned f, unsigned* wmap,
                                                   unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = after(x, y);
  }
  unsigned mine = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) mine = IDENTITY;
  if (lane == 31) wmap[warp] = x;
  __syncthreads();
  unsigned before = IDENTITY, all = IDENTITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned m = wmap[w];
    if (w < warp) before = after(m, before);
    all = after(m, all);
  }
  __syncthreads();
  total = all;
  return after(mine, before);
}

// Exclusive maxima over the block of a and b, each from `init`, and the
// block's maxima (from init too).
__device__ __forceinline__ int2 block_max2_scan(int2 v, int2 init,
                                                int2* wmax, int2& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y0 = __shfl_up_sync(FULL, x.x, d);
    const int y1 = __shfl_up_sync(FULL, x.y, d);
    if (lane >= d) x = make_int2(max(x.x, y0), max(x.y, y1));
  }
  int2 before = make_int2(__shfl_up_sync(FULL, x.x, 1),
                          __shfl_up_sync(FULL, x.y, 1));
  if (lane == 0) before = init;
  before = make_int2(max(before.x, init.x), max(before.y, init.y));
  if (lane == 31) wmax[warp] = x;
  __syncthreads();
  int2 all = init;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int2 m = wmax[w];
    if (w < warp) before = make_int2(max(before.x, m.x), max(before.y, m.y));
    all = make_int2(max(all.x, m.x), max(all.y, m.y));
  }
  __syncthreads();
  total = all;
  return before;
}

// The map of the 7 control states at c0 to those at c1 across the chunk
// [c0, c1), sample by sample for all 7 at once, the same instructions in
// every lane: byte q of m holds (a bit each) the states at c0 now in
// state q.  An in-band sample takes FREE into err 0 (segment.c:78-80) and
// leaves an attempt as it is; an out-of-band one leaves FREE, adds an
// excursion (:88-91) or, after MAX_ERR, ends the attempt (:94-119).
__device__ unsigned chunk_map(const unsigned* mask, int T0, int c0, int c1) {
  unsigned long long m = 0x40201008040201ull;
  for (int p = c0; p < c1; p += 32) {
    unsigned w = mask[(p - T0) >> 5];
    const int cnt = min(32, c1 - p);
#pragma unroll 8
    for (int i = 0; i < cnt; ++i, w >>= 1) {
      const unsigned long long in = (m & ~0xffull) | (m & 0xff) << 8;
      const unsigned long long out =
          (m & 0xff) | (m >> 48 & 0xff) | (m & 0xffffffffff00ull) << 8;
      m = w & 1 ? in : out;
    }
  }
  unsigned f = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const unsigned long long at = m >> i & 0x01010101010101ull;
    f |= static_cast<unsigned>((__ffsll(static_cast<long long>(at)) - 1) >> 3)
         << (3 * i);
  }
  return f;
}

// Step 6 over the chunk [c0, c1) from its control state st at c0, sample
// by sample, the same instructions in every lane: the ends of count >= 38
// (and the first end, of the attempt open at c0, whose start is not known
// here: s = -1), into `ends`; returns their number.  `open` gets the start
// of the attempt open at c1 if it began in the chunk (else -1), `last` the
// chunk's last in-band sample (else -1).
__device__ int chunk_ends(const unsigned* mask, int T0, int c0, int c1,
                          int st, End* ends, int& open, int& last) {
  bool inseg = st != FREE;
  int k = st - 1, s = -1, li = -1, n = 0;
  for (int p = c0; p < c1; p += 32) {
    unsigned w = mask[(p - T0) >> 5];
    const int cnt = min(32, c1 - p);
#pragma unroll 8
    for (int i = 0; i < cnt; ++i, w >>= 1) {
      const int q = p + i;
      const bool in = w & 1;
      const bool starts = in && !inseg;         // :78-80, an attempt starts
      const bool off = !in && inseg;            // :88-91, an excursion,
      const bool ends_here = off && k == MAX_ERR;  // or :94-119 its end
      s = starts ? q : s;
      k = starts ? 0 : k + off;
      li = in ? q : li;
      if (ends_here) {
        if (s < 0 || static_cast<float>(q - s) >= WINDOW * STALL_LEN)
          ends[n++] = End{s, q, li};
        s = -1;
      }
      inseg = (inseg || in) && !ends_here;
    }
  }
  open = inseg ? s : -1;
  last = li;
  return n;
}

// The tile's in-band mask, words 0..ceil((E - T0) / 32) - 1: a warp makes
// 8 words from 256 samples, 8 a lane, 4 such groups at a time.
template <bool VEC>
__device__ void build_mask(const int16_t* row, long long T0, long long E,
                           float top, float bot, unsigned* mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = static_cast<int>((E - T0 + 255) / 256);
  for (int g0 = warp; g0 < groups; g0 += 4 * WARPS) {
    unsigned v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i0 = T0 + 256LL * (g0 + r * WARPS) + 8 * lane;
      if (i0 + 8 <= E && (VEC || aligned16(row + i0))) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(row + i0));
        v[r][0] = x.x;
        v[r][1] = x.y;
        v[r][2] = x.z;
        v[r][3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned lo = i0 + 2 * j < E ? static_cast<uint16_t>(
                                                   __ldg(row + i0 + 2 * j))
                                             : 0u;
          const unsigned hi = i0 + 2 * j + 1 < E
                                  ? static_cast<uint16_t>(
                                        __ldg(row + i0 + 2 * j + 1))
                                  : 0u;
          v[r][j] = lo | hi << 16;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = g0 + r * WARPS;
      const long long i0 = T0 + 256LL * g + 8 * lane;
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = clamp_sample(
            static_cast<int16_t>(v[r][j >> 1] >> (16 * (j & 1))));
        bits |= static_cast<unsigned>(i0 + j < E && a < top && a > bot) << j;
      }
      unsigned x = bits << (8 * (lane & 3));
      x |= __shfl_xor_sync(FULL, x, 1);
      x |= __shfl_xor_sync(FULL, x, 2);
      if ((lane & 3) == 0 && g < groups) mask[8 * g + (lane >> 2)] = x;
    }
  }
}

struct Shared {
  union {
    SumTile sum;
    RunTile run;
  } u;
  __align__(16) float scratch[CHUNK];  // a walked chunk's terms
  double wsum[WARPS];
  unsigned wmap[WARPS];
  int2 wmax[WARPS];
  int state;  // the control state at the tile's start
  int2 carry;  // then the start and last in-band sample of the open attempt
  float bcast;
  int stop;
};

// The serial float32 sum of the terms of row[0, n), in warp 0.
template <bool VEC, int SUM>
__device__ float row_sum(const int16_t* row, long long n, float mean,
                         Shared& sh) {
  const int t = threadIdx.x;
  double carry = 0.0;
  float s = 0.0f;
  for (long long T0 = 0; T0 < n; T0 += TILE) {
    const long long c0 = T0 + static_cast<long long>(t) * CHUNK;
    const long long c1 = min(c0 + CHUNK, n);
    const double T = c0 < c1 ? chunk_total<VEC, SUM>(row, c0, c1, mean) : 0.0;
    double total;
    const double P = carry + block_sum_scan(T, sh.wsum, total);
    carry += total;
    if (c0 < c1) sh.u.sum.c[t] = make_table<VEC, SUM>(row, c0, c1, P, T, mean);
    double Tg = T;  // the group's sum, in its first lane
#pragma unroll
    for (int d = 1; d < GROUP; d <<= 1) Tg += __shfl_xor_sync(FULL, Tg, d);
    const int nch = static_cast<int>(
        (min(n - T0, static_cast<long long>(TILE)) + CHUNK - 1) / CHUNK);
    __syncthreads();
    if (t % GROUP == 0 && t + GROUP <= nch)
      sh.u.sum.grp[t / GROUP] = group_table(sh.u.sum.c + t, Tg, P > 0.0);
    __syncthreads();
    if (t < 32) s = compose<SUM>(s, nch, sh.u.sum, row, T0, n, mean, sh.scratch);
    __syncthreads();
  }
  return s;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    find_stall_kernel(const int16_t* __restrict__ sig,
                      const int* __restrict__ n_rows, long long L,
                      uint8_t* __restrict__ exists,
                      int* __restrict__ start, int* __restrict__ length) {
  __shared__ __align__(16) Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long b = blockIdx.x;
  long long nn = n_rows[b];
  nn = nn < 0 ? 0 : (nn > L ? L : nn);
  const int n = static_cast<int>(nn);  // rows < 2^31 samples
  const int16_t* row = sig + b * L;
  Segs g;
  if (n > 0) {
    const float nf = static_cast<float>(nn);
    const float s1 = row_sum<VEC, 1>(row, n, 0.0f, sh);
    if (t == 0) sh.bcast = s1;
    __syncthreads();
    const float mean = __fdiv_rn(sh.bcast, nf);
    const float s2 = row_sum<VEC, 2>(row, n, mean, sh);
    if (t == 0) {
      sh.bcast = s2;
      sh.state = FREE;
      sh.carry = make_int2(-1, -1);
    }
    __syncthreads();
    const float sd = __fsqrt_rn(__fdiv_rn(sh.bcast, nf));
    const float top = __fadd_rn(mean, __fmul_rn(sd, STD_SCALE));
    const float bot = __fsub_rn(mean, __fmul_rn(sd, STD_SCALE));

    RunTile& rt = sh.u.run;
    for (int T0 = 0; T0 < n; T0 += TILE) {
      const int E = min(T0 + TILE, n);
      const int live = (E - T0 + CHUNK - 1) / CHUNK;
      build_mask<VEC>(row, T0, E, top, bot, rt.mask);
      __syncthreads();
      const int c0 = T0 + t * CHUNK;
      const int c1 = min(c0 + CHUNK, E);
      // step 4: each chunk's map of the control states
      const unsigned f = t < live ? chunk_map(rt.mask, T0, c0, c1) : IDENTITY;
      // step 5: the state at each chunk's start, and at the tile's end
      unsigned total;
      const unsigned before = block_map_scan(f, sh.wmap, total);
      const int st0 = sh.state;
      const int2 carry = sh.carry;
      const int st = apply(before, st0);
      // step 6: each chunk's ends, then the start and last in-band sample
      // of the attempt open at its start (the latest start still open, the
      // latest in-band sample, before it)
      int open = -1, last = -1;
      int ne = t < live ? chunk_ends(rt.mask, T0, c0, c1, st, rt.ends[t],
                                     open, last)
                        : 0;
      int2 tot;
      const int2 in = block_max2_scan(make_int2(open, last), carry, sh.wmax,
                                      tot);
      if (ne > 0 && rt.ends[t][0].s < 0) {
        rt.ends[t][0].s = in.x;
        if (rt.ends[t][0].li < 0) rt.ends[t][0].li = in.y;
      }
      rt.n_ends[t] = static_cast<unsigned char>(ne);
      __syncthreads();
      if (warp == 0) {  // the ends in order, until nsegs reaches 2
        for (int base = 0; base < live && g.n < 2; base += 32) {
          const int j0 = base + lane;
          unsigned ball = __ballot_sync(FULL, j0 < live && rt.n_ends[j0]);
          while (ball && g.n < 2) {
            const int j = base + __ffs(ball) - 1;
            ball &= ball - 1;
            for (int i = 0; i < rt.n_ends[j] && g.n < 2; ++i)
              g.end(rt.ends[j][i]);
          }
        }
      }
      if (t == 0) {
        sh.state = apply(total, st0);
        sh.carry = tot;
        sh.stop = g.n >= 2;
      }
      __syncthreads();
      if (sh.stop) break;
    }
  }
  if (t == 0) {
    exists[b] = g.n > 0;
    start[b] = g.n > 0 ? g.fx : 0;
    length[b] = g.n > 0 ? g.fy - g.fx + 1 : 0;
  }
}

}  // namespace

HTT_EXPORT int htt_find_stall(const void* sig, const void* n, long long B,
                              long long L, long long vec, void* exists,
                              void* start, void* length, void* stream) {
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>(B);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* s = static_cast<const int16_t*>(sig);
    const auto* nr = static_cast<const int*>(n);
    auto* ex = static_cast<uint8_t*>(exists);
    auto* so = static_cast<int*>(start);
    auto* lo = static_cast<int*>(length);
    if (vec)
      find_stall_kernel<true><<<grid, THREADS, 0, st>>>(s, nr, L, ex, so, lo);
    else
      find_stall_kernel<false><<<grid, THREADS, 0, st>>>(s, nr, L, ex, so, lo);
  }
  return static_cast<int>(cudaGetLastError());
}
