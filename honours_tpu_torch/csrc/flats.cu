// Kernel K: flat_uint_submin's optimal step-aligned partition, one read a
// block.
//
// No TPU kernel stands behind it: honours_tpu partitions on the host only
// (honours_tpu/codecs/flats.py:57 partition_flats, a Python double loop),
// and this is its counterpart on the card, cut for cut.  Over the
// candidate boundaries 0, step, 2 step, ..., and n (m = ceil(n / step)
// chunks, the last one short):
//   best[0] = 0,
//   best[j] = min over i < j of best[i] + 3
//             + ((b_j - b_i) minbits(max - min of u[b_i:b_j]) + 7) / 8,
// the smallest i winning a tie (the host's strict < with i ascending);
// then the prev chain from m back to 0 gives the cuts.  u is the samples
// as uint16.
//
// Bound on this card: the chain.  Step j needs best[j - 1], so the m
// steps run in order; a step does j independent (i, j) evaluations and a
// block-wide argmin.  O(m^2 / 2) evaluations a read: about 0.5 M at the
// bucket's m = 1,024 (step 64), 2.1 G at 4,194,000 samples (m = 65,532).
//
// Design: a block of T threads a read.  A pre-pass stores each chunk's (min,
// max), read as the aligned 16-byte words of the row that hold it, all at once
// for a chunk of up to 9 words (a row need not be 16-byte aligned: a word's
// samples outside the chunk are masked), and zeroes the read's cut row.  Index i belongs to thread i % T, slot i / T,
// which keeps the range (min, max) of chunks i..j-1 and best[i] + 3; no other
// thread reads them.  The slots are registers (K of them, unrolled, a warp
// skipping the groups of 4 slots none of its lanes holds yet) where m <= T K,
// else words in shared memory, or in the wrapper's scratch where a read's
// state passes SMEM_MAX (K = 0).  The steps go in rounds of D: round j .. j +
// D - 1 first evaluates every index below j from the slots for each of its D
// steps (each thread a running (cost, i) a step with a strict < over its
// ascending i; a warp's argmin two __reduce_min_sync, the least cost, then the
// least i among the lanes holding it; a block of several warps one barrier and
// the same pair over the warps' pairs), then runs its steps in order on every
// thread alike, each also over the round's own indices before it (the tail:
// their segments' bytes need no best, so they are computed before the argmins
// and the tail's chain is an add and a compare a candidate); the round's
// indices then enter their owners' slots.  So a round of D steps pays one
// barrier and one pair of reduction latencies.  Arithmetic is 32-bit: a cost
// is at most 2 n + 6 bytes and the wrapper keeps 2 L + 3 (m + 1) < 2^32; a
// segment's bytes, (len (f + 1) + 7) / 8 with f the top bit of its range's
// width, take one 64-bit multiply-add.  Thread 0 stores prev in shared memory
// (or scratch); at the end the block computes the jumps prev^2 and prev^4
// side by side and thread 0 walks the chain from m four cuts a load, writing
// the 1s of cut.  The entry picks the design from m (htt_flats_partition):
// at the bucket's m <= 1,024, 128 threads of 8 register slots and rounds of
// 4 steps, the fastest of 32, 64, 128 and 256 threads and of 2-8 steps a
// round; up to m = 8,192 the memory design at 256 threads, and above it at
// 1,024 (PERF.md: at m = 4,096 and 8,192, 256 threads beat 128, 512 and
// 1,024, at m = 2,048 128 were 1% faster; at m = 2,048 and 4,096 register
// designs of 256 x 16, 512 x 8 and 1,024 x 4 slots were slower; in scratch at
// m = 32,768, 1,024 threads beat 512, 256 and 128).  Ablations
// (PERF.md): a step a round, one warp a read, and (cost, i) packed into one
// 32-bit key where it fits (one reduction) were slower; the tail's segments
// computed on its chain cost 0.019 ms at the bucket.
//
// Output ownership: each block writes only its own row of cut (every byte
// of it: 0, then a 1 at each chosen boundary index 0..m) and its own row
// of scratch.

#include "common.cuh"

namespace {

// the dynamic shared memory a block may take (4 B an index of the chunks
// and prev, and of the walk's jumps in a register design, or of the
// ranges and best[i] + 3 in the memory design); the wrapper keeps a
// read's state there up to this size
constexpr int SMEM_MAX = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no candidate: above every cost

// folds into (mn, mx) the samples h = 0..7 of a 16-byte word for which
// p0 + h lies in [0, cnt)
__device__ __forceinline__ void word_minmax(const uint4 v, int p0,
                                            unsigned cnt, unsigned& mn,
                                            unsigned& mx) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const unsigned x = (w[h >> 1] >> (16 * (h & 1))) & 0xFFFFu;
    if (static_cast<unsigned>(p0 + h) < cnt) {
      mn = min(mn, x);
      mx = max(mx, x);
    }
  }
}

// up to this many words of a chunk are loaded all at once (a chunk of
// step 64: 8 or 9 words), so their latencies overlap
constexpr int CHUNK_WORDS = 9;

// (min | max << 16) of the samples [lo, hi) (lo < hi) of a row, read as
// the aligned 16-byte words that hold them
__device__ __forceinline__ unsigned chunk_minmax(const uint16_t* row,
                                                 unsigned lo, unsigned hi) {
  const intptr_t first = reinterpret_cast<intptr_t>(row + lo);
  const intptr_t end = reinterpret_cast<intptr_t>(row + hi);
  const intptr_t a0 = first & ~static_cast<intptr_t>(15);
  const unsigned cnt = hi - lo;
  const int p0 = static_cast<int>((a0 - first) >> 1);  // -7 .. 0
  const int nw = static_cast<int>((end - a0 + 15) >> 4);
  unsigned mn = 0xFFFFu, mx = 0;
  if (nw <= CHUNK_WORDS) {
    uint4 v[CHUNK_WORDS];
#pragma unroll
    for (int q = 0; q < CHUNK_WORDS; ++q)
      if (q < nw) v[q] = reinterpret_cast<const uint4*>(a0)[q];
#pragma unroll
    for (int q = 0; q < CHUNK_WORDS; ++q)
      if (q < nw) word_minmax(v[q], p0 + 8 * q, cnt, mn, mx);
  } else {
#pragma unroll 3
    for (int q = 0; q < nw; ++q)
      word_minmax(reinterpret_cast<const uint4*>(a0)[q], p0 + 8 * q, cnt, mn,
                  mx);
  }
  return mn | mx << 16;
}

// a == b, opaque to the compiler: a loop of such tests over a register
// array then stays a select a slot, and not an indexed store that would
// move the array to local memory
__device__ __forceinline__ bool same(unsigned a, unsigned b) {
  unsigned r;
  asm("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b));
  return r != 0;
}

// the top bit of a range's width, -1 for 0: minbits is top_bit + 1
__device__ __forceinline__ int top_bit(unsigned d) { return 31 - __clz(d); }

// the bytes of a segment of len (< 2^31) samples whose range's top bit is
// f: (len (f + 1) + 7) / 8, as one 64-bit multiply-add
__device__ __forceinline__ unsigned seg_bytes(unsigned len, int f) {
  return static_cast<unsigned>(
      (static_cast<long long>(static_cast<int>(len)) * f +
       static_cast<long long>(len) + 7) >> 3);
}

template <int T, int K, int D>
__global__ void __launch_bounds__(T)
    flats_partition_kernel(const int16_t* __restrict__ sig, unsigned L,
                           const int* __restrict__ n_arr, unsigned step,
                           unsigned mmax, unsigned* __restrict__ scratch,
                           uint8_t* __restrict__ cut, int in_smem) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ uint2 red[2][T / 32][D];
  const unsigned b = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nb = n_arr[b];
  const unsigned n = nb < 0 ? 0u : min(static_cast<unsigned>(nb), L);
  const unsigned m = n ? (n - 1) / step + 1 : 0;
  const uint16_t* row =
      reinterpret_cast<const uint16_t*>(sig) + static_cast<size_t>(b) * L;
  // a register design's state is always in shared memory (the compiler
  // then loads it as such)
  unsigned* cm = K > 0 || in_smem
                     ? smem
                     : scratch + static_cast<size_t>(b) * (4 * mmax + 2);
  unsigned* prev = cm + mmax + 1;    // [mmax + 1]; cm [mmax + 1]
  unsigned* rng = prev + mmax + 1;   // K == 0: [mmax] (min | max << 16)
  unsigned* best3 = rng + mmax;      // K == 0: [mmax] best[i] + 3
  // after the DP, the walk's jumps: prev^2 in cm's words, prev^4 in the
  // ranges' (a register design: [mmax + 1] past prev)
  unsigned* j2 = cm;
  unsigned* j4 = rng;
  uint8_t* crow = cut + static_cast<size_t>(b) * (mmax + 1);

  for (unsigned c = t; c < m; c += T) {
    const unsigned lo = c * step, hi = n - lo > step ? lo + step : n;
    cm[c] = chunk_minmax(row, lo, hi);
    if constexpr (K == 0) rng[c] = 0xFFFFu;
  }
  for (unsigned k = t; k <= mmax; k += T) crow[k] = 0;
  if (t == 0) prev[0] = 0;  // the walk's jumps stop at index 0
  if constexpr (K == 0) {
    if (t == 0 && m) best3[0] = 3;  // index 0 enters: best[0] = 0
  }
  __syncthreads();

  unsigned mn[K ? K : 1], mx[K ? K : 1], bb[K ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mn[k] = 0xFFFFu;
    mx[k] = 0;
    bb[k] = k == 0 && t == 0 ? 3u : 0u;
  }
  int par = 0;
  // rounds of D steps j .. j + nd - 1: first every index below j from
  // the slots, for each step of the round (D block-wide argmins, one
  // barrier), then the round's steps in order on every thread alike,
  // each also over the round's indices before it (the tail)
  for (unsigned j = 1; j <= m; j += D) {
    const unsigned nd = min(static_cast<unsigned>(D), m + 1 - j);
    unsigned cn[D], cx[D], bj[D], cost[D], arg[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const unsigned c = d < nd ? cm[j - 1 + d] : 0xFFFFu;  // past m: none
      cn[d] = c & 0xFFFFu;
      cx[d] = c >> 16;
      bj[d] = j + d < m ? (j + d) * step : n;
      cost[d] = NONE;
      arg[d] = NONE;
    }
    // the round's own indices: j + e at step j + d (e < d) spans chunks
    // j + e .. j + d - 1, whose bytes need no best, so they are off the
    // tail's chain; (tmn, tmx)[e] end as the range of chunks j + e ..
    // j + nd - 2, which index j + e takes into its slot
    unsigned tseg[D][D], tmn[D], tmx[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      tmn[e] = 0xFFFFu;
      tmx[e] = 0;
#pragma unroll
      for (int d = e + 1; d < D; ++d) {
        tmn[e] = min(tmn[e], cn[d]);
        tmx[e] = max(tmx[e], cx[d]);
        tseg[e][d] = seg_bytes(bj[d] - (j + e) * step,
                               top_bit(tmx[e] - tmn[e]));
      }
    }
    if constexpr (K > 0) {
      // slots in groups of G, a warp skipping the groups none of its
      // lanes has entered (a branch, not a break, so the loop unrolls and
      // the slots stay in registers)
      constexpr int G = K < 4 ? K : 4;
      const int dj = static_cast<int>(j - 1 - t);  // slot k: index t + k T
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += G) {
        if (static_cast<unsigned>(k0 * T) + 32 * w >= j) continue;
#pragma unroll
        for (int k = k0; k < k0 + G; ++k) {
          const bool on = k * T <= dj;  // index below j
          const unsigned at = (t + k * T) * step;
          unsigned lo = mn[k], hi = mx[k];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            lo = min(lo, cn[d]);
            hi = max(hi, cx[d]);
            const unsigned e = bb[k] + seg_bytes(bj[d] - at,
                                                 top_bit(hi - lo));
            if (on && e < cost[d]) {
              cost[d] = e;
              arg[d] = t + k * T;
            }
          }
          if (on) {
            mn[k] = lo;
            mx[k] = hi;
          }
        }
      }
    } else {
      for (unsigned i = t; i < j; i += T) {
        const unsigned s = rng[i], b3 = best3[i], at = i * step;
        unsigned lo = s & 0xFFFFu, hi = s >> 16;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          lo = min(lo, cn[d]);
          hi = max(hi, cx[d]);
          const unsigned e = b3 + seg_bytes(bj[d] - at, top_bit(hi - lo));
          if (e < cost[d]) {
            cost[d] = e;
            arg[d] = i;
          }
        }
        rng[i] = lo | hi << 16;
      }
    }
    // the argmins: the least cost, then the least i among the lanes
    // holding it
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const unsigned c = __reduce_min_sync(FULL, cost[d]);
      arg[d] = __reduce_min_sync(FULL, cost[d] == c ? arg[d] : NONE);
      cost[d] = c;
    }
    if constexpr (T > 32) {
      if (lane == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) red[par][w][d] = make_uint2(cost[d], arg[d]);
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const uint2 v =
            lane < T / 32 ? red[par][lane][d] : make_uint2(NONE, NONE);
        const unsigned c = __reduce_min_sync(FULL, v.x);
        arg[d] = __reduce_min_sync(FULL, v.x == c ? v.y : NONE);
        cost[d] = c;
      }
      par ^= 1;
    }
    // the tail: the round's steps in order, each also over the round's
    // indices before it; they come after every index below j, so a
    // strict < keeps the least index on a tie
    unsigned tb3[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d < nd) {
        unsigned bc = cost[d], bi = arg[d];
#pragma unroll
        for (int e = 0; e < d; ++e) {
          const unsigned ce = tb3[e] + tseg[e][d];
          if (ce < bc) {
            bc = ce;
            bi = j + e;
          }
        }
        tb3[d] = bc + 3;
        if (t == 0) prev[j + d] = bi;
      }
    }
    // the round's indices enter their owners' slots: index j + q belongs
    // to thread (j + q) % T, with the range of chunks j + q .. j + nd - 2
    const unsigned q = (t - j) & (T - 1);
    if (q < nd) {
      unsigned vb = 0, vn = 0, vx = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d == static_cast<int>(q)) {
          vb = tb3[d];
          vn = tmn[d];
          vx = tmx[d];
        }
      }
      const unsigned i = j + q;
      if constexpr (K > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (same(k, i / T)) {
            bb[k] = vb;
            mn[k] = vn;
            mx[k] = vx;
          }
        }
      } else {
        best3[i] = vb;
        rng[i] = vn | vx << 16;
      }
    }
  }
  // the prev chain from m: jumps of 2 and 4 computed side by side first,
  // so thread 0's chain is one load every 4 cuts
  __syncthreads();  // prev, in shared memory or scratch, is complete
  if (m != 0) {
    for (unsigned k = t; k <= m; k += T) j2[k] = prev[prev[k]];
    __syncthreads();
    for (unsigned k = t; k <= m; k += T) j4[k] = j2[j2[k]];
    __syncthreads();
  }
  if (t == 0) {
    unsigned k = m;
    crow[k] = 1;
    while (k != 0) {
      const unsigned k2 = j2[k];
      crow[prev[k]] = 1;
      crow[k2] = 1;
      crow[prev[k2]] = 1;
      k = j4[k];
      crow[k] = 1;
    }
  }
}

template <int T, int K, int D>
int launch(const void* sig, long long B, long long L, const void* n,
           long long step, long long mmax, void* scratch, void* cut,
           void* cuda_stream) {
  // a register design's state (the chunks, prev and the walk's jumps)
  // always fits; the memory design's (also the ranges and best + 3) goes
  // to scratch past SMEM_MAX
  const long long want = K > 0 ? 12 * (mmax + 1) : 8 * (2 * mmax + 1);
  const long long smem_bytes = want <= SMEM_MAX ? want : 0;
  if (smem_bytes == 0 && (K > 0 || scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[64];
  htt_smem_limit_once(flats_partition_kernel<T, K, D>, SMEM_MAX, smem_set);
  flats_partition_kernel<T, K, D><<<static_cast<unsigned>(B), T,
                                    static_cast<size_t>(smem_bytes),
                                    static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int16_t*>(sig), static_cast<unsigned>(L),
      static_cast<const int*>(n), static_cast<unsigned>(step),
      static_cast<unsigned>(mmax), static_cast<unsigned*>(scratch),
      static_cast<uint8_t*>(cut), smem_bytes > 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The design (threads, register slots a thread, steps a round) is picked
// here from mmax, the rows' chunks, and nowhere else; slots 0 keeps the
// state in shared memory or, past SMEM_MAX, in scratch [B, 4 mmax + 2]
// u32, which the caller allocates where 8 (2 mmax + 1) > SMEM_MAX (else
// it may pass null)
HTT_EXPORT int htt_flats_partition(const void* sig, long long B, long long L,
                                   const void* n, long long step,
                                   long long mmax, void* scratch, void* cut,
                                   void* cuda_stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
#define HTT_FLATS_ARGS sig, B, L, n, step, mmax, scratch, cut, cuda_stream
  if (mmax <= 1024) return launch<128, 8, 4>(HTT_FLATS_ARGS);
  if (mmax <= 8192) return launch<256, 0, 4>(HTT_FLATS_ARGS);
  return launch<1024, 0, 4>(HTT_FLATS_ARGS);
#undef HTT_FLATS_ARGS
}
