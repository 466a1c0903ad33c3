// Kernel 1: monotone row permutations (compact, compaction shifts, expand).
//
// Replaces honours_tpu/engine/permute_pallas.py `_walk` (pallas_call at
// :138; entries compact_walk :191, expand_walk :170,
// compaction_shifts_walk :214).  The TPU has no fast scatter, so the
// Pallas kernel moves every element by log2(N) masked rolls inside VMEM.
// Hopper scatters natively: a compaction is an exclusive scan of `keep`
// plus a move, an expansion is a move plus the zeros between targets.
//
// Bound on this card: bytes.  Each element is read once and each output
// written once (a u8 or i32 payload plus a one-byte mask), a few integer
// operations per element, far below the operation roofline.
//
// Design.  Every row of [B, N] is cut into tiles of TILE = TPB x EPT
// elements and the grid is B x tiles blocks, one tile each, so a single
// wide row fills the card as well as many short ones.  In rows of more
// than one tile a block takes its tile from an atomic ticket in launch
// order (not from blockIdx), so every tile it may wait on already holds
// an SM: the waits below always end.  Each thread owns EPT consecutive
// elements, read as 16-byte vectors of mask and payload where aligned
// (scalar loads at a misaligned row start or the ragged end).
//
// Compaction: the thread counts its kept elements with a popcount of its
// EPT-bit mask; one block scan (warp shuffles, then one warp over the
// per-warp sums, two barriers) gives tile-local ranks.  The rank of the
// tile's first element across the row comes from a single-pass decoupled
// look-back (Merrill & Garland): the tile publishes its count at once and
// its inclusive prefix when known, as one 64-bit word (flag << 32 | value)
// in a zeroed scratch [B, tiles] from the wrapper; warp 0 reads 32
// predecessors at a time and stops at the nearest inclusive prefix. The
// kept elements are then staged in shared memory at their rank, and the
// tile's run out[P, P + c) is written with 16-byte stores (scalar at its
// two unaligned ends).  The zero tail [count, N) is written once, by the
// row's last tile, which alone knows count; every kept element of the row
// lands below count, so the tail never meets a kept run.
//
// Expansion: targets j + shift[j] of the valid elements rise strictly
// along the row.  A row has one tile per TILE input elements, and more when
// a batch of few rows spreads them over a wide output (`per` input
// elements each, from the wrapper), so that the writes still spread over
// the SMs; rows of at most TILE / 2 elements go 2, 4 or 8 to a block
// (whole warps each, one scan over the block), so that short rows leave no
// thread idle.  Each tile stages its in-range (target, value) pairs in
// shared memory in order (a word of padding after every 16 pairs, so that
// a warp's stride-16 stores meet 32 banks, not 2) and learns R, the first
// target of any later tile (W if none), by the same look-back run right to
// left (tickets hand out a row's tiles from its last one).  The tile then
// owns output columns [first own target, R) (tile 0 owns [0, R), the
// head), which partition [0, W): it writes each of them exactly once,
// value and covered flag or zeros, one 16-byte store of out per thread and
// step, each warp a contiguous share (so a warp stores contiguous bytes),
// finding a segment's pairs from a cursor that only moves forward.  There
// is no zero pass and no barrier between a zero fill and a scatter. Inputs
// outside the contract (targets not rising) need not match the plain
// version, but still end.

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // threads per block
constexpr int EPT = 16;   // elements per thread
constexpr int TILE = 4096;
static_assert(TILE == TPB * EPT, "a tile is one element group per thread");
constexpr int NW = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long AGG = 1ull << 32, INCL = 2ull << 32;
constexpr int NO_PAIR = 0x7fffffff;  // no column of a row < 2^31 - 16

// Tile-local exclusive scan of one count per thread; returns the
// thread's offset and sets `total`.  Two barriers.
__device__ __forceinline__ int block_scan(int c, int& total) {
  __shared__ int s_warp[NW + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NW ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < NW) s_warp[lane] = wi - w;
    if (lane == NW - 1) s_warp[NW] = wi;
  }
  __syncthreads();
  total = s_warp[NW];
  return s_warp[warp] + incl - c;
}

// EPT elements from p: as 16-byte vectors when they all lie in the row
// and p is 16-byte aligned, else the first `n` one by one.
template <typename T>
__device__ __forceinline__ void load_ept(const T* p, long long n, T (&x)[EPT]) {
  constexpr int BYTES = EPT * sizeof(T);
  static_assert(BYTES % 16 == 0, "EPT elements are whole 16-byte vectors");
  if (n >= EPT && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    unsigned w[BYTES / 4];
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = u.x; w[4 * q + 1] = u.y; w[4 * q + 2] = u.z;
      w[4 * q + 3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if constexpr (sizeof(T) == 1) {
        x[k] = static_cast<T>(w[k / 4] >> (8 * (k % 4)));
      } else {
        x[k] = static_cast<T>(w[k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < EPT; ++k) x[k] = k < n ? p[k] : T(0);
  }
}

__device__ __forceinline__ unsigned mask_ept(const uint8_t* p, long long n) {
  uint8_t b[EPT];
  load_ept(p, n, b);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < EPT; ++k) m |= (b[k] != 0 ? 1u : 0u) << k;
  return m;
}

// Copy s[q0, q0 + c) (shared, 16-byte aligned, element q of s belonging
// at global element g0 - q0 + q) to dst[g0, g0 + c), 16-byte stores where
// a whole aligned vector is inside the range.  q0 = g0 % VEC.  With
// s == nullptr the range is zero-filled.
template <typename T>
__device__ __forceinline__ void store_run(T* dst, long long g0, long long c,
                                          const T* s) {
  constexpr int VEC = 16 / sizeof(T);
  const long long q0 = g0 % VEC, base = g0 - q0;
  const long long nv = (q0 + c + VEC - 1) / VEC;
  for (long long k = threadIdx.x; k < nv; k += TPB) {
    const long long q = k * VEC;
    if (q >= q0 && q + VEC <= q0 + c) {
      *reinterpret_cast<int4*>(dst + base + q) =
          s ? *reinterpret_cast<const int4*>(s + q) : make_int4(0, 0, 0, 0);
    } else {
      for (long long e = max(q, q0); e < min(q + VEC, q0 + c); ++e)
        dst[base + e] = s ? s[e] : T(0);
    }
  }
}

// SHIFTS: write holes-before-element (j - rank) instead of the payload.
template <typename T, bool SHIFTS>
__global__ void __launch_bounds__(TPB)
compact_kernel(const T* __restrict__ v, const uint8_t* __restrict__ keep,
               T* __restrict__ out, int* __restrict__ count, long long N,
               long long tiles, unsigned long long* __restrict__ status) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) T s_run[TILE + VEC];
  __shared__ long long s_prefix;
  const long long g = htt_take_ticket(status, tiles);
  const long long row = g / tiles, t = g % tiles;
  const long long j0 = t * TILE + static_cast<long long>(threadIdx.x) * EPT;
  const long long left = N - j0;
  const unsigned m = left > 0 ? mask_ept(keep + row * N + j0, left) : 0u;
  T x[EPT];
  if (!SHIFTS && m) load_ept(v + row * N + j0, left, x);
  int c_tile;
  const int lr = block_scan(__popc(m), c_tile);

  // decoupled look-back: the row's kept count before this tile
  if (tiles > 1 && threadIdx.x < 32) {
    unsigned long long* st = status + row * tiles;
    const int lane = threadIdx.x;
    long long excl = 0;
    if (t > 0) {
      if (lane == 0) htt_st_status(st + t, AGG | static_cast<unsigned>(c_tile));
      for (long long jb = t - 1;; jb -= 32) {
        const long long idx = jb - lane;
        unsigned long long s = INCL;
        if (idx >= 0) {
          do { s = htt_ld_status(st + idx); } while ((s >> 32) == 0);
        }
        const unsigned incl = __ballot_sync(FULL, (s >> 32) == 2);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        long long add = lane <= stop ? static_cast<long long>(s & FULL) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) add += __shfl_xor_sync(FULL, add, d);
        excl += add;
        if (incl) break;
      }
    }
    if (lane == 0) {
      htt_st_status(st + t, INCL | static_cast<unsigned>(excl + c_tile));
      s_prefix = excl;
    }
  }
  __syncthreads();
  const long long P = tiles > 1 ? s_prefix : 0;

  // stage the kept elements at their rank, then write the run
  const long long g0 = row * N + P;
  const int q0 = static_cast<int>(g0 % VEC);
  int r = q0 + lr;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    if (m >> k & 1) {
      if constexpr (SHIFTS) {
        s_run[r] = static_cast<T>(j0 + k - (P + r - q0));
      } else {
        s_run[r] = x[k];
      }
      ++r;
    }
  }
  __syncthreads();
  store_run(out, g0, c_tile, s_run);
  if (t == tiles - 1) {
    const long long cnt = P + c_tile;
    store_run(out, row * N + cnt, N - cnt, static_cast<const T*>(nullptr));
    if (threadIdx.x == 0) count[row] = static_cast<int>(cnt);
  }
}

// Staging slot of pair i: a word of padding after every 16 pairs, so
// that the lanes of a warp, each storing its run of consecutive pairs,
// meet different banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// out[j + shift[j]] = v[j] for valid j (targets strictly increasing);
// every other column 0, covered marks the written columns.  Targets
// outside [0, W) are dropped.  out and covered are 16-byte aligned.
// A row of one tile takes TPB / rpb threads (whole warps), so a block
// takes rpb such rows (the last block's spare groups idle); rpb is 1
// when rows have several tiles.
template <typename T>
__global__ void __launch_bounds__(TPB, 6)
expand_kernel(const T* __restrict__ v, const int* __restrict__ shift,
              const uint8_t* __restrict__ valid, T* __restrict__ out,
              uint8_t* __restrict__ covered, long long B, long long N,
              long long W, long long per, long long tiles, int rpb,
              unsigned long long* __restrict__ status) {
  __shared__ int s_tgt[TILE + TILE / 16];
  __shared__ T s_val[TILE + TILE / 16];
  __shared__ int s_base[NW];
  __shared__ long long s_next;
  const int G = TPB / rpb, grp = threadIdx.x / G, gt = threadIdx.x % G;
  const long long g = htt_take_ticket(status, tiles);
  const long long row = tiles == 1 ? g * rpb + grp : g / tiles;
  const long long t = tiles - 1 - g % tiles;
  const long long j0 = t * per + static_cast<long long>(gt) * EPT;
  const long long left = row < B ? min(N, (t + 1) * per) - j0 : 0;
  unsigned m = left > 0 ? mask_ept(valid + row * N + j0, left) : 0u;
  int tg[EPT];
  T x[EPT];
  if (m) {
    load_ept(shift + row * N + j0, left, tg);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const long long tt = j0 + k + tg[k];
      if (tt < 0 || tt >= W) m &= ~(1u << k);
      tg[k] = static_cast<int>(tt);
    }
  }
  if (m) load_ept(v + row * N + j0, left, x);
  // one scan over the block; a row's pairs are the run the scan gives
  // its threads, [s_base[grp], next group's base)
  int c_block;
  int r = block_scan(__popc(m), c_block);
  if (gt == 0) s_base[grp] = r;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    if (m >> k & 1) {
      s_tgt[slot(r)] = tg[k];
      s_val[slot(r)] = x[k];
      ++r;
    }
  }
  __syncthreads();
  const int base = s_base[grp];
  const int c_tile = (grp + 1 < rpb ? s_base[grp + 1] : c_block) - base;
  auto tgt = [&](int i) { return s_tgt[slot(base + i)]; };
  auto val = [&](int i) { return s_val[slot(base + i)]; };

  // look-ahead: the first in-range target of the later tiles (W if none)
  const long long first = c_tile ? tgt(0) : W;
  if (tiles > 1 && threadIdx.x < 32) {
    unsigned long long* st = status + row * tiles;
    const int lane = threadIdx.x;
    long long next = W;
    if (t < tiles - 1) {
      if (lane == 0)
        htt_st_status(st + t, (first < W ? INCL : AGG) | static_cast<unsigned>(first));
      for (long long jb = t + 1;; jb += 32) {
        const long long idx = jb + lane;
        unsigned long long s = INCL | static_cast<unsigned>(W);
        if (idx < tiles) {
          do { s = htt_ld_status(st + idx); } while ((s >> 32) == 0);
        }
        const long long later = static_cast<long long>(s & FULL);
        const unsigned done = __ballot_sync(FULL, (s >> 32) == 2 || later < W);
        const int stop = done ? __ffs(done) - 1 : 31;
        long long best = lane <= stop ? later : W;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          best = min(best, __shfl_xor_sync(FULL, best, d));
        next = min(next, best);
        if (done) break;
      }
    }
    if (lane == 0) {
      htt_st_status(st + t, INCL | static_cast<unsigned>(min(first, next)));
      s_next = next;
    }
  }
  __syncthreads();
  if (row >= B) return;
  const int lo = t == 0 ? 0 : static_cast<int>(first);
  const int hi = static_cast<int>(tiles > 1 ? s_next : W);
  if (lo >= hi) return;

  // write the owned columns [lo, hi) once, in segments of SEG columns,
  // one 16-byte store of out each, aligned in memory.  Each of the row's
  // warps takes a contiguous share of the segments and its lanes
  // neighbouring ones, so a warp's stores are contiguous and a lane's
  // next segment lies 32 segments on.  A lane keeps a cursor `a` (the
  // first pair with target >= its segment's first column) and that
  // pair's target `next` in a register: a segment in a gap costs no
  // shared load, the cursor moves by a few linear probes, and by a binary
  // search where pairs are dense.
  constexpr int SEG = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, wg = gt >> 5, nwg = G >> 5;
  const long long rb = row * W;
  const long long s0 = (rb + lo) / SEG, s1 = (rb + hi + SEG - 1) / SEG;
  const long long share = ((s1 - s0 + nwg - 1) / nwg + 31) / 32 * 32;
  const long long w1 = min(s1, s0 + (wg + 1) * share);
  long long sg = s0 + wg * share + lane;
  int a = 0, z = c_tile;
  const int cfirst = static_cast<int>(sg * SEG - rb);
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (tgt(mid) < cfirst) a = mid + 1; else z = mid;
  }
  int next = a < c_tile ? tgt(a) : NO_PAIR;
  for (; sg < w1; sg += 32) {
    const int c0 = static_cast<int>(sg * SEG - rb);
    if (next < c0) {
#pragma unroll
      for (int probe = 0; probe < 4; ++probe) {
        if (next < c0) {
          ++a;
          next = a < c_tile ? tgt(a) : NO_PAIR;
        }
      }
      if (next < c0) {
        z = c_tile;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (tgt(mid) < c0) a = mid + 1; else z = mid;
        }
        next = a < c_tile ? tgt(a) : NO_PAIR;
      }
    }
    // A segment in a gap is zeros; one whose columns are all targets (SEG
    // consecutive pairs) loads its values independently; any other walks
    // its columns.
    unsigned ow[4] = {0, 0, 0, 0}, cw[SEG / 4];
#pragma unroll
    for (int q = 0; q < SEG / 4; ++q) cw[q] = 0;
    if (next < c0 + SEG) {
      const bool dense = next == c0 && a + SEG - 1 < c_tile &&
                         tgt(a + SEG - 1) == c0 + SEG - 1;
#pragma unroll
      for (int e = 0; e < SEG; ++e) {
        bool hit;
        T y;
        if (dense) {
          hit = true;
          y = val(a + e);
        } else {
          hit = next == c0 + e;
          y = hit ? val(a) : T(0);
          if (hit) {
            ++a;
            next = a < c_tile ? tgt(a) : NO_PAIR;
          }
        }
        cw[e / 4] |= (hit ? 1u : 0u) << (8 * (e % 4));
        if constexpr (sizeof(T) == 1) {
          ow[e / 4] |= static_cast<unsigned>(y) << (8 * (e % 4));
        } else {
          ow[e] = static_cast<unsigned>(y);
        }
      }
      if (dense) {
        a += SEG;
        next = a < c_tile ? tgt(a) : NO_PAIR;
      }
    }
    // whole segments go out as vector stores, the partial ones at the
    // range's two ends column by column
    if (c0 >= lo && c0 + SEG <= hi) {
      *reinterpret_cast<uint4*>(out + rb + c0) =
          make_uint4(ow[0], ow[1], ow[2], ow[3]);
      if constexpr (SEG == 16) {
        *reinterpret_cast<uint4*>(covered + rb + c0) =
            make_uint4(cw[0], cw[1], cw[2], cw[3]);
      } else {
        *reinterpret_cast<unsigned*>(covered + rb + c0) = cw[0];
      }
    } else {
#pragma unroll
      for (int e = 0; e < SEG; ++e) {
        const int c = c0 + e;
        if (c >= lo && c < hi) {
          if constexpr (sizeof(T) == 1) {
            out[rb + c] = static_cast<T>(ow[e / 4] >> (8 * (e % 4)));
          } else {
            out[rb + c] = static_cast<T>(ow[e]);
          }
          covered[rb + c] = (cw[e / 4] >> (8 * (e % 4))) & 1u;
        }
      }
    }
  }
}

// status: B * tiles + 1 zeroed words (tile states, then the ticket), or
// null for rows of one tile.
template <typename T, bool SHIFTS>
int launch_compact(const void* v, const void* keep, void* out, void* count,
                   long long B, long long N, void* status, void* stream) {
  const long long tiles = N > 0 ? (N + TILE - 1) / TILE : 1;
  if (B > 0) {
    compact_kernel<T, SHIFTS><<<static_cast<unsigned>(B * tiles), TPB, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const uint8_t*>(keep),
        static_cast<T*>(out), static_cast<int*>(count), N, tiles,
        static_cast<unsigned long long*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}

// rpb: rows per block (1, 2, 4 or 8), more than 1 only for rows of one
// tile of at most TILE / rpb elements.
template <typename T>
int launch_expand(const void* v, const void* shift, const void* valid,
                  void* out, void* covered, long long B, long long N,
                  long long W, long long per, long long rpb, void* status,
                  void* stream) {
  const long long tiles = N > 0 ? (N + per - 1) / per : 1;
  if (B > 0 && W > 0) {
    const long long blocks = tiles == 1 ? (B + rpb - 1) / rpb : B * tiles;
    expand_kernel<T><<<static_cast<unsigned>(blocks), TPB, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const int*>(shift),
        static_cast<const uint8_t*>(valid), static_cast<T*>(out),
        static_cast<uint8_t*>(covered), B, N, W, per, tiles,
        static_cast<int>(rpb), static_cast<unsigned long long*>(status));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

HTT_EXPORT int htt_compact_u8(const void* v, const void* keep, void* out,
                              void* count, long long B, long long N,
                              void* status, void* stream) {
  return launch_compact<uint8_t, false>(v, keep, out, count, B, N, status,
                                        stream);
}

HTT_EXPORT int htt_compact_i32(const void* v, const void* keep, void* out,
                               void* count, long long B, long long N,
                               void* status, void* stream) {
  return launch_compact<int, false>(v, keep, out, count, B, N, status, stream);
}

HTT_EXPORT int htt_compaction_shifts(const void* keep, void* out, void* count,
                                     long long B, long long N, void* status,
                                     void* stream) {
  return launch_compact<int, true>(nullptr, keep, out, count, B, N, status,
                                   stream);
}

HTT_EXPORT int htt_expand_u8(const void* v, const void* shift,
                             const void* valid, void* out, void* covered,
                             long long B, long long N, long long W,
                             long long per, long long rpb, void* status,
                             void* stream) {
  return launch_expand<uint8_t>(v, shift, valid, out, covered, B, N, W, per,
                                rpb, status, stream);
}

HTT_EXPORT int htt_expand_i32(const void* v, const void* shift,
                              const void* valid, void* out, void* covered,
                              long long B, long long N, long long W,
                              long long per, long long rpb, void* status,
                              void* stream) {
  return launch_expand<int>(v, shift, valid, out, covered, B, N, W, per, rpb,
                            status, stream);
}
