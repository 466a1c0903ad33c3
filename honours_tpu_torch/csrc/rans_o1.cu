// Kernels 2, 4 and 4b: order-1 rANS table lookup, the order-1 decode
// walk and its order-0 entry.
//
// Kernel 2 replaces honours_tpu/engine/rans_o1_pallas.py
// o1_fc_gather_pallas (pallas_call at :147).  Per element it returns
// fc = fc_tab[cmap[ctx]][sym] (f + cum_lo * 8192) for ctx in [0, 256]
// (256 = CTX0).  The TPU kernel emulates the gather with predicated
// single-vreg gathers over 128 table chunks; here the table (<= 64
// clusters x 256 int32 = 64 KiB) and cmap sit in shared memory and the
// gather is two shared-memory loads.
// Bound on this card: bytes: 12 B of device memory per element (sym and
// ctx read, fc written) against two shared loads and a few integer ops.
// Design: a persistent grid of one 1024-thread block per SM, so the
// table is copied from device memory once per SM (<= 132 x 66 KB, where
// three blocks per SM each copied it before); cmap is stored pre-scaled
// by 256.  Each
// thread then moves 4 elements per step as one 16-byte load of sym, one
// of ctx and one 16-byte store of fc, two steps in flight per loop trip.
// The elements before sym's first 16-byte boundary and the last n % 4
// are done one by one; the wrapper places fc at sym's alignment, and ctx
// is read 4 bytes at a time when its alignment differs.  The launch's
// shared-memory limit is raised once per device, not per call.
//
// Kernel 4 replaces rans_o1_pallas.py `_decode_call` (pallas_call at
// :447) as launched through rans_o1_decode_resume_pallas (:530): the
// forward order-1 decode walk over global steps [step_lo, step_hi) of
// each read.  Kernel 4b replaces the order-0 entry of the same walk,
// rans_decode_shared_pallas (:561, order0=True): format v2, one CDF, no
// S header, round-robin lanes (step t of lane k is byte t*K + k, active
// while t*K + k < dlen).  The TPU kernel materializes CDF rows through
// bf16 one-hot matmuls, takes refill ranks from a triangular matmul and
// keeps a window of the stream in VMEM.
// Bound on this card: latency.  The bytes (stream in, symbols out) are a
// few hundred KB per read, but each step depends on the previous state,
// so a read is a serial chain of one step per symbol a lane decodes.
// Chain floor (a model, PERF.md): the dependent path of one step in the
// SASS is, order 1, three shared loads (pair rank, word, window byte), a
// vote, a popcount and about 16 integer ops, about 180 cycles; order 0,
// two shared loads and about 12 integer ops, about 135 cycles.
// Design: lane k of a warp is rANS lane k of a read, 1-8 reads (warps) a
// block (walk_reads_per_block), and every load on a step's dependent path
// is a shared-memory load issued where it stands:
// - Lookup.  A prep kernel writes the walk's tables once per launch into
//   scratch the wrapper allocates, and each block copies them with
//   cp.async.  Order 1 (one prep block per cluster): the non-zero
//   symbols as packed words c | (c + f - 1) << 12 | sym << 24 (NZW a
//   row), the rank of the symbol holding slot 2j for each slot pair
//   (PAIRS bytes a row: slot 2j + 1 lies in that symbol or the next
//   non-zero one, so zero-frequency runs cost nothing), and per context
//   its cluster's row addresses.  A step loads the rank, then both words
//   at once, forms both candidates' states and picks one: no probe, no
//   branch.  At r = 64 the tables are 195 KB, so a block holds one copy
//   for its 1-8 reads.  Order 0: one word per slot (4096), one load.
// - Refill.  Round 2 of the refill takes a byte iff the state after the
//   decode is below 2^15, so both rounds' ballots and both byte loads
//   issue together.  The bytes come from a RING-byte window of the
//   stream in shared memory: four SEG-byte segments, filled by cp.async
//   two segments ahead of the pointer, zeros outside the row (the row's
//   end lines byte by byte), so a stream walked with the wrong table or
//   cut short runs on to garbage without a fault or a per-byte check.
//   The walk keeps the pointer as 32-bit ring coordinates and returns the
//   absolute pointer.  The window and the refill (htt_walk in common.cuh)
//   are kernel 8's too.
// - Output.  Order 1: each lane packs 16 steps' symbols in registers and
//   stores them as one 16-byte line of its grid row (byte stores when
//   the row is not 16-byte aligned, and for the last steps).  Order 0:
//   each step's 32 bytes are contiguous and are stored as they come.
// - Once every lane of a read is past its last active step the chain
//   stops; order 1 repeats each lane's (now fixed) symbol to the end of
//   its row, order 0 writes zeros.

#include "common.cuh"

namespace {

constexpr int FC_T = 1024;
constexpr int K = 32;
constexpr int MAX_CL = 64;
constexpr int CTX0 = 256;
constexpr int FC_CMAP = 260;  // cmap words, padded so the table is 16-byte aligned
constexpr int FC_SMEM_MAX = (FC_CMAP + MAX_CL * 256) * sizeof(int);

__device__ __forceinline__ int fc_of(const int* s_cmap, const int* s_fc,
                                      int sym, int ctx) {
  return s_fc[s_cmap[min(max(ctx, 0), CTX0)] + (sym & 255)];
}

__global__ void __launch_bounds__(FC_T, 1)
o1_fc_kernel(const int* __restrict__ sym, const int* __restrict__ ctx,
             const int* __restrict__ cmap, const int* __restrict__ fc_tab,
             int r, long long n, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sm[];
  int* s_cmap = reinterpret_cast<int*>(sm);  // cluster * 256, per context
  int* s_fc = s_cmap + FC_CMAP;
  for (int i = threadIdx.x; i < CTX0 + 1; i += FC_T)
    s_cmap[i] = min(max(cmap[i], 0), r - 1) * 256;
  for (int i = threadIdx.x; i < r * 256; i += FC_T) s_fc[i] = fc_tab[i];
  __syncthreads();

  // elements [0, head) and [head + 4 * nv, n) one by one
  const long long head = min(
      n, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(sym) & 15)) & 15) / 4);
  const long long nv = (n - head) / 4;
  const long long tail = head + 4 * nv;
  const long long tid = static_cast<long long>(blockIdx.x) * FC_T + threadIdx.x;
  if (tid < head) out[tid] = fc_of(s_cmap, s_fc, sym[tid], ctx[tid]);
  if (tid < n - tail)
    out[tail + tid] = fc_of(s_cmap, s_fc, sym[tail + tid], ctx[tail + tid]);

  const int4* sv = reinterpret_cast<const int4*>(sym + head);
  const int* cp = ctx + head;
  int* op = out + head;
  const bool ctx_vec = (reinterpret_cast<uintptr_t>(cp) & 15) == 0;
  const bool out_vec = (reinterpret_cast<uintptr_t>(op) & 15) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * FC_T;
  for (long long i = tid; i < nv; i += 2 * stride) {
    int4 s[2], c[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long k = i + u * stride;
      if (k < nv) {
        s[u] = sv[k];
        c[u] = ctx_vec ? reinterpret_cast<const int4*>(cp)[k]
                       : make_int4(cp[4 * k], cp[4 * k + 1], cp[4 * k + 2],
                                   cp[4 * k + 3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long k = i + u * stride;
      if (k < nv) {
        const int4 f = make_int4(fc_of(s_cmap, s_fc, s[u].x, c[u].x),
                                 fc_of(s_cmap, s_fc, s[u].y, c[u].y),
                                 fc_of(s_cmap, s_fc, s[u].z, c[u].z),
                                 fc_of(s_cmap, s_fc, s[u].w, c[u].w));
        if (out_vec) {
          reinterpret_cast<int4*>(op)[k] = f;
        } else {
          op[4 * k] = f.x; op[4 * k + 1] = f.y;
          op[4 * k + 2] = f.z; op[4 * k + 3] = f.w;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels 4 and 4b: the decode walks
// ---------------------------------------------------------------------------

using htt_walk::FULL;
using htt_walk::RING;
using htt_walk::Window;
using htt_walk::put_bytes;
using htt_walk::refill;
using htt_walk::ring_of;
constexpr int NZW = 260;       // packed words a cluster row (<= 256 + pad)
constexpr int PAIRS = 2048;    // order 1: slot pairs a cluster
constexpr int O0_WORDS = 4096; // order 0: a packed word per slot
constexpr int MAX_RPB = 8;     // reads (warps) a block
constexpr int PREP_T = 256;
constexpr int GROUP = 16;      // order-1 steps a lane packs into one store

// bytes of the order-1 walk's tables for r clusters: the packed words
// [r, NZW] u32, the pair ranks [r, PAIRS] u8, the cluster bases
// [FC_CMAP] int2 (cluster * PAIRS, cluster * NZW * 4) by context
__host__ __device__ constexpr long long o1_layout_bytes(long long r) {
  return r * (NZW * 4 + PAIRS) + FC_CMAP * 8;
}
constexpr long long O1_SMEM_MAX = o1_layout_bytes(MAX_CL) + (MAX_RPB + 1) * RING;

__device__ __forceinline__ unsigned pack_word(unsigned c, unsigned hi,
                                              unsigned sym) {
  return c | ((hi - 1u) << 12) | (sym << 24);
}

// largest s in [0, 255] with cum[s] <= v
__device__ __forceinline__ int cdf_search(const int* cum, int v) {
  int a = 0, z = 256;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int m = (a + z) >> 1;
    if (cum[m] <= v) a = m; else z = m;
  }
  return a;
}

// One block per cluster: its non-zero symbols' words (in symbol order,
// the rest of the row all ones), the rank of the symbol holding slot 2j
// for every pair j, and, from block 0, each context's cluster bases.
__global__ void __launch_bounds__(PREP_T)
o1_prep_kernel(const int* __restrict__ cmap, const int* __restrict__ cum,
               int r, uint8_t* __restrict__ layout) {
  __shared__ int s_cum[257];
  __shared__ int s_rank[256];
  __shared__ int s_warp[PREP_T / 32];
  const int cl = blockIdx.x, t = threadIdx.x;
  unsigned* words = reinterpret_cast<unsigned*>(layout) + cl * NZW;
  uint8_t* pairs = layout + r * NZW * 4LL + cl * PAIRS;
  for (int i = t; i < 257; i += PREP_T) s_cum[i] = cum[cl * 257 + i];
  __syncthreads();
  const int c = s_cum[t], hi = s_cum[t + 1];
  const bool live = hi > c;
  const unsigned m = __ballot_sync(FULL, live);
  if ((t & 31) == 0) s_warp[t >> 5] = __popc(m);
  __syncthreads();
  int rank = __popc(m & htt_lanemask_lt()), total = 0;
  for (int w = 0; w < PREP_T / 32; ++w) {
    rank += w < (t >> 5) ? s_warp[w] : 0;
    total += s_warp[w];
  }
  s_rank[t] = rank;
  if (live) words[rank] = pack_word(c, hi, t);
  for (int i = total + t; i < NZW; i += PREP_T) words[i] = FULL;
  __syncthreads();
  for (int j = t; j < PAIRS; j += PREP_T)
    pairs[j] = static_cast<uint8_t>(s_rank[cdf_search(s_cum, 2 * j)]);
  if (cl == 0) {
    int2* bases = reinterpret_cast<int2*>(layout + r * (NZW * 4LL + PAIRS));
    for (int i = t; i < FC_CMAP; i += PREP_T) {
      const int b = i <= CTX0 ? min(max(cmap[i], 0), r - 1) : 0;
      bases[i] = make_int2(b * PAIRS, b * NZW * 4);
    }
  }
}

// Order 0: the packed word of every slot.
__global__ void __launch_bounds__(PREP_T)
o0_prep_kernel(const int* __restrict__ cum, unsigned* __restrict__ words) {
  __shared__ int s_cum[257];
  for (int i = threadIdx.x; i < 257; i += PREP_T) s_cum[i] = cum[i];
  __syncthreads();
  const int slot = blockIdx.x * PREP_T + threadIdx.x;
  const int s = cdf_search(s_cum, slot);
  words[slot] = pack_word(s_cum[s], s_cum[s + 1], s);
}

__device__ __forceinline__ unsigned decode_state(unsigned x, unsigned w) {
  const unsigned c = w & 4095u;
  return (((w >> 12) & 4095u) + 1u - c) * (x >> 12) + (x & 4095u) - c;
}

// The order-1 lookup and decode of `slot` in the cluster whose shared
// addresses (pair ranks, words) are `base`: the pair's rank gives the
// symbol holding slot 2j and, for slot 2j + 1, the next one may hold it;
// both words load at once and both candidates' states are formed before
// the choice.  Returns the word; *xd gets the decoded state.
__device__ __forceinline__ unsigned o1_lookup(uint2 base, unsigned x,
                                              unsigned* xd) {
  const unsigned slot = x & 4095u;
  const unsigned wa = base.y + 4 * htt_lds_u8(base.x + (slot >> 1));
  const unsigned w0 = htt_lds_u32(wa);
  const unsigned w1 = htt_lds_u32(wa + 4);
  const bool second = slot > ((w0 >> 12) & 4095u);
  *xd = second ? decode_state(x, w1) : decode_state(x, w0);
  return second ? w1 : w0;
}

__device__ __forceinline__ unsigned o1_step(unsigned& x, uint2& base,
                                            bool active, unsigned s_bases,
                                            Window& win, unsigned lt) {
  unsigned xd;
  const unsigned sym = o1_lookup(base, x, &xd) >> 24;
  const uint2 next = htt_lds_u32x2(s_bases + 8 * sym);
  x = active ? xd : x;
  base.x = active ? next.x : base.x;
  base.y = active ? next.y : base.y;
  x = refill(x, active, win, lt);
  win.keep_up();
  return sym;
}

__global__ void __launch_bounds__(K * MAX_RPB)
o1_decode_kernel(const uint8_t* __restrict__ stream, long long Mb,
                 const unsigned* __restrict__ states_in,
                 const int* __restrict__ dlen, const int* __restrict__ S_b,
                 const int* __restrict__ step_lo,
                 const int* __restrict__ step_hi,
                 const int* __restrict__ init_cl,
                 const int* __restrict__ body_off,
                 const uint8_t* __restrict__ layout, int r, long long B,
                 int T, uint8_t* __restrict__ grid,
                 unsigned* __restrict__ states_out, int* __restrict__ ptr_out) {
  extern __shared__ __align__(16) uint8_t sm[];
  const long long lbytes = o1_layout_bytes(r);
  htt_copy_to_shared(sm, layout, lbytes);
  // the bases become shared addresses
  const unsigned s_words = htt_shared_addr(sm);
  const unsigned s_pairs = s_words + r * NZW * 4;
  const unsigned s_bases = s_pairs + r * PAIRS;
  uint2* bases = reinterpret_cast<uint2*>(sm + r * (NZW * 4LL + PAIRS));
  for (int i = threadIdx.x; i < FC_CMAP; i += blockDim.x)
    bases[i] = make_uint2(bases[i].x + s_pairs, bases[i].y + s_words);
  __syncthreads();

  const int w = threadIdx.x >> 5, k = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (b >= B) return;
  unsigned x = states_in[b * K + k];
  const unsigned cl0 = min(max(init_cl[b * K + k], 0), r - 1);
  uint2 base = make_uint2(s_pairs + cl0 * PAIRS, s_words + cl0 * NZW * 4);
  const long long lo = step_lo[b];
  // lane k is active at local step i < n_act: lo + i < step_hi and
  // k*S + lo + i < dlen
  const long long end = min(static_cast<long long>(step_hi[b]),
                            dlen[b] - static_cast<long long>(k) * S_b[b]);
  const int n_act = static_cast<int>(min(max(end - lo, 0LL),
                                         static_cast<long long>(T)));
  const int iend = __reduce_max_sync(FULL, n_act);
  Window win;
  win.start(stream + b * Mb, Mb, ring_of(sm, lbytes, w), body_off[b], k);
  uint8_t* g = grid + (b * K + k) * static_cast<long long>(T);
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const unsigned lt = htt_lanemask_lt();

  int i = 0;
  for (; i + GROUP <= iend; i += GROUP) {
    unsigned v[GROUP / 4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
      v[j >> 2] |= o1_step(x, base, i + j < n_act, s_bases, win, lt)
                   << (8 * (j & 3));
    if (vec) *reinterpret_cast<uint4*>(g + i) = make_uint4(v[0], v[1], v[2], v[3]);
    else put_bytes(g + i, v, GROUP);
  }
  for (; i < iend; ++i)
    g[i] = static_cast<uint8_t>(o1_step(x, base, i < n_act, s_bases, win, lt));
  if (i < T) {  // every lane is past its last active step: its symbol stays
    unsigned xd;
    htt_walk::fill_tail(g, i, T, o1_lookup(base, x, &xd) >> 24);
  }
  htt_cp_wait<0>();
  states_out[b * K + k] = x;
  if (k == 0) ptr_out[b] = static_cast<int>(win.pa - static_cast<unsigned>(win.delta));
}

__global__ void __launch_bounds__(K * MAX_RPB)
o0_decode_kernel(const uint8_t* __restrict__ stream, long long Mb,
                 const unsigned* __restrict__ states_in,
                 const int* __restrict__ dlen,
                 const int* __restrict__ body_off,
                 const unsigned* __restrict__ layout, long long B, long long N,
                 int T, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t sm[];
  htt_copy_to_shared(sm, layout, O0_WORDS * 4);
  const unsigned* s_words = reinterpret_cast<const unsigned*>(sm);

  const int w = threadIdx.x >> 5, k = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (b >= B) return;
  uint8_t* o = out + b * N;
  unsigned x = states_in[b * K + k];
  // lane k is active at step t < n_act: t*K + k < dlen
  const long long left = dlen[b] - k;
  const int n_act = static_cast<int>(
      min(left > 0 ? (left + K - 1) / K : 0LL, static_cast<long long>(T)));
  const int tend = __reduce_max_sync(FULL, n_act);
  // lane k writes byte t*K + k of its row while t < n_out
  const int n_out = static_cast<int>((N - k + K - 1) / K);
  Window win;
  win.start(stream + b * Mb, Mb, ring_of(sm, O0_WORDS * 4, w), body_off[b], k);
  const unsigned lt = htt_lanemask_lt();

  uint8_t* op = o + k;
#pragma unroll 4
  for (int t = 0; t < tend; ++t, op += K) {
    const bool active = t < n_act;
    const unsigned wd = s_words[x & 4095u];
    if (t < n_out) *op = active ? static_cast<uint8_t>(wd >> 24) : 0;
    x = active ? decode_state(x, wd) : x;
    x = refill(x, active, win, lt);
    win.keep_up();
  }
  for (long long idx = static_cast<long long>(tend) * K + k; idx < N; idx += K)
    o[idx] = 0;
  htt_cp_wait<0>();
}

}  // namespace

HTT_EXPORT int htt_o1_fc(const void* sym, const void* ctx, const void* cmap,
                         const void* fc_tab, long long r, long long n,
                         void* out, long long grid, void* stream) {
  static bool smem_set[64];
  htt_smem_limit_once(o1_fc_kernel, FC_SMEM_MAX, smem_set);
  if (n > 0) {
    const size_t smem = (FC_CMAP + r * 256) * sizeof(int);
    o1_fc_kernel<<<static_cast<unsigned>(grid), FC_T, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sym), static_cast<const int*>(ctx),
        static_cast<const int*>(cmap), static_cast<const int*>(fc_tab),
        static_cast<int>(r), n, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_o1_decode(const void* stream, long long B, long long Mb,
                             const void* states_in, const void* dlen,
                             const void* S_b, const void* step_lo,
                             const void* step_hi, const void* init_cl,
                             const void* body_off, const void* cmap,
                             const void* cum, long long r, long long T,
                             void* grid, void* states_out, void* ptr_out,
                             void* layout, long long rpb, void* cuda_stream) {
  static bool smem_set[64];
  htt_smem_limit_once(o1_decode_kernel, static_cast<int>(O1_SMEM_MAX),
                      smem_set);
  if (B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    o1_prep_kernel<<<static_cast<unsigned>(r), PREP_T, 0, st>>>(
        static_cast<const int*>(cmap), static_cast<const int*>(cum),
        static_cast<int>(r), static_cast<uint8_t*>(layout));
    const size_t smem = o1_layout_bytes(r) + (rpb + 1) * RING;
    o1_decode_kernel<<<static_cast<unsigned>((B + rpb - 1) / rpb),
                       static_cast<unsigned>(K * rpb), smem, st>>>(
        static_cast<const uint8_t*>(stream), Mb,
        static_cast<const unsigned*>(states_in),
        static_cast<const int*>(dlen), static_cast<const int*>(S_b),
        static_cast<const int*>(step_lo), static_cast<const int*>(step_hi),
        static_cast<const int*>(init_cl), static_cast<const int*>(body_off),
        static_cast<const uint8_t*>(layout), static_cast<int>(r), B,
        static_cast<int>(T), static_cast<uint8_t*>(grid),
        static_cast<unsigned*>(states_out), static_cast<int*>(ptr_out));
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_o0_decode(const void* stream, long long B, long long Mb,
                             const void* states_in, const void* dlen,
                             const void* body_off, const void* cum,
                             long long N, long long T, void* out,
                             void* layout, long long rpb, void* cuda_stream) {
  if (B > 0 && N > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    o0_prep_kernel<<<O0_WORDS / PREP_T, PREP_T, 0, st>>>(
        static_cast<const int*>(cum), static_cast<unsigned*>(layout));
    const size_t smem = O0_WORDS * 4 + (rpb + 1) * RING;
    o0_decode_kernel<<<static_cast<unsigned>((B + rpb - 1) / rpb),
                       static_cast<unsigned>(K * rpb), smem, st>>>(
        static_cast<const uint8_t*>(stream), Mb,
        static_cast<const unsigned*>(states_in),
        static_cast<const int*>(dlen), static_cast<const int*>(body_off),
        static_cast<const unsigned*>(layout), B, N, static_cast<int>(T),
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
