// Kernels 7 and 8: the nibble-factorized order-1 rANS (format v4, srans3)
// table lookup and decode walk.
//
// Each residual byte codes as two 16-symbol rANS steps: its high nibble
// under the context cluster cl = cmap[previous byte] (CTX0 = 256 for a
// lane's first byte), then its low nibble under gl = lo_assign[cl*16+hi].
// Tables: cmap [257], lo_assign [r*16], fcH [r*16] and fcL [rL*16] int32
// with fc = f + cum_lo * 8192; r, rL <= 64.
//
// Kernel 7 replaces honours_tpu/engine/rans_n4_pallas.py
// o1n_fc_gather_pallas (pallas_call at :77): per element
// fc_hi = fcH[cl*16 + hi] and fc_lo = fcL[gl*16 + lo].  The TPU kernel
// emulates each of the three table reads with predicated single-vreg
// gathers over the table's 128-lane chunks; here all four tables
// (13 KB) sit in shared memory and each lookup is one shared load.
// Bound on this card: bytes — 8 B read (sym, ctx) and 8 B written
// (fc_hi, fc_lo) per element against four shared loads.
// Design: a grid-stride loop over a grid of resident blocks, so each block
// loads the tables once and streams many elements, coalesced.
//
// Kernel 8 replaces rans_n4_pallas.py rans_n4_decode_pallas (pallas_call
// at :245): the v4 forward decode walk of a whole read.  The TPU kernel
// materializes each CDF row through bf16 one-hot matmuls over 6-bit
// planes (its f32 matmuls round through bf16), takes refill ranks from a
// triangular matmul, and pads the walk to 16-step tiles.  Lane k of a
// warp is rANS lane k of the read (lane k owns bytes [k*S, (k+1)*S));
// each byte step is a hi nibble step under cl, a lo nibble step under
// gl = lo_assign[cl*16 + hi], each followed by the two-round shared-
// stream refill in lane order (the host oracle kernels/rans.py
// rans_decode_o1n), then cl = cmap[byte] for active lanes.
// Bound on this card: latency.  A read is a serial chain of 2*Smax
// dependent nibble steps; its bytes (body in, lane grid out) are small.
// Chain floor (a model, PERF.md): the dependent path of one byte step in
// the SASS is, per nibble, the count (10-11 integer ops), the word load,
// the decode (3 ops) and the refill's vote, popcount, window byte and
// merge (6-7 ops): 40 integer ops, 4 shared loads, 2 votes and 2
// popcounts, about 340 cycles.
// Design: 1-8 reads (warps) a block (rans_o1_cuda.walk_reads_per_block),
// sharing one copy of the tables; every load on a step's chain is a
// shared load, issued where it stands (ld.volatile.shared):
// - Lookup.  A prep kernel in the same C entry (a block a row) writes
//   the tables once per launch into scratch the wrapper allocates, and
//   each block copies them with cp.async.  A row (ROWB bytes, H rows
//   then L rows) holds cum[1..15] as 13-bit fields two a word, at bits 0
//   and 14 (a 16th field of 0x1FFF stands for cum[16] = M), then one
//   packed word c | gl << 12 | f << 19 per symbol (gl, the L row, in H
//   rows only); a table NEXT gives, per byte and for CTX0, the H row of
//   cmap[byte].  The symbol is a count, not a search: of s in 1..15 with
//   cum[s] <= slot.  (slot + 2^13) - cum sets a field's guard bit (13 or
//   27) iff slot >= cum and never borrows from the next field, so one
//   subtract and one mask a word and a sum of the 8 words give the count
//   in halves.  No branch and no probe, the same work for every table,
//   and the count never passes 15, so every address stays in its table
//   whatever the table holds.  The order-1 walk's rank per slot pair
//   would take 2 KB a row (256 KB at r = rL = 64); Hopper's 16x2 DPX
//   max and min, which give c and the next cum with no word load, were
//   9% slower on the card (PERF.md, PR 6).  The row of the next step is
//   known early: the L row from the hi word (gl), the next H row from
//   NEXT[byte] once lo is counted, so both rows load while the current
//   nibble decodes and refills.
// - Refill.  Both rounds from one pair of ballots, the bytes from a
//   zero-filled cp.async window of the stream (htt_walk in common.cuh),
//   so no byte read is range-checked or can fault; the window is moved
//   on once a byte step.
// - Output.  A rolled loop (unrolled, with two inlined refills a step,
//   the walk ran 9% slower) shifts each step's byte into four
//   registers and stores 16 steps as one 16-byte line of the
//   lane's grid row (byte stores when the row is not 16-byte aligned,
//   and for the last steps).  Once every lane of a read is past its last
//   active step the chain stops and each lane's (now fixed) byte repeats
//   to the end of its row.

#include "common.cuh"

namespace {

constexpr int FC_T = 512;
constexpr int K = 32;
constexpr int MAX_CL = 64;
constexpr unsigned M = 4096;
constexpr int CTX0 = 256;

__global__ void __launch_bounds__(FC_T)
o1n_fc_kernel(const int* __restrict__ sym, const int* __restrict__ ctx,
              const int* __restrict__ cmap, const int* __restrict__ lo_assign,
              const int* __restrict__ fcH, const int* __restrict__ fcL, int r,
              int rL, long long n, int* __restrict__ out_h,
              int* __restrict__ out_l) {
  __shared__ int s_cmap[CTX0 + 1];
  __shared__ int s_lo[MAX_CL * 16];
  __shared__ int s_fh[MAX_CL * 16];
  __shared__ int s_fl[MAX_CL * 16];
  for (int i = threadIdx.x; i < CTX0 + 1; i += FC_T)
    s_cmap[i] = min(max(cmap[i], 0), r - 1);
  for (int i = threadIdx.x; i < r * 16; i += FC_T) {
    s_lo[i] = min(max(lo_assign[i], 0), rL - 1);
    s_fh[i] = fcH[i];
  }
  for (int i = threadIdx.x; i < rL * 16; i += FC_T) s_fl[i] = fcL[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * FC_T;
  for (long long i = static_cast<long long>(blockIdx.x) * FC_T + threadIdx.x;
       i < n; i += stride) {
    const int b = sym[i] & 255;
    const int idx = s_cmap[min(max(ctx[i], 0), CTX0)] * 16 + (b >> 4);
    out_h[i] = s_fh[idx];
    out_l[i] = s_fl[s_lo[idx] * 16 + (b & 15)];
  }
}

// ---------------------------------------------------------------------------
// kernel 8
// ---------------------------------------------------------------------------

using htt_walk::FULL;
using htt_walk::RING;
using htt_walk::Window;
using htt_walk::put_bytes;
using htt_walk::refill;
using htt_walk::ring_of;

constexpr int ROWB = 128;      // bytes a table row: cum, words, padding
constexpr int ROW_SHIFT = 7;
constexpr int NEXT = 260;      // H row offsets by byte and CTX0, padded
constexpr int MAX_RPB = 8;     // reads (warps) a block
constexpr int GROUP = 16;      // byte steps a lane packs into one store
static_assert(ROWB == 1 << ROW_SHIFT, "rows are addressed by a shift");

// bytes of the walk's tables: r H rows, rL L rows, NEXT u32
__host__ __device__ constexpr long long n4_layout_bytes(long long r,
                                                        long long rL) {
  return (r + rL) * ROWB + NEXT * 4;
}

// cum[s] of a packed fc row (s = 16 gives M)
__device__ __forceinline__ int cum_at(const int* fc, int s) {
  return s < 16 ? fc[s] >> 13 : static_cast<int>(M);
}

// One block a row (H rows first), one thread a word; the last block
// writes the NEXT offsets.
__global__ void __launch_bounds__(ROWB / 4)
n4_prep_kernel(const int* __restrict__ cmap, const int* __restrict__ lo_assign,
               const int* __restrict__ fcH, const int* __restrict__ fcL,
               int r, int rL, unsigned* __restrict__ layout) {
  const int row = blockIdx.x, q = threadIdx.x;
  if (row == r + rL) {
    for (int i = q; i < NEXT; i += ROWB / 4)
      layout[row * (ROWB / 4) + i] =
          i <= CTX0 ? min(max(cmap[i], 0), r - 1) * ROWB : 0;
    return;
  }
  const bool hrow = row < r;
  const int* fc = hrow ? fcH + row * 16 : fcL + (row - r) * 16;
  unsigned w = 0;
  if (q < 8) {  // cum[16] is stored as 0x1FFF, above every slot
    const int hi = q < 7 ? cum_at(fc, 2 * q + 2) : 0x1FFF;
    w = (cum_at(fc, 2 * q + 1) & 0x1FFFu) | ((hi & 0x1FFFu) << 14);
  } else if (q < 24) {
    const int s = q - 8;
    const int c = cum_at(fc, s), f = cum_at(fc, s + 1) - c;
    const unsigned gl =
        hrow ? min(max(lo_assign[row * 16 + s], 0), rL - 1) : 0;
    w = (c & 0xFFFu) | (gl << 12) | ((f & 0x1FFFu) << 19);
  }
  layout[row * (ROWB / 4) + q] = w;
}

// 4 x the symbol holding `slot` in a row whose cum[1..16] are (a, b), two
// 13-bit fields a word at bits 0 and 14: the count of s in 1..15 with
// cum[s] <= slot.  (slot + 2^13) - cum sets a field's guard bit (13 or
// 27) iff slot >= cum, and never borrows from the next field; the guards
// of the 8 words sum to lo * 2^13 + hi * 2^27, and a multiply by
// 1 + 2^14 moves lo + hi to bits 27-30.
__device__ __forceinline__ unsigned rank16x4(uint4 a, uint4 b, unsigned slot) {
  constexpr unsigned G = (1u << 13) | (1u << 27);
  const unsigned S = slot * 0x4001u + G;
  const unsigned s = ((S - a.x) & G) + ((S - a.y) & G) + ((S - a.z) & G)
                   + ((S - a.w) & G) + ((S - b.x) & G) + ((S - b.y) & G)
                   + ((S - b.z) & G) + ((S - b.w) & G);
  return (s * 0x4001u) >> 25;
}

__device__ __forceinline__ unsigned nib_decode(unsigned x, unsigned w) {
  return (w >> 19) * (x >> 12) + (x & 4095u) - (w & 0xFFFu);
}

// the shared address of the L row a hi word names
__device__ __forceinline__ unsigned lo_row(unsigned s_lrows, unsigned wh) {
  return s_lrows + ((wh >> (12 - ROW_SHIFT)) & (63u << ROW_SHIFT));
}

// The lane's walk state: x, its H row and that row's cum lines.
struct N4Lane {
  unsigned x, hrow;
  uint4 ha, hb;
};

// One byte step: returns the byte; active lanes advance.  At an inactive
// step both nibbles come from the same (frozen) state, as in the plain
// version.
__device__ __forceinline__ unsigned n4_step(N4Lane& st, bool active,
                                            unsigned s_lrows,
                                            unsigned s_next, Window& win,
                                            unsigned lt) {
  unsigned x = st.x;
  const unsigned hi4 = rank16x4(st.ha, st.hb, x & 4095u);
  const unsigned wh = htt_lds_u32(st.hrow + 32 + hi4);
  const unsigned lrow = lo_row(s_lrows, wh);
  const uint4 la = htt_lds_u32x4(lrow), lb = htt_lds_u32x4(lrow + 16);
  x = active ? nib_decode(x, wh) : x;
  x = refill(x, active, win, lt);
  const unsigned lo4 = rank16x4(la, lb, x & 4095u);
  const unsigned byte = hi4 * 4 + (lo4 >> 2);
  const unsigned wl = htt_lds_u32(lrow + 32 + lo4);
  const unsigned nrow = htt_lds_u32(s_next + 4 * byte);
  st.hrow = active ? nrow : st.hrow;
  st.ha = htt_lds_u32x4(st.hrow);
  st.hb = htt_lds_u32x4(st.hrow + 16);
  x = active ? nib_decode(x, wl) : x;
  st.x = refill(x, active, win, lt);
  win.keep_up();  // once a byte step: both refills move at most 128 bytes
  return byte;
}

// the byte a lane decodes at every step once it is inactive
__device__ __forceinline__ unsigned n4_frozen(const N4Lane& st,
                                              unsigned s_lrows) {
  const unsigned slot = st.x & 4095u;
  const unsigned hi4 = rank16x4(st.ha, st.hb, slot);
  const unsigned wh = htt_lds_u32(st.hrow + 32 + hi4);
  const unsigned lrow = lo_row(s_lrows, wh);
  return hi4 * 4 + (rank16x4(htt_lds_u32x4(lrow), htt_lds_u32x4(lrow + 16),
                             slot) >> 2);
}

__global__ void __launch_bounds__(K * MAX_RPB)
n4_decode_kernel(const uint8_t* __restrict__ stream, long long Mb,
                 const unsigned* __restrict__ states_in,
                 const int* __restrict__ dlen, const int* __restrict__ S_b,
                 const int* __restrict__ body_off,
                 const uint8_t* __restrict__ layout, int r, int rL,
                 long long B, int T, uint8_t* __restrict__ grid) {
  extern __shared__ __align__(16) uint8_t sm[];
  const long long lbytes = n4_layout_bytes(r, rL);
  htt_copy_to_shared(sm, layout, lbytes);
  // the NEXT offsets become shared addresses
  const unsigned s_rows = htt_shared_addr(sm);
  const unsigned s_lrows = s_rows + r * ROWB;
  const unsigned s_next = s_rows + (r + rL) * ROWB;
  unsigned* next = reinterpret_cast<unsigned*>(sm + (r + rL) * ROWB);
  for (int i = threadIdx.x; i < NEXT; i += blockDim.x) next[i] += s_rows;
  __syncthreads();

  const int w = threadIdx.x >> 5, k = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (b >= B) return;
  N4Lane st;
  st.x = states_in[b * K + k];
  st.hrow = next[CTX0];
  st.ha = htt_lds_u32x4(st.hrow);
  st.hb = htt_lds_u32x4(st.hrow + 16);
  // lane k is active at step t < n_act: t < S and k*S + t < dlen
  const long long S = S_b[b];
  const long long end = min(S, dlen[b] - static_cast<long long>(k) * S);
  const int n_act = static_cast<int>(min(max(end, 0LL),
                                         static_cast<long long>(T)));
  const int tend = __reduce_max_sync(FULL, n_act);
  Window win;
  win.start(stream + b * Mb, Mb, ring_of(sm, lbytes, w), body_off[b], k);
  uint8_t* g = grid + (b * K + k) * static_cast<long long>(T);
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const unsigned lt = htt_lanemask_lt();

  int t = 0;
  for (; t + GROUP <= tend; t += GROUP) {
    // a rolled loop (two refills a step make the unrolled one twice the
    // instruction cache); the bytes shift in from the top of v
    unsigned v[GROUP / 4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int j = 0; j < GROUP; ++j) {
      const unsigned byte = n4_step(st, t + j < n_act, s_lrows, s_next, win, lt);
      v[0] = __funnelshift_r(v[0], v[1], 8);
      v[1] = __funnelshift_r(v[1], v[2], 8);
      v[2] = __funnelshift_r(v[2], v[3], 8);
      v[3] = __funnelshift_r(v[3], byte, 8);
    }
    if (vec) *reinterpret_cast<uint4*>(g + t) = make_uint4(v[0], v[1], v[2], v[3]);
    else put_bytes(g + t, v, GROUP);
  }
  for (; t < tend; ++t)
    g[t] = static_cast<uint8_t>(
        n4_step(st, t < n_act, s_lrows, s_next, win, lt));
  if (t < T) htt_walk::fill_tail(g, t, T, n4_frozen(st, s_lrows));
  htt_cp_wait<0>();
}

}  // namespace

HTT_EXPORT int htt_o1n_fc(const void* sym, const void* ctx, const void* cmap,
                          const void* lo_assign, const void* fcH,
                          const void* fcL, long long r, long long rL,
                          long long n, void* out_h, void* out_l,
                          long long grid, void* stream) {
  if (n > 0) {
    o1n_fc_kernel<<<static_cast<unsigned>(grid), FC_T, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(sym), static_cast<const int*>(ctx),
        static_cast<const int*>(cmap), static_cast<const int*>(lo_assign),
        static_cast<const int*>(fcH), static_cast<const int*>(fcL),
        static_cast<int>(r), static_cast<int>(rL), n,
        static_cast<int*>(out_h), static_cast<int*>(out_l));
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_n4_decode(const void* stream, long long B, long long Mb,
                             const void* states_in, const void* dlen,
                             const void* S_b, const void* body_off,
                             const void* cmap, const void* lo_assign,
                             const void* fcH, const void* fcL, long long r,
                             long long rL, long long T, void* grid,
                             void* layout, long long rpb, void* cuda_stream) {
  if (B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    n4_prep_kernel<<<static_cast<unsigned>(r + rL + 1), ROWB / 4, 0, st>>>(
        static_cast<const int*>(cmap), static_cast<const int*>(lo_assign),
        static_cast<const int*>(fcH), static_cast<const int*>(fcL),
        static_cast<int>(r), static_cast<int>(rL),
        static_cast<unsigned*>(layout));
    const size_t smem = n4_layout_bytes(r, rL) + (rpb + 1) * RING;
    n4_decode_kernel<<<static_cast<unsigned>((B + rpb - 1) / rpb),
                       static_cast<unsigned>(K * rpb), smem, st>>>(
        static_cast<const uint8_t*>(stream), Mb,
        static_cast<const unsigned*>(states_in),
        static_cast<const int*>(dlen), static_cast<const int*>(S_b),
        static_cast<const int*>(body_off),
        static_cast<const uint8_t*>(layout), static_cast<int>(r),
        static_cast<int>(rL), B, static_cast<int>(T),
        static_cast<uint8_t*>(grid));
  }
  return static_cast<int>(cudaGetLastError());
}
