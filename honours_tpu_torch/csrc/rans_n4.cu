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
// triangular matmul, and pads the walk to 16-step tiles.  Here lane k of
// a warp is rANS lane k of the read (lane k owns bytes [k*S, (k+1)*S)),
// the H and L CDFs sit in shared memory as uint16 [r, 17] (cum[16] = M),
// each nibble is a 4-step binary search, and each step's two-round
// shared-stream refill takes its ranks from __ballot_sync plus
// __popc(mask & lanemask_lt): round 2 sees the states after round 1, in
// lane order, as the host oracle kernels/rans.py rans_decode_o1n does.
// Bound on this card: latency.  A read is a serial chain of 2*Smax
// dependent steps; its bytes (body in, lane grid out) are small.
// Design: one warp per read, one read per block, every body read clamped
// to the row so a damaged stream decodes to garbage without faulting.

#include "common.cuh"

namespace {

constexpr int FC_T = 512;
constexpr int K = 32;
constexpr int MAX_CL = 64;
constexpr unsigned RANS_L = 1u << 23;
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

// One 16-symbol decode step of lane state x against CDF row cr[0..16]:
// returns the symbol; active lanes advance x and refill it from the
// shared stream (two rounds, ranks in lane order).
__device__ __forceinline__ int n4_step(unsigned& x,
                                       const unsigned short* cr,
                                       bool active, long long& ptr,
                                       const uint8_t* row, long long Mb,
                                       unsigned lt) {
  const unsigned slot = x & (M - 1);
  int a = 0, z = 16;  // largest s with cr[s] <= slot (cr[16] = M)
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int m = (a + z) >> 1;
    if (cr[m] <= slot) a = m; else z = m;
  }
  if (active) {
    const unsigned c = cr[a];
    x = (cr[a + 1] - c) * (x >> 12) + slot - c;
  }
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const bool need = active && x < RANS_L;
    const unsigned mask = __ballot_sync(0xffffffffu, need);
    if (need) {
      const long long p = ptr + __popc(mask & lt);
      const unsigned byte = (p >= 0 && p < Mb) ? row[p] : 0u;
      x = (x << 8) | byte;
    }
    ptr += __popc(mask);
  }
  return a;
}

__global__ void __launch_bounds__(K)
n4_decode_kernel(const uint8_t* __restrict__ stream, long long Mb,
                 const unsigned* __restrict__ states_in,
                 const int* __restrict__ dlen, const int* __restrict__ S_b,
                 const int* __restrict__ body_off,
                 const int* __restrict__ cmap,
                 const int* __restrict__ lo_assign,
                 const int* __restrict__ fcH, const int* __restrict__ fcL,
                 int r, int rL, int T, uint8_t* __restrict__ grid) {
  __shared__ unsigned short s_ch[MAX_CL * 17];
  __shared__ unsigned short s_cl[MAX_CL * 17];
  __shared__ int s_cmap[CTX0 + 1];
  __shared__ int s_lo[MAX_CL * 16];
  const int k = threadIdx.x;
  for (int i = k; i < r * 17; i += K) {
    const int s = i % 17;
    s_ch[i] = s < 16 ? static_cast<unsigned short>(fcH[(i / 17) * 16 + s] >> 13)
                     : static_cast<unsigned short>(M);
  }
  for (int i = k; i < rL * 17; i += K) {
    const int s = i % 17;
    s_cl[i] = s < 16 ? static_cast<unsigned short>(fcL[(i / 17) * 16 + s] >> 13)
                     : static_cast<unsigned short>(M);
  }
  for (int i = k; i < CTX0 + 1; i += K) s_cmap[i] = min(max(cmap[i], 0), r - 1);
  for (int i = k; i < r * 16; i += K) s_lo[i] = min(max(lo_assign[i], 0), rL - 1);
  __syncthreads();

  const long long b = blockIdx.x;
  const uint8_t* row = stream + b * Mb;
  uint8_t* g = grid + (b * K + k) * static_cast<long long>(T);
  unsigned x = states_in[b * K + k];
  int cl = s_cmap[CTX0];
  const long long S = S_b[b], dl = dlen[b];
  const long long lane_base = static_cast<long long>(k) * S;
  long long ptr = body_off[b];
  const unsigned lt = htt_lanemask_lt();

  for (int t = 0; t < T; ++t) {
    const bool active = t < S && lane_base + t < dl;
    const int hi = n4_step(x, s_ch + cl * 17, active, ptr, row, Mb, lt);
    const int gl = s_lo[cl * 16 + hi];
    const int lo = n4_step(x, s_cl + gl * 17, active, ptr, row, Mb, lt);
    const int byte = hi * 16 + lo;
    g[t] = static_cast<uint8_t>(byte);
    if (active) cl = s_cmap[byte];
  }
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
                             void* cuda_stream) {
  if (B > 0) {
    n4_decode_kernel<<<static_cast<unsigned>(B), K, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), Mb,
        static_cast<const unsigned*>(states_in),
        static_cast<const int*>(dlen), static_cast<const int*>(S_b),
        static_cast<const int*>(body_off), static_cast<const int*>(cmap),
        static_cast<const int*>(lo_assign), static_cast<const int*>(fcH),
        static_cast<const int*>(fcL), static_cast<int>(r),
        static_cast<int>(rL), static_cast<int>(T),
        static_cast<uint8_t*>(grid));
  }
  return static_cast<int>(cudaGetLastError());
}
