// Kernels 2 and 4: order-1 rANS table lookup and decode walk.
//
// Kernel 2 replaces honours_tpu/engine/rans_o1_pallas.py
// o1_fc_gather_pallas (pallas_call at :147).  Per element it returns
// fc = fc_tab[cmap[ctx]][sym] (f + cum_lo * 8192) for ctx in [0, 256]
// (256 = CTX0).  The TPU kernel emulates the gather with predicated
// single-vreg gathers over 128 table chunks; here the table (<= 64
// clusters x 256 int32 = 64 KiB) and cmap sit in shared memory and each
// thread does two shared-memory loads.
// Bound on this card: bytes — 12 B of device memory per element (sym and
// ctx read, fc written) against two shared loads and a few integer ops.
// Design: a grid-stride loop over a grid sized to the resident blocks
// (three 66 KB blocks per SM), so each block loads the table once and
// then streams many elements with coalesced reads and writes.
//
// Kernel 4 replaces rans_o1_pallas.py `_decode_call` (pallas_call at
// :447) as launched through rans_o1_decode_resume_pallas (:530): the
// forward order-1 decode walk over global steps [step_lo, step_hi) of
// each read.  The TPU kernel materializes every cluster CDF row through
// bf16 one-hot matmuls and takes the shared-stream refill ranks from a
// triangular matmul; here lane k of a warp is rANS lane k of the read,
// the cluster CDFs live in shared memory as uint16 [r, 257], the symbol
// comes from an 8-step binary search, and refill ranks come from
// __ballot_sync plus __popc(mask & lanemask_lt), in two rounds.
// Bound on this card: latency.  The bytes (stream in, lane grid out) are
// a few hundred KB per read, but every step depends on the previous
// state, so one read is a serial chain of Smax steps; the bound recorded
// for it (bytes over bandwidth) is far below what a serial chain allows.
// Design: one warp per read, one read per block (so B blocks spread over
// the SMs), every body read clamped to the row so a stream decoded with
// the wrong group runs to garbage without faulting.

#include "common.cuh"

namespace {

constexpr int FC_T = 512;
constexpr int K = 32;
constexpr int MAX_CL = 64;
constexpr unsigned RANS_L = 1u << 23;
constexpr int CTX0 = 256;

__global__ void __launch_bounds__(FC_T)
o1_fc_kernel(const int* __restrict__ sym, const int* __restrict__ ctx,
             const int* __restrict__ cmap, const int* __restrict__ fc_tab,
             int r, long long n, int* __restrict__ out) {
  extern __shared__ int sm[];
  int* s_cmap = sm;
  int* s_fc = sm + 260;
  for (int i = threadIdx.x; i < CTX0 + 1; i += FC_T)
    s_cmap[i] = min(max(cmap[i], 0), r - 1);
  for (int i = threadIdx.x; i < r * 256; i += FC_T) s_fc[i] = fc_tab[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * FC_T;
  for (long long i = static_cast<long long>(blockIdx.x) * FC_T + threadIdx.x;
       i < n; i += stride) {
    const int c = min(max(ctx[i], 0), CTX0);
    out[i] = s_fc[s_cmap[c] * 256 + (sym[i] & 255)];
  }
}

__global__ void __launch_bounds__(K)
o1_decode_kernel(const uint8_t* __restrict__ stream, long long Mb,
                 const unsigned* __restrict__ states_in,
                 const int* __restrict__ dlen, const int* __restrict__ S_b,
                 const int* __restrict__ step_lo,
                 const int* __restrict__ step_hi,
                 const int* __restrict__ init_cl,
                 const int* __restrict__ body_off,
                 const int* __restrict__ cmap, const int* __restrict__ cum,
                 int r, int T, uint8_t* __restrict__ grid,
                 unsigned* __restrict__ states_out, int* __restrict__ ptr_out) {
  __shared__ unsigned short s_cum[MAX_CL * 257];
  __shared__ int s_cmap[CTX0 + 1];
  const int k = threadIdx.x;
  for (int i = k; i < r * 257; i += K) s_cum[i] = static_cast<unsigned short>(cum[i]);
  for (int i = k; i < CTX0 + 1; i += K) s_cmap[i] = min(max(cmap[i], 0), r - 1);
  __syncthreads();

  const long long b = blockIdx.x;
  const uint8_t* row = stream + b * Mb;
  uint8_t* g = grid + (b * K + k) * static_cast<long long>(T);
  unsigned x = states_in[b * K + k];
  int cl = min(max(init_cl[b * K + k], 0), r - 1);
  const long long S = S_b[b], lo = step_lo[b], hi = step_hi[b], dl = dlen[b];
  const long long lane_base = static_cast<long long>(k) * S;
  long long ptr = body_off[b];
  const unsigned lt = htt_lanemask_lt();

  for (int i = 0; i < T; ++i) {
    const long long u = lo + i;
    const bool active = u < hi && lane_base + u < dl;
    const unsigned slot = x & 4095u;
    const unsigned short* cr = s_cum + cl * 257;
    int a = 0, z = 256;  // largest s with cr[s] <= slot (cr[256] = 4096)
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int m = (a + z) >> 1;
      if (cr[m] <= slot) a = m; else z = m;
    }
    g[i] = static_cast<uint8_t>(a);
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
    if (active) cl = s_cmap[a];
  }
  states_out[b * K + k] = x;
  if (k == 0) ptr_out[b] = static_cast<int>(ptr);
}

}  // namespace

HTT_EXPORT int htt_o1_fc(const void* sym, const void* ctx, const void* cmap,
                         const void* fc_tab, long long r, long long n,
                         void* out, long long grid, void* stream) {
  const size_t smem = (260 + r * 256) * sizeof(int);
  cudaFuncSetAttribute(o1_fc_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  if (n > 0) {
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
                             void* cuda_stream) {
  if (B > 0) {
    o1_decode_kernel<<<static_cast<unsigned>(B), K, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), Mb,
        static_cast<const unsigned*>(states_in),
        static_cast<const int*>(dlen), static_cast<const int*>(S_b),
        static_cast<const int*>(step_lo), static_cast<const int*>(step_hi),
        static_cast<const int*>(init_cl), static_cast<const int*>(body_off),
        static_cast<const int*>(cmap), static_cast<const int*>(cum),
        static_cast<int>(r), static_cast<int>(T),
        static_cast<uint8_t*>(grid), static_cast<unsigned*>(states_out),
        static_cast<int*>(ptr_out));
  }
  return static_cast<int>(cudaGetLastError());
}
