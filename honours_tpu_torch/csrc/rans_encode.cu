// Kernel 3: the rANS encode state walk (formats v3 and v5).
//
// Replaces honours_tpu/engine/rans_encode_pallas.py
// rans_encode_core_pallas (pallas_call at :118).  Input fc [B, Smax*32]
// int32, step-major (column t*32 + lane), f + cum*8192 for active
// elements and 0 for inactive ones.  Walking t = Smax-1 .. 0, each active
// lane emits up to two bytes while (x >> 19) >= f, then sets
// x = ((x / f) << 12) + x % f + c.  Outputs: the candidate byte plane
// cand [B, Smax*64] u8 with its keep mask [B, Smax*64] (column t*64 + j:
// j < 32 holds round 1 of lane j, j >= 32 round 2 of lane j-32) and the
// final states [B, 32].  The TPU kernel divides in exact f32 (two-step
// base-4096 long division) because the TPU has no integer divide.
// Bound on this card: bytes over the whole batch (4 B of fc in, 4 B of
// cand and keep out per element), but one read is a serial chain of Smax
// dependent steps.  Chain floor (a model, PERF.md): the state's path
// through a step in the SASS is about 8 dependent integer ops (compare,
// select of the renormalised state, multiply-high, shift, mask,
// multiply-add), about 36 cycles.
// Design: one warp per read, lane k = rANS lane k, 1-8 reads (warps) a
// block.
// - The fc plane (larger than L2 at the bucket shape) streams through a
//   ring of STAGES chunks of CH steps per read in shared memory, filled
//   from the end of the row by cp.async (16 bytes a copy when fc is
//   16-byte aligned, else 4), so three chunks (12 KB) are in flight
//   while the walk reads the fourth.
// - The walk holds a chunk's 32 fc values and their reciprocals in
//   registers and runs its 32 steps unrolled and without a branch.  x / f
//   is a multiply-high by a reciprocal and a shift (ryg's rans_byte.h
//   rcp_freq / rcp_shift: exact for x < 2^31, f in [2, 4096]); f = 1 is
//   x itself; an inactive step takes f = 4096, c = 0, which leaves x as
//   it is.  The reciprocals are a constant of the format, built once per
//   device by the wrapper (rans_encode_cuda.reciprocals) and copied into
//   shared memory by each block.  x % f folds into one multiply-add:
//   x' = x + q * (4096 - f) + c.  A valid table (f >= 1, f + c <= 4096)
//   keeps x below 2^31; from a chunk with any other step on, and in the
//   row's partial last chunk, the walk divides in hardware, so it is
//   exact on any input.
// - Round 2's test reads the state before round 1 (x >> 27), so both
//   rounds resolve at once.
// - A chunk in which no lane is active leaves x as it is and only writes
//   its bytes, so a read's chain is its own length, not Smax.
// Each step's plane stores are one coalesced 32-byte store per warp each.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K = 32;
constexpr unsigned RANS_L = 1u << 23;
constexpr unsigned FMAX = 4096;
constexpr int CH = 32;           // steps a chunk
constexpr int STAGES = 4;        // chunks a read's ring holds
constexpr int RCP_WORDS = 4100;  // reciprocals of f in [0, 4096], padded
constexpr int MAX_RPB = 8;
constexpr int RING_BYTES = STAGES * CH * K * 4;
constexpr int SMEM_MAX = RCP_WORDS * 4 + MAX_RPB * RING_BYTES;

// chunk c of a read's fc row (steps [c*CH, min(c*CH + CH, Smax))) into
// its stage; one commit group per call, empty when c < 0
template <int VB>
__device__ __forceinline__ void fc_fill(int* stage, const int* fr,
                                        long long c, long long Smax, int k) {
  if (c >= 0) {
    constexpr int E = VB / 4;  // ints a copy
    const long long t0 = c * CH;
    const int n = static_cast<int>(min(static_cast<long long>(CH), Smax - t0)) * K;
    const int* src = fr + t0 * K;
    for (int i = k * E; i < n; i += K * E) {
      const unsigned a = htt_shared_addr(stage + i);
      if (VB == 16) htt_cp_async16(a, src + i);
      else htt_cp_async4(a, src + i);
    }
  }
  htt_cp_commit();
}

// bytes of step t of lane k: round 1's candidate and keep at t*2K + k,
// round 2's at t*2K + K + k
__device__ __forceinline__ void put_step(uint8_t* cr, uint8_t* kr, long long o,
                                         unsigned b1, unsigned b2, bool over1,
                                         bool over2) {
  cr[o] = static_cast<uint8_t>(over2 ? b2 : b1);
  kr[o] = over1;
  cr[o + K] = static_cast<uint8_t>(b1);
  kr[o + K] = over2;
}

// One step with the hardware division: exact for any input.
__device__ __forceinline__ unsigned div_step(unsigned x, int v, uint8_t* cr,
                                             uint8_t* kr, long long o) {
  const bool active = v > 0;
  const unsigned f = active ? static_cast<unsigned>(v) & 8191u : 1u;
  const bool over1 = active && (x >> 19) >= f;
  const bool over2 = over1 && (x >> 27) >= f;
  put_step(cr, kr, o, x & 0xFFu, (x >> 8) & 0xFFu, over1, over2);
  const unsigned xs = over2 ? x >> 16 : over1 ? x >> 8 : x;
  if (!active) return x;
  const unsigned q = xs / f;
  return xs + q * (FMAX - f) + (static_cast<unsigned>(v) >> 13);
}

// One step of a valid table (x < 2^31, f + c <= M, so x stays below
// 2^31): x / f by the reciprocal, with no branch.  An inactive step
// takes f = M, c = 0, which leaves x as it is.
__device__ __forceinline__ unsigned rcp_step(unsigned x, int v, unsigned rcp,
                                             uint8_t* cr, uint8_t* kr,
                                             long long o) {
  const bool active = v > 0;
  const unsigned f = active ? static_cast<unsigned>(v) & 8191u : FMAX;
  const unsigned c = active ? static_cast<unsigned>(v) >> 13 : 0u;
  const bool over1 = active && x >= (f << 19);
  const bool over2 = active && (x >> 27) >= f;  // implies over1
  put_step(cr, kr, o, x & 0xFFu, (x >> 8) & 0xFFu, over1, over2);
  const unsigned xs = over2 ? x >> 16 : over1 ? x >> 8 : x;
  // rcp[1] = 0, so f = 1 takes xs through the mask
  const unsigned sh = (31 - __clz(f - 1)) & 31;
  const unsigned q = (__umulhi(xs, rcp) >> sh) | (xs & (f == 1 ? FULL : 0u));
  return xs + q * (FMAX - f) + c;  // (q << 12) + xs % f + c
}

template <int VB>
__global__ void __launch_bounds__(K * MAX_RPB)
encode_kernel(const int* __restrict__ fc, long long B, long long Smax,
              const unsigned* __restrict__ rcp, uint8_t* __restrict__ cand,
              uint8_t* __restrict__ keep, unsigned* __restrict__ states) {
  extern __shared__ __align__(16) uint8_t sm[];
  const unsigned* s_rcp = reinterpret_cast<const unsigned*>(sm);
  const int w = threadIdx.x >> 5, k = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + w;
  int* ring = reinterpret_cast<int*>(sm + RCP_WORDS * 4) + w * STAGES * CH * K;
  const int* fr = fc + b * Smax * K;
  const long long nch = (Smax + CH - 1) / CH;
  if (b < B) {
    for (int q = 0; q < STAGES; ++q) {
      const long long c = nch - 1 - q;
      fc_fill<VB>(ring + (c & (STAGES - 1)) * CH * K, fr, c, Smax, k);
    }
  }
  htt_copy_to_shared(sm, rcp, RCP_WORDS * 4);
  if (b >= B) return;

  uint8_t* cr = cand + b * Smax * 2 * K + k;
  uint8_t* kr = keep + b * Smax * 2 * K + k;
  unsigned x = RANS_L;
  bool exact = false;  // a step outside the valid tables was met
  for (long long c = nch - 1; c >= 0; --c) {
    htt_cp_wait<STAGES - 1>();
    __syncwarp();
    const int* st = ring + (c & (STAGES - 1)) * CH * K + k;
    const long long t0 = c * CH;
    const int n = static_cast<int>(min(static_cast<long long>(CH), Smax - t0));
    uint8_t* cc = cr + t0 * 2 * K;
    uint8_t* kc = kr + t0 * 2 * K;
    if (n == CH) {
      int v[CH];
      bool any = false, bad = false;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        v[j] = st[j * K];
        const unsigned f = static_cast<unsigned>(v[j]) & 8191u;
        const unsigned cm = static_cast<unsigned>(v[j]) >> 13;
        any |= v[j] > 0;
        bad |= v[j] > 0 && (f == 0 || f + cm > FMAX);
      }
      exact |= __any_sync(FULL, bad);
      if (!__any_sync(FULL, any)) {  // no lane active: x stays
#pragma unroll
        for (int j = CH - 1; j >= 0; --j)
          put_step(cc, kc, j * 2 * K, x & 0xFFu, 0, false, false);
      } else if (!exact) {
        unsigned rc[CH];  // all loaded before the walk needs the first
#pragma unroll
        for (int j = 0; j < CH; ++j)
          rc[j] = htt_lds_u32(htt_shared_addr(s_rcp + (v[j] > 0 ? v[j] & 8191 : FMAX)));
#pragma unroll
        for (int j = CH - 1; j >= 0; --j)
          x = rcp_step(x, v[j], rc[j], cc, kc, j * 2 * K);
      } else {
        for (int j = CH - 1; j >= 0; --j)
          x = div_step(x, st[j * K], cc, kc, j * 2 * K);
      }
    } else {  // the row's last, partial chunk
      for (int j = n - 1; j >= 0; --j)
        x = div_step(x, st[j * K], cc, kc, j * 2 * K);
    }
    __syncwarp();
    fc_fill<VB>(ring + (c & (STAGES - 1)) * CH * K, fr, c - STAGES, Smax, k);
  }
  htt_cp_wait<0>();
  states[b * K + k] = x;
}

}  // namespace

HTT_EXPORT int htt_rans_encode(const void* fc, long long B, long long Smax,
                               void* cand, void* keep, void* states,
                               const void* rcp, long long rpb, void* stream) {
  static bool smem16[64], smem4[64];
  htt_smem_limit_once(encode_kernel<16>, SMEM_MAX, smem16);
  htt_smem_limit_once(encode_kernel<4>, SMEM_MAX, smem4);
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>((B + rpb - 1) / rpb);
    const unsigned threads = static_cast<unsigned>(K * rpb);
    const size_t smem = RCP_WORDS * 4 + rpb * RING_BYTES;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto kern = (reinterpret_cast<uintptr_t>(fc) & 15) == 0
                    ? encode_kernel<16> : encode_kernel<4>;
    kern<<<grid, threads, smem, st>>>(
        static_cast<const int*>(fc), B, Smax,
        static_cast<const unsigned*>(rcp), static_cast<uint8_t*>(cand),
        static_cast<uint8_t*>(keep), static_cast<unsigned*>(states));
  }
  return static_cast<int>(cudaGetLastError());
}
