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
// base-4096 long division) because the TPU has no integer divide; here
// the division is plain 32-bit unsigned / and %.
// Bound on this card: latency.  Per read the work is a serial chain of
// Smax dependent steps (a 32-bit division each); bytes moved (4 B in,
// 2 B out per candidate) are small.
// Design: one warp per read and one read per block, lane k = rANS lane
// k, so each step's fc load and plane stores are one coalesced 128 B /
// 64 B transaction per warp; the loop is unrolled so loads of later steps
// issue ahead of the dependent division chain.

#include "common.cuh"

namespace {

constexpr int K = 32;
constexpr unsigned RANS_L = 1u << 23;

__global__ void __launch_bounds__(K)
encode_kernel(const int* __restrict__ fc, long long Smax,
              uint8_t* __restrict__ cand, uint8_t* __restrict__ keep,
              unsigned* __restrict__ states) {
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const int* fr = fc + b * Smax * K;
  uint8_t* cr = cand + b * Smax * 2 * K;
  uint8_t* kr = keep + b * Smax * 2 * K;
  unsigned x = RANS_L;
#pragma unroll 4
  for (long long t = Smax - 1; t >= 0; --t) {
    const int v = fr[t * K + k];
    const bool active = v > 0;
    const unsigned f = active ? static_cast<unsigned>(v & 8191) : 1u;
    const unsigned c = active ? static_cast<unsigned>(v >> 13) : 0u;
    const unsigned b1 = x & 0xFFu;
    const bool over1 = active && (x >> 19) >= f;
    if (over1) x >>= 8;
    const unsigned b2 = x & 0xFFu;
    const bool over2 = active && (x >> 19) >= f;
    if (over2) x >>= 8;
    if (active) x = ((x / f) << 12) + x % f + c;
    cr[t * 2 * K + k] = static_cast<uint8_t>(over2 ? b2 : b1);
    kr[t * 2 * K + k] = over1;
    cr[t * 2 * K + K + k] = static_cast<uint8_t>(b1);
    kr[t * 2 * K + K + k] = over2;
  }
  states[b * K + k] = x;
}

}  // namespace

HTT_EXPORT int htt_rans_encode(const void* fc, long long B, long long Smax,
                               void* cand, void* keep, void* states,
                               void* stream) {
  if (B > 0) {
    encode_kernel<<<static_cast<unsigned>(B), K, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(fc), Smax, static_cast<uint8_t*>(cand),
        static_cast<uint8_t*>(keep), static_cast<unsigned*>(states));
  }
  return static_cast<int>(cudaGetLastError());
}
