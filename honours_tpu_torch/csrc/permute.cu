// Kernel 1: monotone row permutations (compact, compaction shifts, expand).
//
// Replaces honours_tpu/engine/permute_pallas.py `_walk` (pallas_call at
// :138; entries compact_walk :191, expand_walk :170,
// compaction_shifts_walk :214).  The TPU has no fast scatter, so the
// Pallas kernel moves every element by log2(N) masked rolls inside VMEM.
// Hopper scatters natively: a compaction is an exclusive scan of `keep`
// plus one scatter, an expansion is one scatter.
//
// Bound on this card: bytes.  Each element is read once and each output
// written once (one u8 or i32 payload plus a one-byte mask), a few
// integer operations per element — far below the operation roofline.
// Design: one block per row, the row walked in chunks of PT elements; a
// block-wide exclusive scan (warp ballots + popcounts, then one warp
// scanning the per-warp counts) gives each kept element its rank, and a
// running carry joins the chunks, so rows of any width (2^21 columns and
// more) need no device-wide scan.  Reads are coalesced; scattered writes
// land in order, so neighbouring threads still write neighbouring bytes.
// Rows are independent blocks, so a batch of B rows fills the card when
// B is a few hundred.

#include "common.cuh"

namespace {

constexpr int PT = 512;
constexpr int NW = PT / 32;

// SHIFTS: write holes-before-element (j - rank) instead of the payload.
template <typename T, bool SHIFTS>
__global__ void __launch_bounds__(PT)
compact_kernel(const T* __restrict__ v, const uint8_t* __restrict__ keep,
               T* __restrict__ out, int* __restrict__ count, long long N) {
  __shared__ int warp_off[NW];
  __shared__ int chunk_total;
  const long long row = blockIdx.x;
  const uint8_t* kr = keep + row * N;
  T* orow = out + row * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < N; base += PT) {
    const long long j = base + threadIdx.x;
    const bool k = j < N && kr[j] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_off[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int c = lane < NW ? warp_off[lane] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane < NW) warp_off[lane] = incl - c;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (k) {
      const long long r = carry + warp_off[warp] + __popc(m & htt_lanemask_lt());
      if constexpr (SHIFTS) {
        orow[r] = static_cast<T>(j - r);
      } else {
        orow[r] = v[row * N + j];
      }
    }
    carry += chunk_total;
    __syncthreads();  // warp_off and chunk_total are rewritten next chunk
  }
  for (long long j = carry + threadIdx.x; j < N; j += PT) orow[j] = 0;
  if (threadIdx.x == 0) count[row] = static_cast<int>(carry);
}

// out[j + shift[j]] = v[j] for valid j (targets strictly increasing);
// every other column 0, covered marks the written columns.  Targets
// outside [0, W) are dropped.
template <typename T>
__global__ void __launch_bounds__(PT)
expand_kernel(const T* __restrict__ v, const int* __restrict__ shift,
              const uint8_t* __restrict__ valid, T* __restrict__ out,
              uint8_t* __restrict__ covered, long long N, long long W) {
  const long long row = blockIdx.x;
  T* orow = out + row * W;
  uint8_t* crow = covered + row * W;
  for (long long j = threadIdx.x; j < W; j += PT) {
    orow[j] = 0;
    crow[j] = 0;
  }
  __syncthreads();
  for (long long j = threadIdx.x; j < N; j += PT) {
    if (valid[row * N + j]) {
      const long long t = j + shift[row * N + j];
      if (t >= 0 && t < W) {
        orow[t] = v[row * N + j];
        crow[t] = 1;
      }
    }
  }
}

template <typename T, bool SHIFTS>
int launch_compact(const void* v, const void* keep, void* out, void* count,
                   long long B, long long N, void* stream) {
  if (B > 0) {
    compact_kernel<T, SHIFTS><<<static_cast<unsigned>(B), PT, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const uint8_t*>(keep),
        static_cast<T*>(out), static_cast<int*>(count), N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_expand(const void* v, const void* shift, const void* valid,
                  void* out, void* covered, long long B, long long N,
                  long long W, void* stream) {
  if (B > 0) {
    expand_kernel<T><<<static_cast<unsigned>(B), PT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const int*>(shift),
        static_cast<const uint8_t*>(valid), static_cast<T*>(out),
        static_cast<uint8_t*>(covered), N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

HTT_EXPORT int htt_compact_u8(const void* v, const void* keep, void* out,
                              void* count, long long B, long long N,
                              void* stream) {
  return launch_compact<uint8_t, false>(v, keep, out, count, B, N, stream);
}

HTT_EXPORT int htt_compact_i32(const void* v, const void* keep, void* out,
                               void* count, long long B, long long N,
                               void* stream) {
  return launch_compact<int, false>(v, keep, out, count, B, N, stream);
}

HTT_EXPORT int htt_compaction_shifts(const void* keep, void* out, void* count,
                                     long long B, long long N, void* stream) {
  return launch_compact<int, true>(nullptr, keep, out, count, B, N, stream);
}

HTT_EXPORT int htt_expand_u8(const void* v, const void* shift,
                             const void* valid, void* out, void* covered,
                             long long B, long long N, long long W,
                             void* stream) {
  return launch_expand<uint8_t>(v, shift, valid, out, covered, B, N, W, stream);
}

HTT_EXPORT int htt_expand_i32(const void* v, const void* shift,
                              const void* valid, void* out, void* covered,
                              long long B, long long N, long long W,
                              void* stream) {
  return launch_expand<int>(v, shift, valid, out, covered, B, N, W, stream);
}
