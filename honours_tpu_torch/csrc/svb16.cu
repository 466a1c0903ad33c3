// Kernels 5 and 6: svb16 (the VBZ container's 1-or-2-byte stream VByte)
// encode and decode.
//
// Kernel 5 replaces honours_tpu/engine/svb16_fused.py svb16_encode_fused
// (pallas_call at :153); kernel 6 replaces svb16_decode_fused (pallas_call
// at :266).  Per row of n samples (n clamped to [0, L]):
//   v[j]   = zigzag(s[j] - s[j-1]) in uint16 (s[-1] = 0), or s[j] as
//            uint16 when zd is off;
//   two[j] = v[j] >= 256;
//   stream = ceil(n/8) key bytes (bit j%8 of byte j/8 is two[j], LSB
//            first), then each sample's field: its low byte, and its high
//            byte when two[j].  Field j starts at kl + j + e(j), kl =
//            ceil(n/8), e = exclusive count of two.
// Encode writes [B, L/8 + 2L] bytes, zero past the row's length, and the
// length kl + n + ntwo.  Decode inverts it to [B, L] int16, zero past n;
// kl always comes from n, and every stream read outside the row gives 0,
// so a truncated stream decodes to garbage without faulting.
//
// The TPU kernels cannot scatter: they move every field with log-shift
// walks in VMEM, build the key bytes with a stride-8 compaction and align
// the ragged key area with 128-lane dynamic stores.  Hopper scatters and
// gathers bytes natively, so each field's offset is a block scan and one
// store or load; a warp's ballot over 32 consecutive samples is exactly
// its 4 key bytes.
// Bound on this card: bytes.  Encode reads 2 B per sample and writes
// about 1.1; decode the reverse; a few integer operations per sample.
// Design: one block per row, the row walked in chunks of PT samples with
// running carries (the count of two-byte fields, and for zd decode the
// prefix sum mod 2^16), as permute.cu's compaction does.  Key, data and
// zero-fill writes of a row go to disjoint byte ranges ([0, kl),
// [kl, len), [len, W)), so no write order between threads matters.

#include "common.cuh"

namespace {

constexpr int PT = 512;
constexpr int NW = PT / 32;

// Block-wide exclusive sum of one int per thread; *total gets the block's
// sum.  Every thread of the block must call it.
__device__ int block_excl_sum(int v, int* warp_sums, int* total_smem,
                              int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < NW ? warp_sums[lane] : 0;
    int s = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < NW) warp_sums[lane] = s - c;
    if (lane == 31) *total_smem = s;
  }
  __syncthreads();
  const int r = warp_sums[warp] + incl - v;
  *total = *total_smem;
  __syncthreads();  // warp_sums and the total are rewritten by the next call
  return r;
}

__global__ void __launch_bounds__(PT)
svb16_encode_kernel(const int16_t* __restrict__ sig,
                    const int* __restrict__ n_in, long long L, long long W,
                    int zd, uint8_t* __restrict__ out,
                    int* __restrict__ out_len) {
  __shared__ int warp_sums[NW];
  __shared__ int total_smem;
  const long long row = blockIdx.x;
  const int16_t* s = sig + row * L;
  uint8_t* o = out + row * W;
  const long long n = min(max(static_cast<long long>(n_in[row]), 0LL), L);
  const long long kl = (n + 7) >> 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < n; base += PT) {
    const long long j = base + threadIdx.x;
    const bool valid = j < n;
    unsigned v = 0;
    if (valid) {
      const unsigned u = static_cast<uint16_t>(s[j]);
      if (zd) {
        const unsigned prev = j > 0 ? static_cast<uint16_t>(s[j - 1]) : 0u;
        const unsigned d = (u - prev) & 0xFFFFu;
        v = ((d << 1) & 0xFFFFu) ^ ((d >> 15) ? 0xFFFFu : 0u);
      } else {
        v = u;
      }
    }
    const bool two = v >= 256u;
    const unsigned m = __ballot_sync(0xffffffffu, two);
    if (lane == 0) {
      const long long k0 = (base + warp * 32) >> 3;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + i < kl) o[k0 + i] = static_cast<uint8_t>(m >> (8 * i));
    }
    int ntwo;
    const int e = block_excl_sum(two ? 1 : 0, warp_sums, &total_smem, &ntwo);
    if (valid) {
      const long long off = kl + j + carry + e;
      o[off] = static_cast<uint8_t>(v);
      if (two) o[off + 1] = static_cast<uint8_t>(v >> 8);
    }
    carry += ntwo;
  }
  const long long len = kl + n + carry;
  for (long long i = len + threadIdx.x; i < W; i += PT) o[i] = 0;
  if (threadIdx.x == 0) out_len[row] = static_cast<int>(len);
}

__global__ void __launch_bounds__(PT)
svb16_decode_kernel(const uint8_t* __restrict__ stream, long long M,
                    const int* __restrict__ n_in, long long L, int zd,
                    int16_t* __restrict__ out) {
  __shared__ int warp_sums[NW];
  __shared__ int total_smem;
  const long long row = blockIdx.x;
  const uint8_t* s = stream + row * M;
  int16_t* o = out + row * L;
  const long long n = min(max(static_cast<long long>(n_in[row]), 0LL), L);
  const long long kl = (n + 7) >> 3;
  long long carry_e = 0;
  unsigned carry_s = 0;
  for (long long base = 0; base < n; base += PT) {
    const long long j = base + threadIdx.x;
    const bool valid = j < n;
    bool two = false;
    if (valid) {
      const long long p = j >> 3;
      const unsigned kb = p < M ? s[p] : 0u;
      two = (kb >> (j & 7)) & 1u;
    }
    int ntwo;
    const int e = block_excl_sum(two ? 1 : 0, warp_sums, &total_smem, &ntwo);
    unsigned v = 0;
    if (valid) {
      const long long off = kl + j + carry_e + e;
      const unsigned lo = off < M ? s[off] : 0u;
      const unsigned hi = (two && off + 1 < M) ? s[off + 1] : 0u;
      v = lo | (hi << 8);
    }
    carry_e += ntwo;
    if (zd) {
      const unsigned d = ((v >> 1) ^ ((v & 1u) ? 0xFFFFu : 0u)) & 0xFFFFu;
      int block_sum;
      const int x = block_excl_sum(static_cast<int>(d), warp_sums,
                                   &total_smem, &block_sum);
      v = (carry_s + static_cast<unsigned>(x) + d) & 0xFFFFu;
      carry_s = (carry_s + static_cast<unsigned>(block_sum)) & 0xFFFFu;
    }
    if (valid) o[j] = static_cast<int16_t>(static_cast<uint16_t>(v));
  }
  for (long long j = n + threadIdx.x; j < L; j += PT) o[j] = 0;
}

}  // namespace

HTT_EXPORT int htt_svb16_encode(const void* sig, const void* n, long long B,
                                long long L, long long W, long long zd,
                                void* out, void* out_len, void* stream) {
  if (B > 0) {
    svb16_encode_kernel<<<static_cast<unsigned>(B), PT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(sig), static_cast<const int*>(n), L, W,
        static_cast<int>(zd), static_cast<uint8_t*>(out),
        static_cast<int*>(out_len));
  }
  return static_cast<int>(cudaGetLastError());
}

HTT_EXPORT int htt_svb16_decode(const void* st, long long B, long long M,
                                const void* n, long long L, long long zd,
                                void* out, void* stream) {
  if (B > 0) {
    svb16_decode_kernel<<<static_cast<unsigned>(B), PT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(st), M, static_cast<const int*>(n), L,
        static_cast<int>(zd), static_cast<int16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
