// Kernel L: uint_zsm's running mean, one read a thread.
//
// No TPU kernel stands behind it: honours_tpu takes the mean on the host
// only (honours_tpu/codecs/uintc.py:128 UintZsmCodec._mean16, the
// reference's get_mean_16, press/util.c:74-88), and this is its
// counterpart on the card, bit for bit: mean = 0.0, then mean += (x_i -
// mean) / (i + 1) in float64 for i = 0 .. n - 1, then truncation toward
// zero.  That recurrence is not sum / n (it drifts from it on long reads)
// and it is not associative, so a read stays one dependent chain.  Its
// subtract, divide and add are written __dsub_rn / __ddiv_rn / __dadd_rn,
// which nvcc never contracts into a fused multiply-add, so each rounds
// as the host's does.
//
// Bound on this card: the chain, n_max dependent (subtract, divide, add)
// steps in fp64, the divide by far the longest; the bytes (2 B a sample
// read once) are small beside it.
// Design: one thread a read, a warp a block (so a bucket's reads spread
// over the SMs), its samples read in order (a 128-byte line serves 64
// steps).  Row b's mean is written to out[b]; n is clamped to
// [0, L] and an empty read gives 0.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(32)
    zsm_mean_kernel(const int16_t* __restrict__ sig, long long B, long long L,
                    const int* __restrict__ n, long long* __restrict__ out) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const long long m = min(max(static_cast<long long>(n[b]), 0LL), L);
  const int16_t* row = sig + b * L;
  double mean = 0.0;
  for (long long i = 0; i < m; ++i) {
    const double x = static_cast<double>(row[i]);
    mean = __dadd_rn(mean, __ddiv_rn(__dsub_rn(x, mean),
                                     static_cast<double>(i + 1)));
  }
  out[b] = static_cast<long long>(mean);  // C's cast: toward zero
}

}  // namespace

HTT_EXPORT int htt_zsm_mean(const void* sig, long long B, long long L,
                            const void* n, void* out, void* cuda_stream) {
  if (B > 0)
    zsm_mean_kernel<<<static_cast<unsigned>((B + 31) / 32), 32, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int16_t*>(sig), B, L, static_cast<const int*>(n),
        static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
