// Kernel A: the stall segmenter, the first stall segment of each read.
//
// No TPU kernel stands behind it: it replaces the lax.scan of
// honours_tpu/segment/__init__.py find_stall_batch (:38-137), and its
// contract is the C oracle honours_tpu/native/segment.c ht_find_stall
// (:26-129) bit for bit in (exists, start, length), except that start and
// length are int32 as in the scan (the C truncates both to uint16).
// Per read of n samples (n clamped to [0, L]; n = 0 gives no segment):
// clamp each sample to [0, 1200]; mean = (serial float32 sum) / (float)n;
// sd = sqrtf((serial float32 sum of (a - mean)^2) / (float)n);
// top = mean + sd * 0.75f, bot = mean - sd * 0.75f; then the run state
// machine of segment.c:73-120 over the samples with bot < a < top in band.
//
// Rounding.  The C rounds every product and sum on its own (x86-64
// baseline, no FMA), in sample order.  nvcc contracts a * b + c into an
// FMA by default, so every operation of the two sums and of the
// thresholds is written with the _rn intrinsics, which are never
// contracted; division and square root are the IEEE ones.
//
// Bound on this card: latency.  A read is three serial passes, two of
// them a dependent float32 add chain (4 cycles an add) and the third a
// state machine with a few dependent integer steps a sample; its bytes
// (2 per sample, read three times from L2 or L1) are small.
// Design: one thread per read and a block each, so no two reads share a
// warp and the data-dependent steps of one never wait on another's.
// Samples come 64 at a time, the next 64 loaded before the current ones
// are used: in 16-byte loads where the rows allow it (the wrapper passes
// vec = 1 when the base is 16-byte aligned and L % 8 == 0), else one at
// a time.  The third pass turns each 64 samples into an in-band bit mask
// and steps the state machine a run of equal bits at a time: an in-band
// run adds its length to count and w, an out-of-band run outside a
// segment changes nothing, one inside a segment is tolerated up to the
// error budget and then ends the segment.  That is the C's transitions
// summed over the run as long as no sample of the run can meet the
// window decrement (count >= w before an in-band sample, count + 1 >= w
// before a tolerated one; the C's parameters never reach it: count
// exceeds the run's in-band samples by at most 5, w them by at least
// 50); where one could, the run goes a sample at a time, as does the
// tail of a row past its last whole 64.

#include "common.cuh"

namespace {

constexpr int CHUNK = 64;  // samples a thread loads at once
constexpr float CLAMP_MAX = 1200.0f;
constexpr float CLAMP_MIN = 0.0f;
constexpr float STD_SCALE = 0.75f;
constexpr int CORRECTOR = 50;
constexpr int SEG_DIST = 50;
constexpr int WINDOW = 150;
constexpr float STALL_LEN = 0.25f;
constexpr int MAX_ERR = 5;

__device__ __forceinline__ float clamp_sample(int s) {
  float v = static_cast<float>(s);
  if (v > CLAMP_MAX)
    v = CLAMP_MAX;
  else if (v < CLAMP_MIN)
    v = CLAMP_MIN;
  return v;
}

// Sample j of a chunk held as 32 words of two samples, clamped.
__device__ __forceinline__ float chunk_sample(const unsigned (&w)[CHUNK / 2],
                                              int j) {
  return clamp_sample(static_cast<int16_t>(w[j >> 1] >> (16 * (j & 1))));
}

// The 64 samples of a row from `base` as 32 words: eight 16-byte loads
// (VEC) or 64 two-byte loads.
template <bool VEC>
__device__ __forceinline__ void load_chunk(const int16_t* row, long long base,
                                           unsigned (&w)[CHUNK / 2]) {
  if (VEC) {
    const int4* p = reinterpret_cast<const int4*>(row + base);
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j) {
      const int4 v = __ldg(p + j);
      w[4 * j] = static_cast<unsigned>(v.x);
      w[4 * j + 1] = static_cast<unsigned>(v.y);
      w[4 * j + 2] = static_cast<unsigned>(v.z);
      w[4 * j + 3] = static_cast<unsigned>(v.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CHUNK / 2; ++j)
      w[j] = static_cast<uint16_t>(__ldg(row + base + 2 * j)) |
             static_cast<unsigned>(static_cast<uint16_t>(
                 __ldg(row + base + 2 * j + 1))) << 16;
  }
}

// The samples i < n of a row in order: chunk(base, words) for each whole
// chunk of 64 (the next chunk's loads issued before the current one is
// used), then sample(i, a) one at a time for the rest, a the clamped
// value.
template <bool VEC, typename C, typename S>
__device__ __forceinline__ void walk(const int16_t* row, long long n,
                                     C&& chunk, S&& sample) {
  const long long chunks = n / CHUNK;
  unsigned next[CHUNK / 2];
  if (chunks > 0) load_chunk<VEC>(row, 0, next);
  for (long long c = 0; c < chunks; ++c) {
    unsigned w[CHUNK / 2];
#pragma unroll
    for (int j = 0; j < CHUNK / 2; ++j) w[j] = next[j];
    if (c + 1 < chunks) load_chunk<VEC>(row, (c + 1) * CHUNK, next);
    chunk(c * CHUNK, w);
  }
#pragma unroll 1
  for (long long i = chunks * CHUNK; i < n; ++i)
    sample(i, clamp_sample(__ldg(row + i)));
}

// segment.c:64-120: count in-band samples, tolerate short excursions,
// emit or merge segments.  Positions fit in int (rows < 2^31 samples).
struct Runs {
  int inseg = 0, err = 0, run_err = 0, count = 0, w = CORRECTOR;
  int seg_start = 0, nsegs = 0, first_x = 0, first_y = 0, last_y = 0;

  // segment.c:100-119: the run ends at out-of-band sample i
  __device__ __forceinline__ void end(int i) {
    if (count >= WINDOW ||
        (!nsegs && static_cast<float>(count) >= WINDOW * STALL_LEN)) {
      const int seg_end = i - run_err;
      if (nsegs && seg_start - last_y < SEG_DIST) {
        last_y = seg_end;  // merge into the previous (last) segment
        if (nsegs == 1) first_y = seg_end;
      } else {
        nsegs++;
        last_y = seg_end;
        if (nsegs == 1) {
          first_x = seg_start;
          first_y = seg_end;
        }
      }
    }
    inseg = 0;
    count = 0;
    err = 0;
    run_err = 0;
  }

  // One sample, segment.c:73-120 as written.
  __device__ __forceinline__ void step(int i, bool inb) {
    if (inb) {
      if (!inseg) {
        seg_start = i;
        inseg = 1;
      }
      count++;
      w++;
      run_err = 0;
      if (count >= WINDOW && count >= w && !(count % w)) err--;
    } else if (inseg && err < MAX_ERR) {
      count++;
      err++;
      run_err++;
      if (count >= WINDOW && count >= w && !(count % w)) err--;
    } else if (inseg) {
      end(i);
    }
  }

  // `len` <= 64 samples from `base`, bit j of `mask` the in-band flag of
  // sample base + j, a run of equal bits at a time.
  __device__ __forceinline__ void steps(int base, unsigned long long mask,
                                        int len) {
    int j = 0;
#pragma unroll 1
    while (j < len) {
      const unsigned long long rest = mask >> j;
      const bool inb = rest & 1;
      int r = inb ? (~rest ? __ffsll(static_cast<long long>(~rest)) - 1 : 64)
                  : (rest ? __ffsll(static_cast<long long>(rest)) - 1 : 64);
      r = min(r, len - j);
      if (!inb && !inseg) {
        j += r;  // nothing happens outside a segment
      } else if (inb ? count >= w : count + r >= w) {
        for (int e = j + r; j < e; ++j) step(base + j, inb);
      } else if (inb) {
        if (!inseg) {
          seg_start = base + j;
          inseg = 1;
        }
        count += r;
        w += r;
        run_err = 0;
        j += r;
      } else {
        const int t = min(r, MAX_ERR - err);  // tolerated excursions
        count += t;
        err += t;
        run_err += t;
        if (t < r) end(base + j + t);
        j += r;
      }
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(1)
    find_stall_kernel(const int16_t* __restrict__ sig,
                      const int* __restrict__ n_rows, long long L,
                      uint8_t* __restrict__ exists,
                      int* __restrict__ start, int* __restrict__ length) {
  const long long b = blockIdx.x;
  long long n = n_rows[b];
  n = n < 0 ? 0 : (n > L ? L : n);
  const int16_t* row = sig + b * L;
  Runs r;
  if (n > 0) {
    const float nf = static_cast<float>(n);
    float sum = 0.0f;
    auto add = [&](long long, float a) { sum = __fadd_rn(sum, a); };
    walk<VEC>(
        row, n,
        [&](long long, const unsigned (&w)[CHUNK / 2]) {
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) add(j, chunk_sample(w, j));
        },
        add);
    const float mean = __fdiv_rn(sum, nf);
    sum = 0.0f;
    auto add_sq = [&](long long, float a) {
      const float d = __fsub_rn(a, mean);
      sum = __fadd_rn(sum, __fmul_rn(d, d));
    };
    walk<VEC>(
        row, n,
        [&](long long, const unsigned (&w)[CHUNK / 2]) {
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) add_sq(j, chunk_sample(w, j));
        },
        add_sq);
    const float sd = __fsqrt_rn(__fdiv_rn(sum, nf));
    const float top = __fadd_rn(mean, __fmul_rn(sd, STD_SCALE));
    const float bot = __fsub_rn(mean, __fmul_rn(sd, STD_SCALE));
    walk<VEC>(
        row, n,
        [&](long long base, const unsigned (&w)[CHUNK / 2]) {
          unsigned long long mask = 0;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {
            const float a = chunk_sample(w, j);
            mask |= static_cast<unsigned long long>(a < top && a > bot) << j;
          }
          r.steps(static_cast<int>(base), mask, CHUNK);
        },
        [&](long long i, float a) {
          r.step(static_cast<int>(i), a < top && a > bot);
        });
  }
  exists[b] = r.nsegs > 0;
  start[b] = r.nsegs > 0 ? r.first_x : 0;
  length[b] = r.nsegs > 0 ? r.first_y - r.first_x + 1 : 0;
}

}  // namespace

HTT_EXPORT int htt_find_stall(const void* sig, const void* n, long long B,
                              long long L, long long vec, void* exists,
                              void* start, void* length, void* stream) {
  if (B > 0) {
    const unsigned grid = static_cast<unsigned>(B);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* s = static_cast<const int16_t*>(sig);
    const auto* nr = static_cast<const int*>(n);
    auto* ex = static_cast<uint8_t*>(exists);
    auto* so = static_cast<int*>(start);
    auto* lo = static_cast<int*>(length);
    if (vec)
      find_stall_kernel<true><<<grid, 1, 0, st>>>(s, nr, L, ex, so, lo);
    else
      find_stall_kernel<false><<<grid, 1, 0, st>>>(s, nr, L, ex, so, lo);
  }
  return static_cast<int>(cudaGetLastError());
}
