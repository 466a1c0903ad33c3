// Kernel H: the per-read Huffman table of huffman_vb*_zd, built from each
// row's byte histogram.
//
// No TPU kernel stands behind it: honours_tpu builds the table on the
// host, in Python (honours_tpu/tables/huffman.py:55 build_table, the
// reference's calculate_huffman_codes, press/huffman/huffman.c:373-424),
// and this is its counterpart on the card, code for code.  The tree: the
// present symbols in symbol order, sorted stably by count; each round
// takes the two lowest (the first taken is the zero branch) and puts the
// merged node before every item of equal count (the reference puts it
// first and sorts stably again).  Codes: a node's depth is its code's
// length, and bit `depth` of the code is set on its one branch; a lone
// symbol gets length 0.  Nodes are made in increasing order and a parent
// after its children, so one pass over them from the root down assigns
// every code.
//
// Bound on this card: one row's rounds are a serial chain (P - 1 merges,
// each an insertion into a sorted list of at most 256 items), the bytes
// (2 KiB of counts in, 3 KiB of table out a row) are small beside it.
// Design: one thread a row, a warp a block; the sorted list, the
// children and the internal nodes' codes in the thread's local memory.
// Output ownership: thread b writes row b of lengths and codes, every
// present symbol's entry (the wrapper zeroes them first).

#include "common.cuh"

namespace {

constexpr int SYMS = 256;

__global__ void __launch_bounds__(32)
    huffman_build_kernel(const long long* __restrict__ hist, long long B,
                         int* __restrict__ lengths,
                         long long* __restrict__ codes) {
  const long long b = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  if (b >= B) return;
  long long cnt[SYMS];
  short id[SYMS];
  short zero[SYMS - 1], one[SYMS - 1];
  unsigned char dep[SYMS - 1];
  unsigned long long code[SYMS - 1];
  const long long* h = hist + b * SYMS;
  // the leaves in symbol order, sorted stably by count (insertion sort)
  int P = 0;
  for (int s = 0; s < SYMS; ++s) {
    const long long c = h[s];
    if (c <= 0) continue;
    int p = P++;
    for (; p > 0 && cnt[p - 1] > c; --p) {
      cnt[p] = cnt[p - 1];
      id[p] = id[p - 1];
    }
    cnt[p] = c;
    id[p] = static_cast<short>(s);
  }
  int* len = lengths + b * SYMS;
  long long* out = codes + b * SYMS;
  if (P <= 1) return;  // no symbol, or a lone one: length 0, code 0
  // merges: items [lo, P) hold the sorted list
  int lo = 0;
  for (int r = 0; r < P - 1; ++r) {
    const long long c = cnt[lo] + cnt[lo + 1];
    zero[r] = id[lo];
    one[r] = id[lo + 1];
    lo += 2;
    int p = lo;
    for (; p < P && cnt[p] < c; ++p) {  // before the first count >= c
      cnt[p - 1] = cnt[p];
      id[p - 1] = id[p];
    }
    cnt[p - 1] = c;
    id[p - 1] = static_cast<short>(SYMS + r);
    lo -= 1;
  }
  // codes, from the root (the last node made) down
  dep[P - 2] = 0;
  code[P - 2] = 0;
  for (int r = P - 2; r >= 0; --r) {
    const unsigned d = dep[r];
    const unsigned long long c = code[r];
    const unsigned long long bit = d < 63 ? 1ull << d : 0ull;
    const int kids[2] = {zero[r], one[r]};
    const unsigned long long kc[2] = {c, c | bit};
    for (int k = 0; k < 2; ++k) {
      const int x = kids[k];
      if (x >= SYMS) {
        dep[x - SYMS] = static_cast<unsigned char>(d + 1);
        code[x - SYMS] = kc[k];
      } else {
        len[x] = static_cast<int>(d + 1);
        out[x] = static_cast<long long>(kc[k]);
      }
    }
  }
}

}  // namespace

HTT_EXPORT int htt_huffman_build(const void* hist, long long B, void* lengths,
                                 void* codes, void* cuda_stream) {
  if (B > 0)
    huffman_build_kernel<<<static_cast<unsigned>((B + 31) / 32), 32, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const long long*>(hist), B, static_cast<int*>(lengths),
        static_cast<long long*>(codes));
  return static_cast<int>(cudaGetLastError());
}
