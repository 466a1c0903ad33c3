// Kernel H: the per-read Huffman table of huffman_vb*_zd, built from each
// row's byte histogram.
//
// No TPU kernel stands behind it: honours_tpu builds the table on the
// host, in Python (honours_tpu/tables/huffman.py:55 build_table, the
// reference's calculate_huffman_codes, press/huffman/huffman.c:373-424),
// and this is its counterpart on the card, code for code.  The tree: the
// present symbols in symbol order, sorted stably by count; each round
// takes the two lowest (the first taken is the zero branch), puts the
// merged node first and sorts stably again.  So among equal counts the
// internal nodes come before the leaves, the newest internal node first.
// Codes: a node's depth is its code's length, and bit `depth` of the code
// is set on its one branch below a node at that depth (bits from 63 on
// are dropped); a lone symbol gets length 0.
//
// Design: a block of 256 threads a row, thread s for symbol s, the row's
// state in shared memory (about 12 KiB).
//   1. Sort: thread s ranks its symbol among the present ones, #{t : c_t <
//      c_s, or c_t = c_s and t < s}, and places its leaf there.
//   2. Merge, on thread 0, in O(P) steps: two queues, the sorted leaves
//      and the internal nodes in the order they were made (merged counts
//      never fall, so that order is sorted).  An internal node is taken
//      when its count is at most the next leaf's.  A run of internal nodes
//      of one count c is taken from its newest end, its extent fixed when
//      its first node is taken: every node made after that holds c plus a
//      positive count, more than c, while nodes made before it from
//      smaller items may still join the run.  (tests/test_torch_huffbuild.py
//      holds a model of this walk to build_table.)
//   3. Codes: pointer jumping over the 2P - 1 nodes, every thread two
//      nodes: a node's hop to its ancestor carries the hop's edges and
//      their branch bits, placed from the ancestor's depth; joining two
//      hops shifts the lower one's bits by the upper one's edges.  After
//      ceil(log2(P - 1)) rounds every hop ends at the root: the node's
//      depth and code.
//   4. Thread s writes entry s of the row's lengths and codes, 0 for an
//      absent symbol and for a row of at most one symbol (coalesced).
//
// Bound on this card: the merge chain, P - 1 merges on one thread (about
// 60 dependent cycles a merge: two shared loads and a compare a take),
// beside the sort's 256 shared loads a thread and 8 jumping rounds of two
// barriers; the bytes (2 KiB of counts in, 3 KiB of table out a row) are
// small beside it.  A row is one block, so 256 rows run at once over the
// card's 132 SMs.
//
// Output ownership: block b writes row b of lengths and codes, every
// entry, thread s entry s.

#include "common.cuh"

namespace {

constexpr int SYMS = 256;
constexpr int NODES = 2 * SYMS - 1;  // leaves 0-255, node r at SYMS + r

__global__ void __launch_bounds__(SYMS)
    huffman_build_kernel(const long long* __restrict__ hist,
                         int* __restrict__ lengths,
                         long long* __restrict__ codes) {
  __shared__ long long cnt[SYMS];        // the row's counts, by symbol
  __shared__ long long leaf[SYMS];       // the present leaves, sorted
  __shared__ short leaf_id[SYMS];
  __shared__ long long node[SYMS - 1];   // internal nodes, in order made
  __shared__ short anc[NODES];           // a node's hop: its end,
  __shared__ short edges[NODES];         // its edges,
  __shared__ unsigned long long bits[NODES];  // their branch bits
  const int s = threadIdx.x;
  const long long b = blockIdx.x;
  const long long c = hist[b * SYMS + s];
  cnt[s] = c;
  const int P = __syncthreads_count(c > 0);
  int* len = lengths + b * SYMS;
  long long* out = codes + b * SYMS;
  if (P <= 1) {  // no symbol, or a lone one: length 0, code 0
    len[s] = 0;
    out[s] = 0;
    return;
  }

  // 1. the leaves, sorted stably by count
  if (c > 0) {
    int rank = 0;
    for (int t = 0; t < SYMS; ++t) {
      const long long u = cnt[t];
      rank += u > 0 && (u < c || (u == c && t < s));
    }
    leaf[rank] = c;
    leaf_id[rank] = static_cast<short>(s);
  }
  for (int x = s; x < NODES; x += SYMS) {  // every node its own root
    anc[x] = static_cast<short>(x);
    edges[x] = 0;
    bits[x] = 0;
  }
  __syncthreads();

  // 2. the merges: leaves [li, P) and internal nodes [head, made) untaken;
  // a run being taken holds [head, cur] and ends at run_end
  if (s == 0) {
    int li = 0, head = 0, cur = -1, run_end = -1;
    for (int made = 0; made < P - 1; ++made) {
      long long sum = 0;
      for (int q = 0; q < 2; ++q) {
        int x;
        if (head < made && (li >= P || node[head] <= leaf[li])) {
          if (cur < 0) {  // the run's first take fixes its extent
            const long long run = node[head];
            run_end = head;
            while (run_end + 1 < made && node[run_end + 1] == run) ++run_end;
            cur = run_end;
          }
          sum += node[cur];
          x = SYMS + cur;
          if (--cur < head) {
            head = run_end + 1;
            cur = -1;
          }
        } else {
          sum += leaf[li];
          x = leaf_id[li++];
        }
        anc[x] = static_cast<short>(SYMS + made);
        edges[x] = 1;
        bits[x] = static_cast<unsigned long long>(q);
      }
      node[made] = sum;
    }
  }
  __syncthreads();

  // 3. pointer jumping: hop x -> a, then a -> anc[a]; the lower hop's bits
  // sit below the upper hop's edges
  for (int span = 1; span < P - 1; span <<= 1) {
    int na[2], ne[2];
    unsigned long long nb[2];
    for (int i = 0; i < 2; ++i) {
      const int x = s + i * SYMS;
      if (x >= NODES) break;
      const int a = anc[x];
      const int up = edges[a];
      na[i] = anc[a];
      ne[i] = edges[x] + up;
      nb[i] = bits[a] | (up < 64 ? bits[x] << up : 0ull);
    }
    __syncthreads();
    for (int i = 0; i < 2; ++i) {
      const int x = s + i * SYMS;
      if (x >= NODES) break;
      anc[x] = static_cast<short>(na[i]);
      edges[x] = static_cast<short>(ne[i]);
      bits[x] = nb[i];
    }
    __syncthreads();
  }

  // 4. the row's table
  len[s] = c > 0 ? edges[s] : 0;
  out[s] = c > 0 ? static_cast<long long>(bits[s] & ~(1ull << 63)) : 0;
}

}  // namespace

HTT_EXPORT int htt_huffman_build(const void* hist, long long B, void* lengths,
                                 void* codes, void* cuda_stream) {
  if (B > 0)
    huffman_build_kernel<<<static_cast<unsigned>(B), SYMS, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const long long*>(hist), static_cast<int*>(lengths),
        static_cast<long long*>(codes));
  return static_cast<int>(cudaGetLastError());
}
