"""Kernel K's DP step (csrc/flats.cu flats_partition_kernel), checked on
the CPU: a numpy model of its work (partition_model: the pre-pass's
chunk (min, max) from the aligned 16-byte words of a row at any address
mod 16; index i owned by thread i % T in slot i / T, which keeps the
range of chunks i..j-1 and best[i] + 3; rounds of D steps j..j+D-1, each
first over every index below j from the slots: each thread's running
(cost, i) a step with a strict < over its ascending i, a warp's two
minima (the least cost, then the least i among the lanes holding it)
and, in a block of more than one warp, the same pair over the warps'
pairs; then the round's steps in order on every thread alike, each also
over the round's indices before it (the tail), whose best + 3 and ranges
then enter their owners' slots; 32-bit costs, a segment's bytes from a
64-bit product; the prev chain walked from m by jumps of 2 and 4)
gives the cuts of the
plain version (engine/flats.py flats_partition_plain) and of the JAX
package's host partition (honours_tpu/codecs/flats.py partition_flats),
at every design the kernel can launch (read from its entry) and at the
one the entry picks. Reads: raw_rows.flats_reads at steps 64, 8 and
17, the tie read and reads of many ties. Also the entry's designs, the
wrapper's scratch (flats_cuda.in_scratch) and its u32 bound
(flats_cuda.cost_fits_u32). No JAX is imported."""

import numpy as np
import pytest
import torch

import raw_rows
from honours_tpu.codecs.flats import partition_flats
from honours_tpu_torch.engine import flats_cuda
from honours_tpu_torch.engine.flats import chunks, flats_partition_plain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

#: (threads, register slots, steps a round) of every launch (slots 0:
#: the memory design)
DESIGNS = [tuple(d[1:]) for d in raw_rows.flats_designs()]
NONE = (1 << 32) - 1  # no candidate
WARP = 32
BITS = np.array([x.bit_length() for x in range(1 << 16)], np.int64)


def chunk_minmax(u, lo: int, hi: int, addr: int, stats: dict):
    """The pre-pass's (min, max) of samples [lo, hi) (lo < hi) of a row
    whose sample 0 sits at byte address addr, read as the aligned 16-byte
    words that hold them, each word's samples outside [lo, hi) masked."""
    first, end = addr + 2 * lo, addr + 2 * hi
    mn, mx = 0xFFFF, 0
    a = first & ~15
    while a < end:
        assert a + 16 > first  # every word holds a sample of the chunk
        p0 = (a - first) >> 1
        for h in range(8):
            if 0 <= p0 + h < hi - lo:
                x = int(u[lo + p0 + h])
                mn, mx = min(mn, x), max(mx, x)
        stats["words"] = stats.get("words", 0) + 1
        a += 16
    return mn, mx


def seg(length, bits):
    """A segment's bytes as the kernel forms them: length (a u32, wrapped
    where the index is not live, read as an int32) times the range's top
    bit f = bits - 1 (-1 for a range of 0) plus length + 7, in 64 bits,
    over 8."""
    length = np.asarray(length) & NONE
    signed = np.where(length >= 1 << 31, length - (1 << 32), length)
    return (signed * (np.asarray(bits) - 1) + length + 7) >> 3


def partition_model(u, n: int, step: int, T: int, K: int, D: int,
                    addr: int = 0, stats=None):
    """Kernel K's block of T threads (K register slots a thread, 0: the
    memory design; rounds of D steps) on one read, u its samples as
    uint16, n of them valid, sample 0 at byte address addr: the sorted
    boundary indices 0..m it sets to 1 in cut."""
    st = stats if stats is not None else {}
    m = -(-n // step) if n else 0

    slots = K or max(1, -(-m // T))
    assert K == 0 or m <= T * K
    cm = [chunk_minmax(u, c * step, min(c * step + step, n), addr, st)
          for c in range(m)]
    mn = np.full((T, slots), 0xFFFF, np.int64)
    mx = np.zeros((T, slots), np.int64)
    bb = np.zeros((T, slots), np.int64)
    bb[0, 0] = 3  # index 0 enters: best[0] = 0
    i_of = np.arange(T)[:, None] + T * np.arange(slots)[None, :]
    lanes = np.arange(T)
    prev = [0] * (m + 1)
    j = 1
    while j <= m:
        nd = min(D, m + 1 - j)
        cn = [cm[j - 1 + d][0] if d < nd else 0xFFFF for d in range(D)]
        cx = [cm[j - 1 + d][1] if d < nd else 0 for d in range(D)]
        bj = [(j + d) * step if j + d < m else n for d in range(D)]
        act = i_of < j  # the slots' indices below j
        # a warp enters slot k where any lane of it holds one
        entered = (np.arange(slots)[None, :] * T
                   + WARP * np.arange(T // WARP)[:, None]) < j
        assert np.array_equal(entered, act.reshape(T // WARP, WARP,
                                                   slots).any(axis=1))
        st["warp_slots"] = st.get("warp_slots", 0) + int(entered.sum())
        st["rounds"] = st.get("rounds", 0) + 1
        lo, hi = mn.copy(), mx.copy()
        red = []
        for d in range(D):
            lo, hi = np.minimum(lo, cn[d]), np.maximum(hi, cx[d])
            e = bb + seg(bj[d] - i_of * step, BITS[hi - lo])
            assert (e[act] < NONE).all()  # 32-bit costs
            e = np.where(act, e, NONE)
            # each thread over its ascending slots, strict <: the first
            # minimum
            k = np.argmin(e, axis=1)
            tc = e[lanes, k]
            ti = np.where(tc < NONE, i_of[lanes, k], NONE)
            # a warp's two minima, then (several warps) the warps' pairs'
            tc, ti = tc.reshape(-1, WARP), ti.reshape(-1, WARP)
            wc = tc.min(axis=1)
            wi = np.where(tc == wc[:, None], ti, NONE).min(axis=1)
            bc = int(wc.min())
            red.append((bc, int(np.where(wc == bc, wi, NONE).min())))
        mn, mx = np.where(act, lo, mn), np.where(act, hi, mx)
        # the round's own indices: j + e at step j + d spans chunks j + e
        # .. j + d - 1, its bytes known before any best; (tmn, tmx)[e] end
        # as the range of chunks j + e .. j + nd - 2
        tseg = {}
        tmn, tmx = [0xFFFF] * D, [0] * D
        for e in range(D):
            for d in range(e + 1, D):
                tmn[e], tmx[e] = min(tmn[e], cn[d]), max(tmx[e], cx[d])
                tseg[e, d] = int(seg(bj[d] - (j + e) * step,
                                     BITS[tmx[e] - tmn[e]]))
        # the tail: the round's steps in order, each also over the round's
        # indices before it (the later, so a strict <)
        tb3 = []
        for d in range(nd):
            bc, bi = red[d]
            assert bi < j
            for e in range(d):
                ce = tb3[e] + tseg[e, d]
                st["tail"] = st.get("tail", 0) + 1
                if ce < bc:
                    bc, bi = ce, j + e
            tb3.append(bc + 3)
            prev[j + d] = bi
        # the round's indices enter their owners' slots
        for t in range(T):
            q = (t - j) & (T - 1)
            if q < nd:
                i = j + q
                assert i % T == t
                bb[t, i // T], mn[t, i // T], mx[t, i // T] = (
                    tb3[q], tmn[q], tmx[q])
        j += nd
    # the walk: jumps of 2 and 4 (prev[0] = 0 stops them at 0), four cuts
    # a load of the chain
    j2 = [prev[prev[k]] for k in range(m + 1)]
    j4 = [j2[j2[k]] for k in range(m + 1)]
    cuts, k = {m}, m
    while k:
        cuts |= {prev[k], j2[k], prev[j2[k]], j4[k]}
        k = j4[k]
    return sorted(cuts)


def _cut_indices(cut_row, m: int):
    return [int(k) for k in np.nonzero(cut_row[: m + 1].numpy())[0]]


def _check(reads, step: int, designs=None):
    """The model at each design (the wrapper's pick for the batch too),
    each read at another address mod 16, = the plain version's cuts =
    partition_flats' boundaries."""
    sig, n = raw_rows.pad_rows(reads)
    L = sig.shape[1]
    cut = flats_partition_plain(torch.from_numpy(sig), torch.from_numpy(n),
                                step)
    stats = {}
    picked = raw_rows.flats_design(chunks(L, step))
    for r, read in enumerate(reads):
        u = read.view(np.uint16)
        m = -(-read.size // step)
        want = _cut_indices(cut[r], m)
        host = partition_flats(u, step) if read.size else [0]
        assert [min(k * step, read.size) for k in want] == host, r
        for T, K, D in {picked, *(designs or DESIGNS)}:
            if K and m > T * K:
                continue
            got = partition_model(u, read.size, step, T, K, D, 2 * (r % 8),
                                  stats)
            assert got == want, (r, T, K, D)
    return stats


@pytest.mark.parametrize("step", [64, 8, 17])
def test_model_on_flats_reads(step):
    """raw_rows.flats_reads (empty, one and two samples, a flat run, the
    tie read repeated, flat levels, a small alphabet, a walk, full-range
    noise, a length no multiple of 64) at every design."""
    stats = _check(raw_rows.flats_reads(step), step)
    assert stats["words"] and stats["warp_slots"] and stats["tail"]


def test_model_tie_takes_the_least_i():
    """The tie read: one segment and the split at 8 both cost 7 bytes;
    every design keeps one segment."""
    read, step = raw_rows.tie_read()
    for T, K, D in DESIGNS:
        assert partition_model(read.view(np.uint16), read.size, step, T,
                               K, D) == [0, 2]
    _check([read], step)


@pytest.mark.parametrize("seed", range(3))
def test_model_on_reads_of_many_ties(seed):
    """Reads whose chunks tie over and over: alphabets of 1, 2 and 3
    values, runs of a value the length of a chunk, the tie read with a
    chunk's worth of noise between copies, at steps 8 and 4."""
    rng = np.random.default_rng(seed)
    tie, _ = raw_rows.tie_read()
    reads = [rng.integers(0, 2, 900), rng.integers(5, 8, 640),
             np.full(333, 3), np.repeat(rng.integers(0, 2, 120), 8),
             np.concatenate([np.concatenate([tie, rng.integers(0, 4, 8)])
                             for _ in range(20)])]
    reads = [np.asarray(r, np.int16) for r in reads]
    for step in (8, 4):
        _check(reads, step)


def test_designs_and_state_bytes():
    """The entry tries its designs by ascending chunks, the last taking
    every m; the design it picks for every m holds its read where it keeps
    it in registers (m <= threads x slots); a register design's state (4
    B an index of the chunks, prev and the walk's jumps) fits SMEM_MAX,
    and the wrapper allocates scratch exactly where the memory design's
    (the chunks, prev, the ranges and best + 3) passes it."""
    table = raw_rows.flats_designs()
    limits = [most for most, *_ in table]
    assert limits[-1] is None and table[-1][2] == 0
    assert limits[:-1] == sorted(limits[:-1])
    for m in [0, 1, 31, 32, 33, 1023, 1024, 1025, 4095, 4096, 4097, 12799,
              12800, 65536]:
        T, K, D = raw_rows.flats_design(m)
        assert (T, K, D) in DESIGNS and T % WARP == 0 and D <= T
        if K:
            assert m <= T * K and 12 * (m + 1) <= flats_cuda.SMEM_MAX
        assert flats_cuda.in_scratch(m) == (
            8 * (2 * m + 1) > flats_cuda.SMEM_MAX)
    assert raw_rows.flats_design(1024)[1]
    assert not flats_cuda.in_scratch(12799) and flats_cuda.in_scratch(12800)


def test_cost_fits_u32():
    """The wrapper's bound: 2 L + 3 (m + 1) < 2^32 with m = ceil(L /
    step), at the largest L that fits and one past it for steps 1, 64
    and 2^20; where it holds, the largest cost the kernel can form (2 n
    + 6, then + 3 as best + 3) stays below its no-candidate value
    2^32 - 1."""
    for step in (1, 64, 1 << 20):
        lo, hi = 1, 1 << 32  # the largest L that fits, by bisection
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if 2 * mid + 3 * (-(-mid // step) + 1) < 1 << 32:
                lo = mid
            else:
                hi = mid
        assert flats_cuda.cost_fits_u32(lo, step)
        assert not flats_cuda.cost_fits_u32(lo + 1, step)
        m = -(-lo // step)
        worst = (2 * lo + 6 if m > 1 else 3 + 2 * lo) + 3
        assert worst < NONE, step
    assert flats_cuda.cost_fits_u32(1 << 22, 64)

