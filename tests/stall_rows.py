"""Rows for kernel A (the stall segmenter, csrc/segment.cu), and a numpy
model of the kernel's phases at its own constants (segment_cuda.THREADS,
CHUNK, TILE, GROUP, GUESS).  Imports only numpy, torch and the port, so
tests/test_torch_segment_model.py and tests/test_torch_segment.py (CPU,
beside the JAX package), tests/test_torch_gpu.py (the card, no JAX) and
chip_smoke.py (the model's host counts) all use it.

A row is an int16 array: its length is its n.  Rows built around the
in-band band put in-band runs of 460 +- 4 on a background of alternating
extremes (0-59 and 1100-1199), which is out of band: such a row's mean
is near 590 and its sd near 550, so the band holds 460 and no extreme
(`test_torch_segment_model.py` checks the masks)."""

import functools
from pathlib import Path

import numpy as np

from honours_tpu_torch.segment import segment_cuda as S

THREADS, CHUNK, TILE, GROUP, GUESS = (S.THREADS, S.CHUNK, S.TILE, S.GROUP,
                                      S.GUESS)
MAX_ERR, WINDOW, STALL_LEN, SEG_DIST = 5, 150, 0.25, 50


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def crossing_row(k: int, m: int, extra: int, seed: int) -> np.ndarray:
    """A row whose exact sum of its first m samples is 2^k: values near
    2^k / m (pairs of +-d, d < 20, keep the sum), then `extra` samples
    in [900, 1200)."""
    rng = np.random.default_rng(seed)
    base, r = divmod(1 << k, m)
    x = np.full(m, base, np.int64)
    x[:r] += 1
    d = rng.integers(0, 20, m // 2)
    x[0: 2 * (m // 2): 2] += d
    x[1: 2 * (m // 2): 2] -= d
    assert x.sum() == 1 << k and x.min() >= 0 and x.max() <= 1200
    return np.concatenate([x, rng.integers(900, 1200, extra)]).astype(
        np.int16)


def _ends(k: int):
    """(chunk end, tile end) of the first ends past which 2^k / m <= 1175
    (the chunk end not a tile end)."""
    lo = -(-(1 << k) // 1175)
    c = -(-lo // CHUNK) * CHUNK
    if c % TILE == 0:
        c += CHUNK
    return c, -(-lo // TILE) * TILE


def crossing_rows():
    """Exact sums crossing 2^24 .. 2^29 at a chunk end, at a tile end,
    and one sample beside each (k = 24, 26, 29)."""
    out = []
    for k in range(24, 30):
        c, t = _ends(k)
        ms = [("chunk", c), ("tile", t)]
        if k in (24, 26, 29):
            ms += [("chunk+1", c + 1), ("tile-1", t - 1)]
        for where, m in ms:
            out.append((f"sum_2^{k}_at_{where}",
                        crossing_row(k, m, 2 * CHUNK + 7, k * 10 + len(out))))
    return out


def _background(rng, m: int) -> np.ndarray:
    x = np.empty(m, np.int64)
    x[0::2] = rng.integers(0, 60, x[0::2].size)
    x[1::2] = rng.integers(1100, 1200, x[1::2].size)
    return x


def band_row(m: int, runs, seed: int = 0) -> np.ndarray:
    """m samples of alternating extremes with in-band runs: `runs` holds
    (start, length, oob offsets): samples start..start+length-1 at 460 +-
    4 except the offsets (from start), left out of band."""
    rng = np.random.default_rng(seed)
    x = _background(rng, m)
    for s, ln, holes in runs:
        x[s: s + ln] = 460 + rng.integers(-4, 5, ln)
        for h in holes:
            x[s + h] = 1150 if (s + h) % 2 else 20
    return x.astype(np.int16)


def edge_rows():
    """Attempts whose 6th out-of-band sample falls on a chunk end, one
    sample before or after, a tile end; attempts with excursions inside;
    attempts open across a tile end, and across a whole tile."""
    out = []
    for name, end in (("chunk", 7 * CHUNK), ("tile", TILE)):
        for d in (-1, 0, 1):
            e = end + d  # the 6th out-of-band sample after the run's start
            runs = [(e - 5 - 300, 300, ())]  # 5 tolerated, then e
            out.append((f"6th_oob_at_{name}{d:+d}",
                        band_row(end + 3 * CHUNK, runs, seed=len(out))))
        e = end
        # five excursions inside, the last the run's last sample: e is
        # the 6th
        runs = [(e - 200, 200, (3, 50, 120, 170, 199))]
        out.append((f"excursions_to_{name}", band_row(end + 700, runs, 9)))
    runs = [(TILE - 100, 300, (10, 20, 30)), (TILE + 2000, 40, ())]
    out.append(("open_across_tile_end", band_row(TILE + 4000, runs, 3)))
    runs = [(TILE - 5000, 2 * TILE + 9000, (7, 70000, 100000, 130000))]
    out.append(("open_across_a_whole_tile",
                band_row(3 * TILE + 5000, runs, 4)))
    # counts 37 (no segment) then 38 (the first): count = run + 5
    runs = [(CHUNK * 9 + 17, 37 - 5, ()), (CHUNK * 30, 38 - 5, ())]
    out.append(("counts_37_then_38", band_row(CHUNK * 40, runs, 5)))
    return out


def merge_rows():
    """A second segment 49 samples after the first's end (merges), and 50
    (does not); results fixed at nsegs == 2 before later segments."""
    out = []
    for gap in (49, 50):
        # first: run [1000, 1200) ends at its 6th out-of-band sample 1205,
        # seg_end 1200; second starts at 1200 + gap
        runs = [(1000, 200, ()), (1200 + gap, 200, ())]
        out.append((f"second_at_{gap}", band_row(4000, runs, gap)))
    runs = [(500, 200, ()), (1500, 200, ()), (1740, 300, ()),
            (TILE + 100, 900, ())]
    out.append(("fixed_at_two_then_merge", band_row(TILE + 2000, runs, 6)))
    runs = [(500, 100, ()), (640, 200, ()), (3000, 45, ()),
            (5000, 300, ()), (5330, 300, ())]
    out.append(("merge_then_short_then_two", band_row(8000, runs, 7)))
    runs = [(300, 60, ()), (400, 200, ()), (CHUNK * 3 - 20, 40, ()),
            (CHUNK * 8, 200, ()), (TILE + 5, 400, ())]
    out.append(("short_first_grows_by_merge",
                band_row(TILE + 3000, runs, 8)))
    return out


def sum_rows():
    """Ties (odd samples at u = 2, samples 2 mod 4 at u = 4), all-1200
    (ties at u = 32: 1200 / 32 = 37.5) and all-0 rows."""
    rng = np.random.default_rng(11)
    return [
        ("odd_ties_u2", (rng.integers(500, 600, 30000) * 2 + 1)),
        ("ties_u4", (rng.integers(250, 300, 60000) * 4 + 2)),
        ("all_1200", np.full(300000, 1200)),
        ("all_0", np.zeros(2 * TILE + 37)),
    ]


def length_rows():
    """n = 0, 1, 37, 38, 149, 150, 151, in band at 460 +- 4, alone and
    before alternating extremes."""
    rng = np.random.default_rng(12)
    out = []
    for m in (0, 1, 37, 38, 149, 150, 151):
        head = 460 + rng.integers(-4, 5, m)
        out.append((f"n{m}", head))
        out.append((f"n{m}_then_extremes",
                    np.concatenate([head, _background(rng, 300)])))
    return out


#: synthetic nanopore-like reads (honours_tpu_torch.synth): n not a
#: multiple of the chunk, short, two tiles and more, up to 524,288 samples
SYNTH = (("not_a_chunk_multiple", TILE + 3 * CHUNK + 17),
         ("short_1000", 1000), ("two_tiles", 2 * TILE + 100),
         ("eight_tiles", 1 << 19))


@functools.cache
def synth_rows():
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus(sum(m for _, m in SYNTH), seed=12)
    ends = np.cumsum([0] + [m for _, m in SYNTH])
    return [(name, flat[a:b]) for (name, _), a, b in zip(SYNTH, ends,
                                                          ends[1:])]


def knife_cases():
    """(name, read) of tests/test_dstall.py's knife-edge cases: stall
    lengths at the threshold, margin and window edges, a float-stress
    read and a read whose stall-like run starts past 65535."""

    def stall_exact(stall_len, n_rest=2000, base=460, jitter=4):
        stall = base + rng.integers(-jitter, jitter + 1, stall_len)
        rest = np.empty(n_rest, np.int64)
        rest[0::2] = rng.integers(0, 60, (n_rest + 1) // 2)
        rest[1::2] = rng.integers(1100, 1200, n_rest // 2)
        return np.concatenate([stall, rest]).astype(np.int16)

    rng = np.random.default_rng(77)
    thr, margin, window = 140, 20, 150
    cases = []
    for d in (-1, 0, 1):
        cases.append(("thr%+d" % d, stall_exact(thr + d)))
    for d in (-1, 0, 1):
        cases.append(("margin%+d" % d, stall_exact(2 * margin + d)))
    for ln in (int(window * 0.25), int(window * 0.25) + 1, window,
               window + 1):
        cases.append(("win%d" % ln, stall_exact(ln)))
    x = np.empty(120000, np.int64)
    x[0::2] = rng.integers(0, 40, 60000)
    x[1::2] = rng.integers(1150, 1200, 60000)
    x[:700] = 460 + rng.integers(-3, 4, 700)
    cases.append(("floatstress", x.astype(np.int16)))
    y = np.concatenate([
        rng.integers(300, 900, 66000),
        460 + rng.integers(-3, 4, 3000),
        rng.integers(300, 900, 2000),
    ]).astype(np.int16)
    cases.append(("u16start", y))
    return cases


def late_stall(seed=3, at=70000):
    """Alternating extremes (never in band) for `at` samples, then a
    stall of 3000 at 460 +- 3 and 500 more extremes: the first segment
    starts past 65535."""
    rng = np.random.default_rng(seed)
    x = np.empty(at + 3500, np.int64)
    x[0::2] = rng.integers(0, 40, x[0::2].size)
    x[1::2] = rng.integers(1150, 1200, x[1::2].size)
    x[at: at + 3000] = 460 + rng.integers(-3, 4, 3000)
    return x.astype(np.int16)


def fixture_reads():
    """The three reads of tests/data/three-reads.blow5, read by the
    port."""
    from honours_tpu_torch.io import blow5

    path = Path(__file__).resolve().parent / "data" / "three-reads.blow5"
    return [r.signal for r in blow5.read_blow5(str(path), device="cpu").reads]


def _rows(synth):
    return (crossing_rows() + sum_rows() + length_rows() + synth
            + edge_rows() + merge_rows() + knife_cases()
            + [("late_stall", late_stall())]
            + [(f"fixture{i}", r) for i, r in enumerate(fixture_reads())])


@functools.cache
def stall_rows():
    """(name, int16 row) of every case above, the knife-edge reads, a
    stall past sample 65,535 and the fixture reads (built once)."""
    return tuple((name, np.asarray(r).astype(np.int16))
                 for name, r in _rows(synth_rows()))


def row_names():
    """stall_rows()'s names, without building the synthetic reads."""
    return [name for name, _ in _rows([(n, None) for n, _ in SYNTH])]


def stall_row(name: str) -> np.ndarray:
    return dict(stall_rows())[name]


# ---------------------------------------------------------------------------
# the model: one row, as one block of the kernel runs it
# ---------------------------------------------------------------------------


def clamped(row) -> np.ndarray:
    return np.clip(np.asarray(row).astype(np.float32), np.float32(0),
                   np.float32(1200))


def terms(a: np.ndarray, kind: int, mean=None) -> np.ndarray:
    """Sum 1's terms (the clamped samples) or sum 2's, (a - mean)^2 with
    each operation rounded to float32."""
    if kind == 1:
        return a
    d = a - np.float32(mean)
    return d * d


def _round_down_f32(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    up = f.astype(np.float64) > x
    f[up] = np.nextafter(f[up], np.float32(-np.inf))
    return f


def _ulp(e: np.ndarray) -> np.ndarray:
    """2^(e - 150) as float32, e >= 1 the biased exponent."""
    return np.ldexp(np.float32(1), (e - 150).astype(np.int32)).astype(
        np.float32)


def chunk_tables(x: np.ndarray, kind: int):
    """Steps 1-2 for every chunk of one row: x [chunks, CHUNK] the terms
    (zeros past n) -> (T, P, e0, D [chunks, 4], lim [chunks, 2]) as the
    kernel tabulates them (P the sum before the chunk), D[:, 2k + p] the
    offset of binade e0 + k from parity p, valid below lim[:, k]."""
    if kind == 1:
        T = x.astype(np.int64).sum(1).astype(np.float64)
    else:
        T = np.add.accumulate(x.astype(np.float64), axis=1)[:, -1]
    P = np.concatenate([[0.0], np.cumsum(T)[:-1]])
    g = (P * GUESS).astype(np.float32)
    e0 = np.clip((g.view(np.uint32) >> 23).astype(np.int64), 1, 253)
    D = np.zeros((x.shape[0], 4), np.float32)
    lim = np.zeros((x.shape[0], 2), np.float32)
    for k in (0, 1):
        e = e0 + k
        base = (e.astype(np.uint32) << 23).view(np.float32)
        u = _ulp(e)
        for p in (0, 1):
            b = base + u * np.float32(p)
            walk = np.add.accumulate(np.concatenate([b[:, None], x], axis=1),
                                     axis=1, dtype=np.float32)[:, -1]
            D[:, 2 * k + p] = walk - b
        lim[:, k] = _round_down_f32(2.0 * base.astype(np.float64) - T
                                    - (CHUNK + 1.0) * u.astype(np.float64))
    lim[P <= 0] = 0
    return T, P, e0, D, lim


def group_tables(T, P, e0, D):
    """The tables of each whole group of GROUP chunks: the chunks' entries
    taken in turn from the binade's bottom, valid where every chunk of the
    group tabulates the same binades (and P > 0 before it), below the
    group's limit; T summed pairwise as the kernel's lanes sum it."""
    ng = T.size // GROUP
    t = T[: ng * GROUP].reshape(ng, GROUP)
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    Tg = t[:, 0]
    e = e0[: ng * GROUP].reshape(ng, GROUP)
    ok = (e == e[:, :1]).all(1) & (P[: ng * GROUP: GROUP] > 0)
    gD = np.zeros((ng, 4), np.float32)
    glim = np.zeros((ng, 2), np.float32)
    rows = np.arange(ng)[:, None] * GROUP + np.arange(GROUP)
    for k in (0, 1):
        E = e[:, 0] + k
        base = (E.astype(np.uint32) << 23).view(np.float32)
        u = _ulp(E)
        for p in (0, 1):
            b = base + u * np.float32(p)
            x = b.copy()
            for i in range(GROUP):
                x = x + D[rows[:, i], 2 * k + (x.view(np.uint32) & 1)]
            gD[:, 2 * k + p] = x - b
        glim[:, k] = _round_down_f32(2.0 * base.astype(np.float64) - Tg
                                     - (GROUP * CHUNK + 1.0)
                                     * u.astype(np.float64))
    gD[~ok] = 0
    glim[~ok] = 0
    return Tg, gD, glim


def _step(s, kind, T, e0, D, lim):
    """csrc/segment.cu table_step: (new s, how) or (s, None)."""
    exact = np.float32(1 << 24)
    T = np.float32(T)
    if kind == 1 and s <= exact - T:
        return np.float32(s + T), "integer"
    if kind == 2 and T == 0:
        return s, "skipped"
    bits = int(np.float32(s).view(np.uint32))
    k = (bits >> 23) - int(e0)
    if bits >= 0x800000 and k in (0, 1) and s < lim[k]:
        return np.float32(s + D[2 * k + (bits & 1)]), "table"
    return s, "miss" if bits >= 0x800000 and k not in (0, 1) else None


def model_sum(t: np.ndarray, kind: int, stats: dict = None) -> np.float32:
    """Step 3: the serial float32 sum of the terms t, composed as warp 0
    composes it: a group step, else a chunk step, else the chunk walked.
    stats (if given) counts group steps, chunk steps and walked chunks,
    and of the walked the misses (s in a binade the chunk did not
    tabulate)."""
    n = t.size
    nch = -(-n // CHUNK)
    x = np.zeros((nch, CHUNK), np.float32)
    x.reshape(-1)[:n] = t
    T, P, e0, D, lim = chunk_tables(x, kind)
    Tg, gD, glim = group_tables(T, P, e0, D)
    c = dict(group=0, chunk=0, walked=0, misses=0)
    s = np.float32(0)
    j = 0
    while j < nch:
        if j % GROUP == 0 and j + GROUP <= nch:
            g = j // GROUP
            s2, how = _step(s, kind, Tg[g], e0[j], gD[g], glim[g])
            if how in ("integer", "skipped", "table"):
                s, j = s2, j + GROUP
                c["group"] += 1
                continue
        s2, how = _step(s, kind, T[j], e0[j], D[j], lim[j])
        if how in ("integer", "skipped", "table"):
            s = s2
            c["chunk"] += 1
        else:
            c["walked"] += 1
            c["misses"] += how == "miss"
            w = np.concatenate([[s], x[j, : min(CHUNK, n - j * CHUNK)]])
            s = np.add.accumulate(w.astype(np.float32), dtype=np.float32)[-1]
        j += 1
    if stats is not None:
        for key, v in c.items():
            stats[f"sum{kind}_{key}"] = stats.get(f"sum{kind}_{key}", 0) + v
    return s


def thresholds(a: np.ndarray, stats: dict = None):
    """(mean, top, bot) of one row's clamped samples through model_sum."""
    nf = np.float32(a.size)
    mean = np.float32(model_sum(a, 1, stats) / nf)
    var = np.float32(model_sum(terms(a, 2, mean), 2, stats) / nf)
    sd = np.sqrt(var)
    scale = np.float32(0.75)
    return mean, np.float32(mean + sd * scale), np.float32(mean - sd * scale)


class Segs:
    """segment.c:94-111 at each attempt's end (s, e, li)."""

    def __init__(self):
        self.n = self.fx = self.fy = self.ly = 0

    def end(self, s, e, li):
        count = e - s
        if self.n < 2 and (count >= WINDOW or (
                not self.n and np.float32(count) >= np.float32(
                    WINDOW * STALL_LEN))):
            seg_end = li + 1
            if self.n and s - self.ly < SEG_DIST:
                self.ly = seg_end
                if self.n == 1:
                    self.fy = seg_end
            else:
                self.n += 1
                self.ly = seg_end
                if self.n == 1:
                    self.fx, self.fy = s, seg_end


FREE = 0  # control states: FREE, or 1 + err inside an attempt


def _tile_bits(inb: np.ndarray):
    live = -(-inb.size // CHUNK)
    x = np.zeros((live, CHUNK), bool)
    x.reshape(-1)[: inb.size] = inb
    active = (np.arange(live * CHUNK) < inb.size).reshape(live, CHUNK)
    return x, active


def chunk_maps(inb: np.ndarray) -> np.ndarray:
    """Step 4 for every chunk of one tile's in-band flags at once: [chunks,
    7], the state at each chunk's end of each of the 7 control states at
    its start, sample by sample as the kernel's lanes take them (byte q
    of m holds, a bit each, the start states now in state q)."""
    x, active = _tile_bits(inb)
    m = np.full(x.shape[0], 0x40201008040201, np.uint64)
    lo, hi5 = np.uint64(0xFF), np.uint64(0xFFFFFFFFFF00)
    for i in range(CHUNK):
        inn = (m & ~lo) | ((m & lo) << np.uint64(8))
        out = (m & lo) | ((m >> np.uint64(48)) & lo) | ((m & hi5)
                                                         << np.uint64(8))
        m = np.where(active[:, i], np.where(x[:, i], inn, out), m)
    bytes_ = m[:, None] >> (np.arange(7, dtype=np.uint64) * np.uint64(8))
    bytes_ = (bytes_ & lo).astype(np.int64)  # [chunks, q]
    return np.argmax((bytes_[:, :, None] >> np.arange(7)) & 1, axis=1)


def chunk_ends(inb: np.ndarray, T0: int, st: np.ndarray, c: dict):
    """Step 6's pass for every chunk of one tile at once, from each chunk's
    control state st at its start: (ends, open, last): each chunk's ends
    [s, e, li] of count >= 38 and its first end (of the attempt open at its
    start, s = -1), the start of the attempt open at its end if it began
    in it (else -1), its last in-band sample (else -1)."""
    x, active = _tile_bits(inb)
    live = x.shape[0]
    inseg = st != FREE
    k = np.where(inseg, st - 1, 0)
    s = np.full(live, -1)
    li = np.full(live, -1)
    c0 = T0 + CHUNK * np.arange(live)
    ends = [[] for _ in range(live)]
    for i in range(CHUNK):
        b = x[:, i] & active[:, i]
        o = ~x[:, i] & active[:, i]
        start = b & ~inseg
        s = np.where(start, c0 + i, s)
        k = np.where(start, 0, k)
        inseg = inseg | start
        li = np.where(b, c0 + i, li)
        oin = o & inseg
        end = oin & (k >= MAX_ERR)
        k = np.where(oin & ~end, k + 1, k)
        for t in np.flatnonzero(end):
            c["jumps"] += 1
            e = int(c0[t]) + i
            if s[t] < 0 or np.float32(e - s[t]) >= np.float32(WINDOW
                                                              * STALL_LEN):
                ends[t].append([int(s[t]), e, int(li[t])])
        inseg = inseg & ~end
        s = np.where(end, -1, s)
    return ends, np.where(inseg, s, -1), li


def model_runs(inb: np.ndarray, stats: dict = None):
    """Steps 4-6 over one row's in-band flags, tile by tile: each chunk's
    map of the control states, their composition in chunk order (the
    block scan) giving each chunk's state at its start, each chunk's ends,
    the open attempt's start and last in-band sample before each chunk
    (the block's running maxima), then the ends in order until nsegs
    reaches 2.  Returns (nsegs, first_x, first_y); stats (if given) counts
    tiles, attempts ended (jumps) and ends kept for the segments."""
    n = inb.size
    g = Segs()
    state, carry = FREE, (-1, -1)
    c = dict(tiles=0, jumps=0, kept=0)
    for T0 in range(0, n, TILE):
        E = min(T0 + TILE, n)
        c["tiles"] += 1
        maps = chunk_maps(inb[T0:E])
        st = np.empty(maps.shape[0], np.int64)
        q = state
        for t, f in enumerate(maps):
            st[t] = q
            q = f[q]
        ends, opened, last = chunk_ends(inb[T0:E], T0, st, c)
        s_in = np.maximum(carry[0], np.concatenate(
            [[-1], np.maximum.accumulate(opened)[:-1]]))
        li_in = np.maximum(carry[1], np.concatenate(
            [[-1], np.maximum.accumulate(last)[:-1]]))
        for t, es in enumerate(ends):
            if es and es[0][0] < 0:
                es[0][0] = int(s_in[t])
                if es[0][2] < 0:
                    es[0][2] = int(li_in[t])
            for s, e, li in es:
                if g.n >= 2:
                    break
                c["kept"] += 1
                g.end(s, e, li)
        state = q
        carry = (max(carry[0], int(opened.max())),
                 max(carry[1], int(last.max())))
        if g.n >= 2:
            break
    if stats is not None:
        for key, v in c.items():
            stats[key] = stats.get(key, 0) + v
    return g.n, g.fx, g.fy


def model_find_stall(row, stats: dict = None):
    """(exists, start, length) of one row as kernel A computes it; stats
    (if given) gathers model_sum's and model_runs' counts."""
    row = np.asarray(row)
    if row.size == 0:
        return False, 0, 0
    a = clamped(row)
    _, top, bot = thresholds(a, stats)
    nsegs, x, y = model_runs((a < top) & (a > bot), stats)
    return (True, x, y - x + 1) if nsegs else (False, 0, 0)
