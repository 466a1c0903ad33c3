"""Kernel I's group packing (csrc/bitpack.cu bitpack_kernel), checked on
the CPU: a numpy model of its work (pack_model: a thread a group of 8
fields packed MSB-first into a 128-bit register pair, b whole bytes a
group and ceil(rem b / 8) for a row's last; warps of 32 consecutive
groups that find their rows by the kernel's searches of the group
prefix; a warp of one row staging its bytes at the output's misalignment
and storing aligned 16-byte words with a byte head and tail, a warp that
straddles rows storing each group's bytes from its thread) writes every
byte of every row exactly once, nothing else, and the bytes of the plain
version (engine/bitpack.py pack_msb_plain) and of the JAX package's host
packer (honours_tpu/kernels/bitpack.py pack_bits, numpy), exactly.
Rows: every width 0-16 at counts 0-17, around multiples of 8 and long,
unaligned value and output offsets; rows shaped like the uint codecs'
(one long row a read), turbopfor's (rows of 128 fields) and
flat_uint_submin's (short rows a segment, widths 0 among them); at
output addresses 0 and 5 mod 16.

Kernel J's group unpack (bitunpack_kernel) likewise: unpack_model (a
thread a group of 8 fields, the groups of every row, b = 0 too; the
rows of a warp's first and last group by a 32-ary warp search; each
group's 5 aligned 4-byte words loaded from its thread; a word past
[0, S) read a byte at a time; 16 bytes big-endian by a byte permute and
a funnel shift, those at or past in_len zeroed; fields 0-3 from bits [0,
64) and 4-7 from [4 b, 4 b + 64); two 16-byte stores a group where
aligned) writes
each output element of every row exactly once, nothing else, and the
values of the plain version (engine/bitpack.py unpack_msb_plain) and, for
rows inside their bytes, of the host unpacker (unpack_bits).  Rows:
widths 0-16 at counts 0-17, around multiples of 8 and long; rows cut
short by in_len; a row ending at the stream's last byte; stream and
output at every address mod 16; the callers' rows.  No JAX is
imported."""

import numpy as np
import pytest
import torch

import raw_rows
from honours_tpu.kernels.bitpack import pack_bits, unpack_bits
from honours_tpu_torch.engine.bitpack import pack_msb_plain, unpack_msb_plain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
WARP = 32


def group_pack(f, b: int):
    """The kernel's (hi, lo) of 8 fields of width b (1-16): their 8 b bits
    MSB-first, left-aligned in 128 bits."""
    hi = lo = 0
    for v in f:
        hi = ((hi << b) | (lo >> (64 - b))) & M64
        lo = ((lo << b) | (int(v) & ((1 << b) - 1))) & M64
    sh = 128 - 8 * b
    if sh >= 64:
        hi, lo = (lo << (sh - 64)) & M64, 0
    elif sh > 0:
        hi, lo = ((hi << sh) | (lo >> (64 - sh))) & M64, (lo << sh) & M64
    return hi, lo


def group_byte(hi: int, lo: int, j: int) -> int:
    return (hi >> (56 - 8 * j) if j < 8 else lo >> (120 - 8 * j)) & 0xFF


def row_in(off, lo: int, hi: int, t: int) -> int:
    """The kernel's search: r with off[r] <= t < off[r + 1] in [lo, hi)."""
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if off[mid] <= t:
            lo = mid
        else:
            hi = mid
    return lo


def pack_model(values, val_off, count, width, out, out_off, addr: int = 0,
               stats=None):
    """Kernel I on numpy arrays, into out (u8, in place), out's first byte
    at an address addr mod 16.  Returns the times each byte of out was
    written."""
    R = len(count)
    cnt = np.maximum(count, 0).astype(np.int64)
    b_of = np.clip(width, 0, 16).astype(np.int64)
    gp = np.concatenate([[0], np.cumsum(np.where(b_of > 0, (cnt + 7) >> 3,
                                                 0))]).tolist()
    total = gp[-1]
    writes = np.zeros(out.size, np.int64)

    def put(at: int, v: int):
        out[at] = v
        writes[at] += 1

    st = stats if stats is not None else {}
    for base in range(0, total, WARP):
        last = min(base + WARP - 1, total - 1)
        r0, r1 = row_in(gp, 0, R, base), row_in(gp, 0, R, last)
        packed = []
        for g in range(base, last + 1):
            r = r0 if r0 == r1 else row_in(gp, r0, r1 + 1, g)
            b, gl = int(b_of[r]), g - gp[r]
            nf = min(8, int(cnt[r]) - 8 * gl)
            assert b >= 1 and 1 <= nf <= 8
            v0 = int(val_off[r]) + 8 * gl
            if nf == 8 and v0 % 4 == 0:
                st["vector_loads"] = st.get("vector_loads", 0) + 1
            f = [int(values[v0 + i]) if i < nf else 0 for i in range(8)]
            hi, lo = group_pack(f, b)
            packed.append((r, gl, b, (nf * b + 7) >> 3, hi, lo))
        if r0 == r1:
            st["one_row_warps"] = st.get("one_row_warps", 0) + 1
            b = int(b_of[r0])
            g0, gz = base - gp[r0], last - gp[r0]
            fz = min(8, int(cnt[r0]) - 8 * gz)
            n_run = (gz - g0) * b + ((fz * b + 7) >> 3)
            dst = int(out_off[r0]) + g0 * b
            mis = (addr + dst) & 15
            stage = np.zeros(WARP * 16 + 32, np.int64)
            for lane, (_, _, _, nb, hi, lo) in enumerate(packed):
                for j in range(nb):
                    stage[mis + lane * b + j] = group_byte(hi, lo, j)
            zend = mis + n_run
            assert zend <= stage.size
            for k in range(-(-zend // 16)):
                a = 16 * k
                if a >= mis and a + 16 <= zend:
                    st["words"] = st.get("words", 0) + 1
                    assert (addr + dst - mis + a) % 16 == 0
                for j in range(max(a, mis), min(a + 16, zend)):
                    put(dst - mis + j, int(stage[j]))
        else:
            st["straddling_warps"] = st.get("straddling_warps", 0) + 1
            for r, gl, b, nb, hi, lo in packed:
                for j in range(nb):
                    put(int(out_off[r]) + gl * b + j, group_byte(hi, lo, j))
    return writes


def _check(values, val_off, count, width, out_off, O: int, addrs=(0, 5)):
    """The model, at each address, = pack_msb_plain = pack_bits row by
    row; each row byte written once, no other byte; returns the stats."""
    t = torch.from_numpy
    poison = np.full(O, 0xA5, np.uint8)
    want = pack_msb_plain(t(values), t(val_off), t(count), t(width),
                          t(poison.copy()), t(out_off)).numpy()
    rows = np.zeros(O, np.int64)
    for r in range(len(count)):
        b, k = int(np.clip(width[r], 0, 16)), max(int(count[r]), 0)
        host = np.frombuffer(pack_bits(
            values[val_off[r]: val_off[r] + k].astype(np.int64)
            & ((1 << b) - 1), b), np.uint8)
        assert host.size == (k * b + 7) // 8
        got = want[out_off[r]: out_off[r] + host.size]
        assert np.array_equal(got, host), r
        rows[out_off[r]: out_off[r] + host.size] += 1
    assert rows.max(initial=0) <= 1, "rows overlap"
    stats = {}
    for addr in addrs:
        out = poison.copy()
        writes = pack_model(values, val_off, count, width, out, out_off, addr,
                            stats)
        assert np.array_equal(writes, rows), addr
        assert np.array_equal(out, want), addr
    return stats


COUNTS = [*range(18), 23, 24, 25, 31, 32, 33, 63, 64, 65, 127, 128, 129,
          255, 256, 257, 1000]


@pytest.mark.parametrize("b", range(17))
def test_pack_model_every_width(b):
    """Width b at counts 0-17, around multiples of 8 and 1,000, each
    row's values at an odd or even offset, gaps of 0-5 bytes between the
    rows' outputs."""
    rng = np.random.default_rng(b)
    count = np.array(COUNTS, np.int64)
    V = int(count.sum()) + 64
    values = rng.integers(-2 ** 31, 2 ** 31, V, dtype=np.int64).astype(
        np.int32)
    val_off = (np.cumsum(count) - count + rng.integers(0, 8, count.size))
    width = np.full(count.size, b, np.int64)
    out_off, O = raw_rows.layout((count * b + 7) // 8, b)
    stats = _check(values, val_off.astype(np.int64), count, width, out_off,
                   O)
    if b:
        assert stats["one_row_warps"] and stats["straddling_warps"]


@pytest.mark.parametrize("shape", ["uint", "turbopfor", "flats", "ragged"])
def test_pack_model_callers_rows(shape):
    """Rows shaped as each caller of kernel I lays them out."""
    values, val_off, count, width, out_off, O = raw_rows.caller_rows(
        shape, len(shape))
    stats = _check(values, val_off.astype(np.int64), count, width,
                   out_off.astype(np.int64), O)
    if shape == "uint":
        assert stats["words"] and stats["vector_loads"]
    else:
        assert stats["straddling_warps"]


def window(stream, x: int):
    """The kernel's 5 little-endian words of stream bytes [x, x + 20) (x
    4-aligned in address), a byte outside [0, S) as 0."""
    S = stream.size
    b = [int(stream[y]) if 0 <= y < S else 0 for y in range(x, x + 20)]
    return [int.from_bytes(bytes(b[4 * q: 4 * q + 4]), "little")
            for q in range(5)]


def be128(w, o: int):
    """be128: the 16 bytes from byte o (0-3) of 5 little-endian words as
    4 big-endian words (a byte permute, then a funnel shift)."""
    e = [int.from_bytes(v.to_bytes(4, "little"), "big") for v in w]
    s = 8 * o
    return [((e[q] << s) | (e[q + 1] >> (32 - s))) & M32 if s else e[q]
            for q in range(4)]


def group_fields(rb, b: int):
    """The 8 fields of width b (0-16) MSB-first from the group's 4
    big-endian words: 0-3 from bits [0, 64), 4-7 from [4 b, 4 b + 64)."""
    hi = rb[0] << 32 | rb[1]
    lo = rb[2] << 32 | rb[3]
    s4 = 4 * b
    hi4 = hi if s4 == 0 else lo if s4 == 64 else (
        (hi << s4) | (lo >> (64 - s4))) & M64
    mask = (1 << b) - 1
    sh = [(64 - b * (q + 1)) & 63 for q in range(4)]
    return [(hi >> k) & mask for k in sh] + [(hi4 >> k) & mask for k in sh]


def warp_row_in(off, lo: int, hi: int, t: int, stats=None) -> int:
    """Kernel J's warp search: r with off[r] <= t < off[r + 1] in [lo, hi),
    a round of 32 probes (lane l at lo + (l + 1) span / 32, the last at
    hi) and the ballot of off[p] <= t, which holds for a prefix of the
    lanes."""
    while hi - lo > 1:
        span = hi - lo
        p = [lo + ((lane + 1) * span >> 5) for lane in range(WARP)]
        ok = [q < hi and off[q] <= t for q in p]
        c = sum(ok)
        assert ok == [True] * c + [False] * (WARP - c)
        lo, hi = (lo + (c * span >> 5) if c else lo,
                  lo + ((c + 1) * span >> 5))
        if stats is not None:
            stats["search_rounds"] = stats.get("search_rounds", 0) + 1
    return lo


def unpack_model(stream, in_off, in_len, count, width, out, out_off,
                 addr: int = 0, out_addr: int = 0, stats=None):
    """Kernel J on numpy arrays, into out (int32, in place), the stream's
    byte 0 at address addr and out's element 0 at out_addr (mod 16).
    Returns the times each element of out was written."""
    R, S = len(count), stream.size
    cnt = np.maximum(count, 0).astype(np.int64)
    b_of = np.clip(width, 0, 16).astype(np.int64)
    gp = np.concatenate([[0], np.cumsum((cnt + 7) >> 3)]).tolist()
    total = gp[-1]
    writes = np.zeros(out.size, np.int64)
    st = stats if stats is not None else {}

    def bump(k):
        st[k] = st.get(k, 0) + 1

    for base in range(0, total, WARP):
        last = min(base + WARP - 1, total - 1)
        r0 = warp_row_in(gp, 0, R, base, st)
        r1 = warp_row_in(gp, r0, R, last, st)
        assert (r0, r1) == (row_in(gp, 0, R, base), row_in(gp, 0, R, last))
        bump("one_row_warps" if r0 == r1 else "straddling_warps")
        groups = []
        for g in range(base, last + 1):
            r = r0 if r0 == r1 else row_in(gp, r0, r1 + 1, g)
            b, gl = int(b_of[r]), g - gp[r]
            w, o = [0] * 5, 0
            if b:
                frm = int(in_off[r]) + gl * b
                o = (addr + frm) & 3
                x = frm - o
                bump("words4" if x >= 0 and x + 20 <= S else "words4_bytes")
                w = window(stream, x)
            rb = be128(w, o)
            lim = int(in_len[r]) - gl * b  # the group's bytes read
            if lim < 16:
                bump("cut_groups")
                for q in range(4):
                    k = lim - 4 * q
                    rb[q] = 0 if k <= 0 else rb[q] if k >= 4 else (
                        rb[q] & ~(M32 >> (8 * k)) & M32)
            nf = min(8, int(cnt[r]) - 8 * gl)
            assert 1 <= nf <= 8
            groups.append((int(out_off[r]) + 8 * gl, nf,
                           group_fields(rb, b)))
        for dst, nf, f in groups:
            if nf == 8 and (out_addr + 4 * dst) % 16 == 0:
                bump("int4_pairs")
            for q in range(nf):
                out[dst + q] = f[q]
                writes[dst + q] += 1
    return writes


def _check_unpack(stream, in_off, in_len, count, width, out_off, O: int,
                  addrs=((0, 0),)):
    """The model, at each (stream, out) address, = unpack_msb_plain; each
    row element written once, no other; rows inside their bytes =
    unpack_bits; returns the stats."""
    t = torch.from_numpy
    fill = np.full(O, -7, np.int32)
    want = unpack_msb_plain(t(stream), t(in_off), t(in_len), t(count),
                            t(width), t(fill.copy()), t(out_off)).numpy()
    rows = np.zeros(O, np.int64)
    for r in range(len(count)):
        k, b = max(int(count[r]), 0), int(np.clip(width[r], 0, 16))
        rows[out_off[r]: out_off[r] + k] += 1
        nb = (k * b + 7) // 8
        lo = int(in_off[r])
        if lo >= 0 and lo + nb <= min(stream.size, lo + int(in_len[r])):
            host = unpack_bits(stream[lo: lo + nb].tobytes(), b, k)
            assert np.array_equal(want[out_off[r]: out_off[r] + k], host), r
    assert rows.max(initial=0) <= 1, "rows overlap"
    stats = {}
    for addr, out_addr in addrs:
        out = fill.copy()
        writes = unpack_model(stream, in_off, in_len, count, width, out,
                              out_off, addr, out_addr, stats)
        assert np.array_equal(writes, rows), (addr, out_addr)
        assert np.array_equal(out, want), (addr, out_addr)
    return stats


def _rows(seed: int, count, width, gap: int = 3, shift: int = 0, cut=None,
          tail: int = 0):
    """(stream u8, in_off, in_len, count, width, out_off, O): rows over
    random bytes, each at a gap of 0..gap bytes after the one before it
    (from byte shift on), in_len its bytes (or cut), `tail` bytes after
    the last; fields laid end to end from element shift on."""
    rng = np.random.default_rng(seed)
    count = np.asarray(count, np.int64)
    width = np.asarray(width, np.int64)
    nb = (count * np.clip(width, 0, 16) + 7) // 8
    in_off = shift + np.cumsum(nb + rng.integers(0, gap + 1, count.size)) - nb
    S = int((in_off + nb).max(initial=0)) + tail
    stream = rng.integers(0, 256, S).astype(np.uint8)
    in_len = nb.copy() if cut is None else np.asarray(cut, np.int64)
    out_off = shift + np.cumsum(count) - count
    return (stream, in_off, in_len, count, width, out_off,
            int(count.sum()) + shift + 3)


@pytest.mark.parametrize("b", range(17))
def test_unpack_model_every_width(b):
    """Width b at counts 0-17, around multiples of 8 and 1,000, rows at
    gaps of 0-3 bytes, at stream addresses 0 and 5 and output addresses
    0 and 4 mod 16."""
    stats = _check_unpack(*_rows(b, COUNTS, [b] * len(COUNTS)),
                          addrs=((0, 0), (5, 4)))
    assert stats["one_row_warps"] and stats["straddling_warps"]
    assert stats["int4_pairs"]
    if b:
        assert stats["words4"]


def test_unpack_model_rows_cut_by_in_len():
    """in_len cuts rows to 0 and 1 bytes, half, all but one, and past
    their end (the bytes past a cut read 0); the last row ends at the
    stream's last byte S, so its last groups' words pass S."""
    rng = np.random.default_rng(7)
    count = rng.integers(1, 300, 50)
    width = rng.integers(1, 17, 50)
    nb = (count * width + 7) // 8
    cut = np.stack([np.zeros_like(nb), np.minimum(nb, 1), nb // 2,
                    np.maximum(nb - 1, 0), nb + 9]).T.reshape(-1)[:50]
    stats = _check_unpack(*_rows(8, count, width, cut=cut),
                          addrs=((0, 0), (3, 8)))
    assert stats["cut_groups"] and stats["words4_bytes"]


@pytest.mark.parametrize("b", [3, 16])
def test_unpack_model_row_ending_at_s(b):
    """One long row (one-row warps) and one short one whose bytes end at
    the stream's last byte, stream cut there and 5 bytes short."""
    stream, in_off, in_len, count, width, out_off, O = _rows(
        b, [1000, 9], [b, b], gap=0)
    for S in (stream.size, stream.size - 5):
        stats = _check_unpack(stream[:S], in_off, in_len, count, width,
                              out_off, O, addrs=((0, 0), (13, 12)))
        assert stats["words4_bytes"]


@pytest.mark.parametrize("addr", range(16))
def test_unpack_model_every_address(addr):
    """Stream and output at every address mod 16 (rows and fields shifted
    by addr bytes and elements too): uint-like long rows and flats-like
    short ones."""
    rng = np.random.default_rng(addr)
    count = np.concatenate([[700, 257], rng.integers(0, 40, 60)])
    width = rng.integers(0, 17, count.size)
    _check_unpack(*_rows(addr, count, width, shift=addr),
                  addrs=((addr, 4 * addr % 16),))


@pytest.mark.parametrize("shape", ["uint", "turbopfor", "flats", "ragged"])
def test_unpack_model_callers_rows(shape):
    """The rows each caller of kernel J unpacks: kernel I's packed bytes
    of raw_rows.caller_rows at their byte offsets, in_len to the end of
    the stream (as the depresses pass it), fields into rows laid out
    apart."""
    values, val_off, count, width, out_off, O = raw_rows.caller_rows(
        shape, len(shape) + 1)
    packed = pack_msb_plain(*[torch.from_numpy(a) for a in (
        values, val_off, count, width)], torch.zeros(O, dtype=torch.uint8),
        torch.from_numpy(out_off)).numpy()
    f_off, F = raw_rows.layout(np.maximum(count, 0), len(shape))
    stats = _check_unpack(packed, out_off, O - out_off, count, width, f_off,
                          F)
    if shape == "uint":
        assert stats["one_row_warps"] and stats["int4_pairs"]
    else:
        assert stats["straddling_warps"] and stats["int4_pairs"]
