"""The chunked, self-synchronising decode of kernels B and C
(csrc/common.cuh htt_chunked), as a numpy model of its four phases at
the kernels' own block width and chunk size (rice_cuda.THREADS,
CHUNK_BITS), held against the plain versions (rice_decode_plain,
huffman_decode_plain), the host codecs (honours_tpu/codecs/rice.py
rice_decode; native/huffdec.c through codecs/huffman.py and
kernels/huffman_np.py) and, for C's chunk entries, the JAX package's
_speculate and _compose_entries.  Values, counts and entries must be
equal (tolerance 0).  The adversarial rows are tests/chunked_rows.py's,
which tests/test_torch_gpu.py runs through the kernels on the card."""

import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chunked_rows as rows
from honours_tpu.codecs.huffman import shuffman_decode_memory
from honours_tpu.codecs.rice import rice_decode
from honours_tpu.engine.huffdec import _compose_entries, _speculate
from honours_tpu.kernels.huffman_np import huffman_encode, make_decode_lut
from honours_tpu.native import huffman_decode_lut
from honours_tpu.tables.huffman import na12878_table
from honours_tpu_torch._build import CSRC
from honours_tpu_torch.engine import huffdec_cuda as H
from honours_tpu_torch.engine import rice_cuda as R
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

THREADS, CHUNK_BITS = R.THREADS, R.CHUNK_BITS
STOP = 0xFFFFFFFF
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the model: one row, as one block decodes it
# ---------------------------------------------------------------------------

def _stream(row, off, extra):
    """The row's bits from byte off on (negative reads as 0), zeros past
    its end and `extra` more; its bit count E; and the bits up to its
    last nonzero byte."""
    start = min(max(int(off), 0), row.size)
    bits = np.unpackbits(row[start:], bitorder="little")
    nz = np.flatnonzero(row[start:])
    last = 8 * (int(nz[-1]) + 1) if nz.size else 0
    return (np.concatenate([bits, np.zeros(extra, np.uint8)]),
            8 * (row.size - start), last)


class Rice:
    """Kernel B's code: step(p) -> (length, value) of the code at bit p."""
    first = 3  # after the 3-bit k header

    def __init__(self, row, off):
        self.bits, self.E, self.last = _stream(row, off, 64)
        b = self.bits
        self.k = int(b[0]) << 2 | int(b[1]) << 1 | int(b[2])
        zero_at = np.where(b == 0, np.arange(b.size), b.size)
        self.next_zero = np.minimum.accumulate(zero_at[::-1])[::-1]

    def step(self, p):
        t = int(self.next_zero[p]) if p < self.bits.size else p
        v = 0
        for j in range(t + 1, t + 1 + self.k):
            v = v << 1 | (int(self.bits[j]) if j < self.bits.size else 0)
        return t + 1 + self.k - p, ((t - p) << self.k | v) & 0xFF

    def tail(self, e):
        """Codes from bit e past the last nonzero byte: values 0, no
        end."""
        return STOP, 0


class Huffman:
    """Kernel C's code: step(p) -> (length, symbol), None at a stop (a
    zero length, or a code past the row's end)."""
    first = 0

    def __init__(self, row, off, lut):
        self.bits, self.E, self.last = _stream(row, off, 32)
        self.lut = lut.astype(np.int64) & 0xFFFF
        b = self.bits.astype(np.int64)
        n = max(self.E, 1)
        self.win = sum(b[j: j + n] << j for j in range(H.LUT_BITS))

    def step(self, p):
        e = int(self.lut[self.win[p]])
        n = e >> 8
        if n == 0 or p + n > self.E:
            return None
        return n, e & 0xFF

    def tail(self, e):
        """The zero window's code from bit e to the row's end."""
        n = int(self.lut[0]) >> 8
        return ((self.E - e) // n if n else 0), int(self.lut[0]) & 0xFF


class Chunk:
    def __init__(self, c, end):
        self.c, self.end = c, end
        self.entry = self.exit = self.count = None


def _popc(x):
    return bin(x & M32).count("1")


def _popc_from(bm, j, r):
    return (_popc(int(bm[r >> 5, j]) & (M32 << (r & 31)))
            + sum(_popc(int(x)) for x in bm[(r >> 5) + 1:, j]))


def _walk(code, bm, j, ch, e, valid_from, sync):
    """common.cuh walk(): thread j's bitmap words bm[:, j]; bits at or
    past the entry are the walk's starts, bits below it are never read."""
    p, n, cw, acc = e, 0, (e - ch.c) >> 5, 0
    old = int(bm[cw, j]) if sync else 0
    if not sync:
        bm[cw + 1:, j] = 0
    synced = stopped = False
    while p < ch.end:
        r = p - ch.c
        w = r >> 5
        if w != cw:
            bm[cw, j] = acc
            if sync:
                bm[cw + 1: w, j] = 0
                old = int(bm[w, j])
            cw, acc = w, 0
        bit = 1 << (r & 31)
        if sync and p >= valid_from and old & bit:
            synced = True
            break
        s = code.step(p)
        if s is None:
            stopped = True
            break
        acc |= bit
        n += 1
        p += s[0]
    if synced:
        bm[cw, j] = (old & (M32 << ((p - ch.c) & 31)) & M32) | acc
        ch.count = n + _popc_from(bm, j, p - ch.c)
    else:
        bm[cw, j] = acc
        if sync:
            bm[cw + 1:, j] = 0
        ch.count = n
        ch.exit = STOP if stopped else p
    ch.entry = e


def model_decode(code, count, N, stats=None):
    """decode_row() of csrc/common.cuh over one row: -> (out [N] u8,
    got).  stats gets the tiles, the fix-point rounds, the chunks whose
    first guess of an entry was wrong, and every live chunk's entry."""
    words = CHUNK_BITS // 32
    tile = THREADS * CHUNK_BITS
    cnt = min(max(int(count), 0), N)
    E = min(code.E, code.last) if cnt else 0
    bm = np.zeros((words, THREADS), np.int64)
    out = np.zeros(N, np.uint8)
    st = {"tiles": 0, "rounds": 0, "wrong": 0, "entries": {}}
    S, entry = 0, code.first
    while entry < E and S < cnt:
        tb = entry - entry % tile
        # 1. speculate
        chs = []
        for j in range(THREADS):
            ch = Chunk(tb + j * CHUNK_BITS, min(tb + (j + 1) * CHUNK_BITS, E))
            e0 = max(ch.c, entry)
            if e0 >= ch.end:
                ch.entry = ch.exit = e0
                ch.count = 0
            else:
                _walk(code, bm, j, ch, e0, ch.end, sync=False)
            chs.append(ch)
        guess = [ch.entry for ch in chs]
        # 2. synchronise: each round reads the exits of the round before
        exits = [ch.exit for ch in chs]
        while True:
            st["rounds"] += 1
            moved = False
            for j, ch in enumerate(chs):
                e = exits[j - 1] if j else ch.entry
                if e == ch.entry or ch.c >= E:
                    continue
                was = ch.exit
                if e >= ch.end:
                    ch.entry = ch.exit = e
                    ch.count = 0
                elif (e >= ch.entry and int(bm[(e - ch.c) >> 5, j])
                      >> ((e - ch.c) & 31) & 1):
                    ch.count = _popc_from(bm, j, e - ch.c)
                    ch.entry = e
                else:
                    _walk(code, bm, j, ch, e, ch.entry, sync=True)
                moved |= ch.exit != was
            exits = [ch.exit for ch in chs]
            if not moved:
                break
        st["tiles"] += 1
        for j, ch in enumerate(chs):
            if ch.c < E:
                st["wrong"] += ch.entry != guess[j]
                st["entries"][ch.c] = ch.entry
        # 3. scan and 4. emit, cut at cnt
        first = S
        for ch in chs:
            p = ch.entry
            for i in range(first, min(first + ch.count, cnt)):
                ln, out[i] = code.step(p)
                p += ln
            first += ch.count
        S = first
        entry = exits[min((E - 1 - tb) // CHUNK_BITS, THREADS - 1)]
    got = min(S, cnt)
    if entry != STOP and S < cnt:  # the walk's rest over zero bits
        n, sym = code.tail(entry)
        got = S + min(n, cnt - S)
        out[S: got] = sym
    if stats is not None:
        stats.update(st)
    return out, got


def model_batch(kind, stream, off, count, N, tabs=None, stats=None):
    outs, gots = [], []
    for b in range(stream.shape[0]):
        code = (Rice(stream[b], off[b]) if kind == "rice"
                else Huffman(stream[b], off[b], tabs["lut"].numpy()))
        s = {}
        o, g = model_decode(code, count[b], N, s)
        outs.append(o)
        gots.append(g)
        if stats is not None:
            stats.append(s)
    return np.stack(outs), np.array(gots, np.int32)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_case_names():
    assert tuple(rows.rice_cases()) == rows.RICE_NAMES
    assert tuple(rows.huffman_cases()) == rows.HUFFMAN_NAMES


def test_wrapper_constants_match_source():
    """rice_cuda.THREADS and CHUNK_BITS (kernels B and C share them) are
    common.cuh's."""
    text = (CSRC / "common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (THREADS|CHUNK_BITS) = (\d+);",
                             text))
    assert int(consts["THREADS"]) == THREADS
    assert int(consts["CHUNK_BITS"]) == CHUNK_BITS


@pytest.mark.parametrize("name", rows.RICE_NAMES)
def test_rice_model_matches_plain(name):
    stream, off, count, N = rows.rice_cases()[name]
    want = R.rice_decode_plain(torch.from_numpy(stream),
                               torch.from_numpy(off),
                               torch.from_numpy(count), N).numpy()
    stats = []
    got, _ = model_batch("rice", stream, off, count, N, stats=stats)
    assert np.array_equal(got, want)
    # after round r chunks 0..r are exact, so a tile ends by THREADS + 1
    assert all(s["rounds"] <= s["tiles"] * (THREADS + 1) for s in stats)


@pytest.mark.parametrize("name", ["k0_runs", "chunk_end_phases",
                                  "two_tiles"])
def test_rice_model_matches_host(name):
    """Whole streams: the model's values are honours_tpu's host
    decoder's (codecs/rice.py rice_decode) and the rows'."""
    stream, off, count, N = rows.rice_cases()[name]
    values = rows.rice_value_rows()[{"k0_runs": "runs",
                                     "chunk_end_phases": "phase",
                                     "two_tiles": "long"}[name]]
    got, _ = model_batch("rice", stream, off, count, N)
    for b, v in enumerate(values):
        n = int(count[b])
        host = rice_decode(stream[b, off[b]:].tobytes(), n)
        assert np.array_equal(got[b, :n], host), b
        assert np.array_equal(host, v[:n].astype(np.uint8)), b
    if name == "k0_runs":
        assert rows.rice_k(stream[0].tobytes()) == 0


def _chunk_end_offsets(code, n):
    """(chunk end - start of the code it cuts) mod 8, for every chunk
    end inside one of the row's first n codes."""
    p, offs = code.first, set()
    for _ in range(n):
        ln = code.step(p)[0]
        q = (p // CHUNK_BITS + 1) * CHUNK_BITS
        if q < p + ln:
            offs.add((q - p) % 8)
        p += ln
    return offs


def test_chunk_ends_fall_at_every_bit_offset():
    """The chunk ends of the phase rows cut codes at every bit offset
    mod 8, and those of the random Huffman rows too."""
    stream, off, count, _ = rows.rice_cases()["chunk_end_phases"]
    offs = set()
    for b in range(stream.shape[0]):
        offs |= _chunk_end_offsets(Rice(stream[b], off[b]), int(count[b]))
    assert offs == set(range(8))
    stream, off, count, _, tabs = rows.huffman_cases()["random"]
    offs = set()
    for b in range(2):
        offs |= _chunk_end_offsets(
            Huffman(stream[b], off[b], tabs["lut"].numpy()), int(count[b]))
    assert offs == set(range(8))


@pytest.mark.parametrize("name", rows.HUFFMAN_NAMES)
def test_huffman_model_matches_plain(name):
    stream, off, count, N, tabs = rows.huffman_cases()[name]
    want, want_got = H.huffman_decode_plain(
        torch.from_numpy(stream), torch.from_numpy(off),
        torch.from_numpy(count), N, tabs)
    stats = []
    got, got_n = model_batch("huffman", stream, off, count, N, tabs, stats)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got_n, want_got.numpy())
    if name.startswith("guard"):  # the stop falls in a late chunk
        assert got_n.tolist() == {"guard_before_count": [5000, 2500, 5999],
                                  "guard_after_count": [4000, 1000,
                                                        5999]}[name]


@pytest.mark.parametrize("name", ["random", "two_tiles", "zero_tail",
                                  "guard_before_count"])
def test_huffman_model_matches_host(name):
    """The model's symbols and counts are the native C walk's
    (native/huffdec.c), through codecs/huffman.py for the canned table
    and through the LUT entry for the guard's tables, whose stop the C
    reports as a corrupt stream after the symbols before it."""
    stream, off, count, N, tabs = rows.huffman_cases()[name]
    got, got_n = model_batch("huffman", stream, off, count, N, tabs)
    lut = tabs["lut"].numpy().astype(np.int64)
    for b in range(stream.shape[0]):
        n = int(count[b])
        bits = stream[b, off[b]:].tobytes()
        if name.startswith("guard"):
            with pytest.raises(ValueError, match="corrupt") as err:
                huffman_decode_lut(bits, n, (lut & 0xFF).astype(np.uint8),
                                   (lut >> 8).astype(np.uint8), H.LUT_BITS)
            stop = int(re.search(r"decoded (\d+)", str(err.value))[1])
            assert got_n[b] == stop < n, b
            host = huffman_decode_lut(bits, stop, (lut & 0xFF).astype(
                np.uint8), (lut >> 8).astype(np.uint8), H.LUT_BITS)
        else:
            host = shuffman_decode_memory(struct.pack(">I", n) + bits)
            assert got_n[b] == n, b
        assert np.array_equal(got[b, : got_n[b]], host), b


def test_model_rounds_on_runner_streams():
    """On the runner's streams of synthetic reads a tile needs one
    fix-point round (no exit moves), at most one tile of a row two,
    though most first guesses of a chunk's entry are wrong."""
    from honours_tpu_torch.engine.bits import read_u32be
    from honours_tpu_torch.engine.pipeline import press_shuff_batch
    from honours_tpu_torch.engine.rice import press_rice_vb_zd_batch
    from honours_tpu_torch.engine.vb_batch import parse_exblock_batch
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parse_batch
    from honours_tpu_torch.synth import synthesize_bucket

    L = 1 << 16
    sig, n = map(torch.from_numpy, synthesize_bucket(1, L, 0))
    n64, emax = n.to(torch.int64), L // 16
    st, _ = press_rice_vb_zd_batch(sig, n, "vbbe21", emax)
    p = parse_exblock_batch("vbbe21", st, torch.full_like(n64, 2), n64 - 1,
                            L, emax)
    off = p["end_off"].to(torch.int32)
    cnt = (n64 - 1 - p["nex"]).to(torch.int32)
    stats = []
    got, _ = model_batch("rice", st.numpy(), off.numpy(), cnt.numpy(), L,
                         stats=stats)
    assert np.array_equal(got, R.rice_decode_plain(st, off, cnt, L).numpy())
    tabs = rows.huffman_tables()
    hs, _ = press_shuff_batch(sig, n, tabs, emax)
    p = vbbe21_parse_batch(hs, torch.full_like(n64, 2), n64 - 1, L, emax)
    hcnt = torch.minimum(read_u32be(hs, p["end_off"]),
                         n64 - 1 - p["nex"]).to(torch.int32)
    hoff = (p["end_off"] + 4).to(torch.int32)
    got, got_n = model_batch("huffman", hs.numpy(), hoff.numpy(),
                             hcnt.numpy(), L, tabs, stats)
    want, want_n = H.huffman_decode_plain(hs, hoff, hcnt, L, tabs)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got_n, want_n.numpy())
    for s in stats:
        assert s["tiles"] >= 2 and s["rounds"] <= s["tiles"] + 1
        assert s["wrong"] > len(s["entries"]) // 2


def test_model_entries_match_jax_compose():
    """The model's true chunk entries of kernel C are those that the JAX
    package's chunked decoder composes (_speculate, _compose_entries at
    C_bits = 1024, as huffman_decode_tpu calls them) wherever a model
    chunk starts on a 1024-bit boundary, on the streams of
    tests/test_huffdec_tpu.py::test_random_and_edges (the only shapes
    compiled)."""
    table = na12878_table()
    rng = np.random.default_rng(3)
    datas = [
        rng.integers(0, 256, 5000).astype(np.uint8),
        rng.integers(0, 40, 3000).astype(np.uint8),
        np.zeros(100, np.uint8),
        rng.integers(0, 256, 1).astype(np.uint8),
        np.full(2000, 255, np.uint8),
    ]
    streams = [huffman_encode(d, table) for d in datas]
    C, Cb, width = 1024, 128, int(table.max_len)
    sym_lut, len_lut = make_decode_lut(table)
    maxsym = C // int(table.lengths[table.lengths > 0].min())
    views, nchunks = [], []
    for s in streams:
        buf = np.frombuffer(s, np.uint8)
        nc = max(1, -(-buf.size // Cb))
        pad = np.zeros(nc * Cb + 4, np.uint8)
        pad[: buf.size] = buf
        views.append(np.stack([pad[i * Cb: i * Cb + Cb + 4]
                               for i in range(nc)]))
        nchunks.append(nc)
    exits, counts = _speculate(jnp.asarray(np.concatenate(views)),
                               jnp.asarray(len_lut), C, width, maxsym)
    entries, starts = _compose_entries(np.asarray(exits), np.asarray(counts),
                                       nchunks, width)
    tabs = rows.huffman_tables()
    stream = rows.place(streams, [0] * len(streams))
    base = compared = 0
    for b, (d, nc) in enumerate(zip(datas, nchunks)):
        s = {}
        out, got = model_decode(Huffman(stream[b], 0, tabs["lut"].numpy()),
                                d.size, d.size, s)
        assert got == d.size and np.array_equal(out, d), b
        for m in range(nc):
            if m * C in s["entries"]:
                assert s["entries"][m * C] == m * C + entries[base + m], (
                    b, m)
                compared += 1
        base += nc
    assert compared >= sum(nchunks) - len(datas)
