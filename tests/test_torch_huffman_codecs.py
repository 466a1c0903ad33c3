"""The Huffman codecs of the port (huffman_vb*_zd: engine/huffman.py with
kernel H's and C2's plain versions; shuffman_vb*_zd: engine/pipeline.py
with kernel C's) on the CPU route vs honours_tpu's host codecs
(codecs/huffman.py: tables/huffman.py build_table and the memory
serialisation, kernels/huffman_np.py) and the reference C's golden
streams (tests/golden/read0/<codec>.0.press, and the sha256 of reads 1
and 2 in tests/golden/manifest.json).  The tables: build_table's tie
rule on tied and Fibonacci histograms (codes of up to 32 bits, from a
histogram alone), the serialisation and its parse; C2's plain version
against the host decode on per-row tables; the codecs' streams equal
the host's press for every read of n >= 1 (huffman's n = 0 too) and
come back; a read whose table has a code of 24 bits; the bounds, the
slice rule and a BLOW5 file across both CLIs.  Bytes and samples must be
equal (tolerance 0)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from honours_tpu import cli as jcli
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.io import blow5 as jb
from honours_tpu.kernels import huffman_np as jhnp
from honours_tpu.tables import huffman as jht
from honours_tpu_torch import cli
from honours_tpu_torch.engine import huffdec_cuda as H
from honours_tpu_torch.engine import huffman as Hf
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.engine.permute import rowwise_concat
from honours_tpu_torch.engine.rc import vb_zd_parse
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.tables import huffman as tht
from entropy_rows import fib_hist, long_code_read
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

KINDS = ("vbe21", "vbbe21", "vbsbe21", "vbsse21")
HUFFMAN = [f"huffman_{k}_zd" for k in KINDS]
SHUFFMAN = [f"shuffman_{k}_zd" for k in KINDS if k != "vbbe21"]
#: the 7 Huffman codecs this slice adds to the port
NEW = HUFFMAN + SHUFFMAN
GOLDEN = Path(__file__).resolve().parent / "golden"


def _hist(pairs):
    h = np.zeros(256, np.int64)
    for s, c in pairs:
        h[s] = c
    return h


#: histograms of the tie rule and the tree's depth
HISTS = {
    "empty": np.zeros(256, np.int64),
    "lone": _hist([(77, 5)]),
    "two": _hist([(3, 1), (250, 1)]),
    "all_equal": np.ones(256, np.int64),
    "1112": _hist([(3, 1), (9, 1), (11, 1), (200, 2)]),
    "merged_ties": _hist(list(zip(range(8), [2, 2, 4, 4, 8, 8, 16, 16]))),
    "fib22": fib_hist(22, at=7),
    "fib31": fib_hist(31),
    "fib32": fib_hist(32, at=100),
    "ramp": np.arange(256, dtype=np.int64),
}


def _random_hists(n: int, seed: int):
    rng = np.random.default_rng(seed)
    hs = []
    for _ in range(n):
        k = int(rng.integers(1, 257))
        h = np.zeros(256, np.int64)
        h[rng.choice(256, k, replace=False)] = rng.choice(
            [1, 2, 3, 4, 6, 8, 13, 100], k)
        hs.append(h)
    return hs


def test_build_plain_equals_build_table():
    """Kernel H's plain version and the port's build_table equal the host
    build_table, in one batch: ties, Fibonacci depths 22, 31 and 32 (F(33)
    = 3,524,578 counts at depth 31), a lone symbol, an empty row and 60
    random sparse histograms with many equal counts."""
    hs = list(HISTS.values()) + _random_hists(60, 5)
    L, C = Hf.huffman_build_plain(torch.from_numpy(np.stack(hs)))
    for i, h in enumerate(hs):
        want = jht.build_table(h)
        mine = tht.build_table(h)
        assert np.array_equal(L[i].numpy(), want.lengths), i
        assert np.array_equal(C[i].numpy().astype(np.uint64), want.codes), i
        assert np.array_equal(mine.lengths, want.lengths)
        assert np.array_equal(mine.codes, want.codes)
        assert np.array_equal(mine.present_mask, want.present_mask)
    assert int(L[list(HISTS).index("fib31")].max()) == 31
    assert int(L[list(HISTS).index("fib32")].max()) == 32


@pytest.mark.parametrize("case", list(HISTS))
def test_serialisation_equals_the_host(case):
    """serialize_memory and parse_memory (the port's copies, and the
    batched table_segments and parse_tables_batch) equal the host's,
    depth 31 and 32 included; dataBytes 0 holds no entries."""
    h = HISTS[case]
    table = jht.build_table(h)
    for data_bytes in ((0, int(h.sum()), 70_000) if h.any() else (0,)):
        blob = jht.serialize_memory(table, data_bytes)
        assert tht.serialize_memory(tht.build_table(h), data_bytes) == blob
        mine, db, off = tht.parse_memory(blob + b"\x55" * 9)
        want, wdb, woff = jht.parse_memory(blob + b"\x55" * 9)
        assert (db, off) == (wdb, woff)
        assert np.array_equal(mine.lengths, want.lengths)
        assert np.array_equal(mine.codes, want.codes)
    L, C = Hf.huffman_build_plain(torch.from_numpy(h)[None])
    dlen = torch.tensor([int(h.sum())])
    st, sl = rowwise_concat(Hf.table_segments(
        torch.from_numpy(h > 0)[None], L, C, dlen), 2048)
    blob = jht.serialize_memory(table, int(h.sum()))
    assert st[0, : int(sl[0])].numpy().tobytes() == blob
    t = Hf.parse_tables_batch(st, torch.tensor([0]))
    want, db, off = jht.parse_memory(blob)
    assert int(t["data_bytes"][0]) == db and int(t["end"][0]) == off
    present = want.present_mask if db else np.zeros(256, bool)
    assert np.array_equal(t["lengths"][0].numpy(),
                          np.where(present, want.lengths, -1))
    assert np.array_equal(t["codes"][0].numpy().astype(np.uint64),
                          np.where(present, want.codes, 0))


def test_parse_takes_a_later_entry_of_a_symbol():
    """A table naming a symbol twice keeps the later entry, as the host's
    parse does."""
    blob = (bytes([1]) + (5).to_bytes(4, "big") + bytes([9, 1, 0])
            + bytes([9, 2, 3]))
    t = Hf.parse_tables_batch(torch.frombuffer(bytearray(blob + b"\0" * 4),
                                               dtype=torch.uint8)[None],
                              torch.tensor([0]))
    want, _, off = jht.parse_memory(blob)
    assert int(t["lengths"][0, 9]) == want.lengths[9] == 2
    assert int(t["codes"][0, 9]) == want.codes[9] == 3
    assert int(t["end"][0]) == off


def test_decode_rows_plain_equals_the_host_decode():
    """C2's plain version with each row's own table (random, lone-symbol,
    empty, depth 23 and 31 tables) equals huffman_np.huffman_decode on
    the host's bits, from odd offsets, with counts short of the data."""
    rng = np.random.default_rng(8)
    hs = [_random_hists(1, 9)[0], HISTS["lone"], HISTS["empty"],
          fib_hist(23), fib_hist(31, at=3), HISTS["1112"]]
    tables = [jht.build_table(h) for h in hs]
    rows = []
    for h in hs:
        syms = np.nonzero(h)[0]
        rows.append(rng.choice(syms, 700).astype(np.uint8) if syms.size
                    else np.zeros(0, np.uint8))
    bits = [jhnp.huffman_encode(r, t) for r, t in zip(rows, tables)]
    B, Mw = len(hs), max(len(b) for b in bits) + 8
    st = np.zeros((B, Mw), np.uint8)
    off = np.arange(B) % 4 + 1
    for i, b in enumerate(bits):
        st[i, off[i]: off[i] + len(b)] = np.frombuffer(b, np.uint8)
    lengths = np.stack([np.where(t.present_mask, t.lengths, -1)
                        for t in tables]).astype(np.int32)
    codes = np.stack([t.codes.astype(np.int64) for t in tables])
    for cut in (0, 100):
        cnt = np.array([max(r.size - cut, 0) for r in rows], np.int32)
        out, got = H.huffman_decode_rows_plain(
            torch.from_numpy(st), torch.from_numpy(off.astype(np.int32)),
            torch.from_numpy(cnt), 800, torch.from_numpy(lengths),
            torch.from_numpy(codes))
        assert got.tolist() == cnt.tolist()
        for i, t in enumerate(tables):
            want = jhnp.huffman_decode(bits[i], int(cnt[i]), t)
            assert np.array_equal(out[i, : cnt[i]].numpy(), want), i
            assert not out[i, cnt[i]:].any()


def test_decode_rows_plain_stops_where_no_code_starts_and_at_row_end():
    """Kernel C's stops with a row's own table: an incomplete code (a
    window no code starts) and bits cut at the row's end."""
    lengths = np.full((2, 256), -1, np.int32)
    codes = np.zeros((2, 256), np.int64)
    lengths[:, 5], codes[:, 5] = 1, 0  # only the zero branch is a code
    lengths[:, 6], codes[:, 6] = 2, 1  # "1 0"; "1 1" starts no code
    st = torch.tensor([[0b11000100, 0], [0b00000000, 0]], dtype=torch.uint8)
    out, got = H.huffman_decode_rows_plain(
        st, torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([20, 20], dtype=torch.int32), 20,
        torch.from_numpy(lengths), torch.from_numpy(codes))
    # row 0: bits 0,0,1,0,0,0,1,1: 5 5 6 5 5 then a window "1 1"
    assert got.tolist() == [5, 8]
    assert out[0, :5].tolist() == [5, 5, 6, 5, 5]


@pytest.fixture(scope="module")
def edge_reads(fixture_reads):
    """n = 0 to 200: empty, one and two samples, exceptions in every
    framing, full-range samples, a ramp of -128 steps, a walk, a fixture
    cut."""
    rng = np.random.default_rng(25)
    return [
        np.zeros(0, np.int16), np.array([5], np.int16),
        np.array([-32768, 32767], np.int16),
        np.array([256, 5, -3, 700], np.int16),
        np.tile(np.array([0, 30000], np.int16), 40),
        rng.integers(-32768, 32768, 60).astype(np.int16),
        (np.arange(120) * -128).astype(np.int16),
        (np.cumsum(rng.integers(-30, 31, 150)) + 500).astype(np.int16),
        fixture_reads[1][5000:5200],
    ]


def _check(codec: str, reads):
    """The port's streams are the host's (for huffman n = 0 too, for
    shuffman n >= 1); the port decodes them (every read back) and the
    host decodes them for n >= 1."""
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    for r, a, b in zip(reads, ours, [host.press(r) for r in reads]):
        if r.size or codec.startswith("huffman"):
            assert a == b, r.size
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    for r, s in zip(reads, ours):
        if r.size:
            assert np.array_equal(host.depress(s, r.size), r)
    return ours


@pytest.mark.parametrize("codec", NEW)
def test_codec_equals_the_host_codec(edge_reads, codec):
    _check(codec, edge_reads)


def _golden_reads():
    """The fixture reads through the port's reader (no honours_tpu)."""
    path = Path(__file__).resolve().parent / "data" / "three-reads.blow5"
    return [r.signal for r in tb.read_blow5(str(path), device="cpu").reads]


@pytest.mark.parametrize("codec", NEW)
def test_codec_equals_the_reference_c(codec):
    """The port's streams of the three fixture reads are the reference
    C's: read 0's bytes, reads 1 and 2 by sha256 and size; every read
    back."""
    reads = _golden_reads()
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours[0] == (GOLDEN / "read0" / f"{codec}.0.press").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    for i in (1, 2):
        want = manifest[f"{codec}.{i}"]
        assert len(ours[i]) == want["size"]
        assert hashlib.sha256(ours[i]).hexdigest() == want["sha256"]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(reads, back))


def test_code_over_22_bits_through_the_codec():
    """huffman_vbbe21_zd over a read whose table has a 24-bit code: the
    host's bytes, and both decodes give it back."""
    read = long_code_read()
    host = get_codec("huffman_vbbe21_zd")
    (ours,) = runner.press_signals([read], "huffman_vbbe21_zd", device="cpu")
    assert ours == host.press(read)
    st = torch.frombuffer(bytearray(ours), dtype=torch.uint8)[None]
    n = torch.tensor([read.size])
    p = vb_zd_parse(st, n, "vbbe21", read.size, read.size, torch.tensor([0]))
    t = Hf.parse_tables_batch(st, p["off"])
    assert int(t["lengths"].max()) == 24
    (back,) = runner.depress_signals([ours], [read.size],
                                     "huffman_vbbe21_zd", device="cpu")
    assert np.array_equal(back, read)
    assert np.array_equal(host.depress(ours, read.size), read)


@pytest.mark.parametrize("codec", NEW)
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound(codec, n)
        assert b == get_codec(codec).bound(n) and type(b) is int, n


@pytest.mark.parametrize("codec", NEW)
def test_slice_rule_counts_the_table(codec, monkeypatch):
    """Rows a slice: a third of the device's memory over its bytes a slot
    times L plus its rows' table state (huffman.STATE_BYTES; none for
    shuffman's canned table)."""
    gb80 = 85_017_493_504  # an H100 80GB HBM3's total_memory
    monkeypatch.setattr(runner, "device_memory", lambda dev: gb80)
    row = runner.ROW_BYTES[codec]
    assert row == (Hf.STATE_BYTES if codec in HUFFMAN else 0)
    for w in (4096, 1 << 16, 1 << 21):
        r = runner.slice_rows(codec, w, None)
        need = runner.BYTES_A_SLOT[codec] * w + row
        assert r == max(1, int(gb80 * runner.SLICE_SHARE) // need)


def test_empty_read_streams():
    """n = 0: huffman's stream is the host's press bytes (no zd0, a table
    of 0xFF and dataBytes 0) and decodes to the empty read; shuffman's
    keeps its zd0 as shuffman_vbbe21_zd's engine does, and decodes too."""
    empty = [np.zeros(0, np.int16)]
    for codec in NEW:
        (st,) = runner.press_signals(empty, codec, device="cpu")
        if codec in HUFFMAN:
            assert st == get_codec(codec).press(empty[0])
            assert st.endswith(b"\xff\x00\x00\x00\x00")
        (back,) = runner.depress_signals([st], [0], codec, device="cpu")
        assert back.size == 0


def test_blow5_file_across_the_two_clis(tmp_path, edge_reads):
    """A file pressed by the port's CLI with huffman_vbsbe21_zd is
    restored byte for byte by `python -m honours_tpu depress` (host
    codecs), and a file pressed by the host CLI by the port's."""
    src = tmp_path / "src.blow5"
    jb.write_blow5(str(src), jb.Blow5File(
        version=(0, 2, 0), record_press=1, signal_press=1, num_read_groups=1,
        header=b"#\n", reads=[
            jb.Blow5Read(read_id=f"r{i}", read_group=0, digitisation=2048.0,
                         offset=0.0, range=1.0, sampling_rate=4000.0,
                         signal=s, aux=b"")
            for i, s in enumerate(edge_reads[1:])]))
    ours, theirs = tmp_path / "ours.blow5", tmp_path / "theirs.blow5"
    codec = ["--codec", "huffman_vbsbe21_zd"]
    assert cli.main(["press", str(src), str(ours), *codec, "--device",
                     "cpu"]) == 0
    jcli.main(["press", str(src), str(theirs), *codec])
    assert ours.read_bytes() == theirs.read_bytes()
    back, jback = tmp_path / "back.blow5", tmp_path / "jback.blow5"
    jcli.main(["depress", str(ours), str(jback)])
    assert cli.main(["depress", str(theirs), str(back), "--device",
                     "cpu"]) == 0
    assert back.read_bytes() == jback.read_bytes()
    for r, s in zip(tb.read_blow5(str(back)).reads, edge_reads[1:]):
        assert np.array_equal(r.signal, s), r.read_id
