"""shuffman_vbbe21_zd in the port vs honours_tpu: the canned table and
its decode LUT, kernel C's plain version (huffman_decode_plain) vs the
host LUT decode (kernels/huffman_np.huffman_decode: numpy and the native
C walk), the batched encode vs the host codec ShuffmanVbZd.press and vs
the JAX engine's press_shuff_batch (only at the [6, 1024] shape that
tests/test_engine_pipeline.py compiles), and round trips through the
runner and the CLI.  Bytes, symbols and samples must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

from honours_tpu.codecs import base as registry
from honours_tpu.engine import pipeline as jpipe
from honours_tpu.io import blow5 as jb
from honours_tpu.kernels import huffman_np as jhuff
from honours_tpu.tables import huffman as jtab
from honours_tpu_torch import cli
from honours_tpu_torch.engine import huffdec_cuda as H
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.pipeline import (
    canned_huffman_tables,
    press_shuff_batch,
)
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.kernels.huffman import make_decode_lut
from honours_tpu_torch.tables import huffman as ttab
from test_torch_blow5 import src_file  # noqa: F401  (fixture)
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

NAME = "shuffman_vbbe21_zd"
L = 1024
#: the JAX engine's bytes for an empty read: zd0 0, nex 0, dataBytes
#: n - 1 = -1 as u32 BE, no bits (the host codec writes 8 zero bytes)
EMPTY_ENGINE = bytes.fromhex("000000000000ffffffff")


def ramp(m: int) -> np.ndarray:
    """A read falling by 128 a sample (int16 wrap): every residual byte
    is 255, whose code is the longest (22 bits)."""
    return ((-128 * np.arange(m)) & 0xFFFF).astype(np.uint16).view(np.int16)


@pytest.fixture(scope="module")
def tabs():
    return canned_huffman_tables("cpu")


@pytest.fixture(scope="module")
def edge_reads(fixture_reads):
    rng = np.random.default_rng(5)
    return [
        fixture_reads[0][:3000], fixture_reads[1][40_000:43_000],
        fixture_reads[2][:3000],
        np.tile(np.array([-32768, 32767], np.int16), 35),
        np.full(3000, -32768, np.int16),
        np.array([7], np.int16), np.array([7, -9], np.int16),
        rng.integers(400, 700, 1024).astype(np.int16),
        rng.integers(400, 700, 1025).astype(np.int16),
        ramp(1000),
        np.zeros(0, np.int16),
    ]


def test_table_and_lut_equal_reference(tabs):
    ours, theirs = ttab.na12878_table(), jtab.na12878_table()
    assert np.array_equal(ours.lengths, theirs.lengths)
    assert np.array_equal(ours.codes, theirs.codes)
    assert np.array_equal(ours.present_mask, theirs.present_mask)
    assert ours.max_len == theirs.max_len == H.LUT_BITS
    for a, b in zip(make_decode_lut(ours), jhuff.make_decode_lut(theirs)):
        assert np.array_equal(a, b)
    # kernel C's tables: sym | len << 8, and its 12-bit first level
    sym, ln = jhuff.make_decode_lut(theirs)
    lut = tabs["lut"].numpy().astype(np.int64)
    assert np.array_equal(lut & 0xFF, sym) and np.array_equal(lut >> 8, ln)
    l1 = tabs["l1"].numpy().astype(np.int64)
    W = 1 << H.L1_BITS
    assert np.array_equal(l1 == 0, (ln[:W] == 0) | (ln[:W] > H.L1_BITS))
    assert np.array_equal(l1[l1 > 0] & 0xFFFF, lut[:W][l1 > 0])
    # every 22-bit window that starts with a 12-bit window of one code
    # decodes that code and then the next, which l1 holds where it ends
    # within the 12 bits
    for hi in (0, 0x3FF, 0x2A5):
        w = np.flatnonzero(l1)
        n1 = ln[w].astype(np.int64)
        rest = (w | hi << H.L1_BITS) >> n1
        n12 = n1 + ln[rest]
        inside = n12 <= H.L1_BITS
        assert np.array_equal(l1[w] >> 24, np.where(inside, n12, 0))
        assert np.array_equal(l1[w] >> 16 & 0xFF,
                              np.where(inside, sym[rest], 0))
    assert (l1 >> 24 > 0).sum() > W // 2


def _rows(streams, pad: int, tail: int):
    """Streams placed pad + i % 4 bytes into rows of 0xEE bytes, zeros
    after each stream and `tail` zero bytes past the longest."""
    M = max(len(s) for s in streams) + pad + 3 + tail
    st = np.full((len(streams), M), 0xEE, np.uint8)
    off = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        o = pad + i % 4
        st[i, o:] = 0
        st[i, o: o + len(s)] = np.frombuffer(s, np.uint8)
        off[i] = o
    return torch.from_numpy(st), torch.from_numpy(off)


@pytest.mark.parametrize("pad,tail", [(0, 0), (1, 5), (6, 0)])
def test_plain_decode_matches_host(tabs, pad, tail):
    """tests/test_huffdec_tpu.py's rows (random, few symbols, zeros, one
    symbol, 2,000 x 255 of the longest code) and an empty row."""
    table = jtab.na12878_table()
    rng = np.random.default_rng(3)
    datas = [
        rng.integers(0, 256, 5000).astype(np.uint8),
        rng.integers(0, 40, 3000).astype(np.uint8),
        np.zeros(100, np.uint8),
        rng.integers(0, 256, 1).astype(np.uint8),
        np.full(2000, 255, np.uint8),
        np.zeros(0, np.uint8),
    ]
    streams = [jhuff.huffman_encode(d, table) for d in datas]
    st, off = _rows(streams, pad, tail)
    cnt = torch.tensor([d.size for d in datas], dtype=torch.int32)
    N = 5003
    out, got = H.huffman_decode(st, off, cnt, N, tabs)
    assert out.shape == (len(datas), N) and out.dtype == torch.uint8
    assert got.tolist() == cnt.tolist()
    for i, (d, s) in enumerate(zip(datas, streams)):
        host = jhuff.huffman_decode(s, d.size, table)
        assert np.array_equal(out[i, : d.size].numpy(), host), i
        assert np.array_equal(host, d), i
        assert not out[i, d.size:].any(), i


def test_plain_decode_stops_short(tabs):
    """A code that runs past the row's end, and a window no code starts
    (an incomplete code's table): the walk stops there, got says where,
    zeros follow; the native C stops at the same zero length."""
    table = jtab.na12878_table()
    data = np.random.default_rng(4).integers(0, 256, 400).astype(np.uint8)
    s = jhuff.huffman_encode(data, table)
    ends = np.cumsum(table.lengths[data])
    for M in (1, 3, len(s) // 2, len(s) - 1, len(s)):
        st = torch.from_numpy(np.frombuffer(s[:M], np.uint8).copy())[None]
        out, got = H.huffman_decode(st, torch.zeros(1, dtype=torch.int32),
                                    torch.tensor([400], dtype=torch.int32),
                                    400, tabs)
        want = int((ends <= 8 * M).sum())
        assert int(got[0]) == want, M
        assert np.array_equal(out[0, :want].numpy(), data[:want]), M
        assert not out[0, want:].any(), M

    # codes 7 -> 0 and 9 -> 1, 0 (LSB-first); a window starting 1, 1 has
    # no code
    part = jtab.HuffmanTable(np.zeros(256, np.int32), np.zeros(256, np.uint64))
    part.lengths[[7, 9]] = [1, 2]
    part.codes[[7, 9]] = [0, 1]
    part.present_mask = part.lengths > 0
    ptabs = H.decode_tables(part, "cpu")
    stream = bytes([0b11_01_0_01_0])  # 7, 9, 7, 9, then 1, 1
    out, got = H.huffman_decode(
        torch.tensor([list(stream) + [0, 0]], dtype=torch.uint8),
        torch.zeros(1, dtype=torch.int32),
        torch.tensor([6], dtype=torch.int32), 8, ptabs)
    assert int(got[0]) == 4
    assert out[0].tolist() == [7, 9, 7, 9, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="decoded 4 of 6"):
        jhuff.huffman_decode(stream, 6, part)


def _padded(reads, width):
    sig = np.zeros((len(reads), width), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    n = np.array([r.size for r in reads], np.int32)
    return sig, n


def _rows_of(stream, slen):
    return [stream[i, : int(slen[i])].numpy().tobytes()
            for i in range(stream.shape[0])]


def test_encode_matches_host_codec(edge_reads, tabs):
    """press_shuff_batch (uncapped) and the runner (buckets of 4, the
    alternation overflowing the cap) give the host codec's bytes for
    every read of n >= 1, the JAX engine's for the empty read."""
    host = registry.get(NAME)
    sig, n = _padded(edge_reads, 3072)
    ours = _rows_of(*press_shuff_batch(torch.from_numpy(sig),
                                       torch.from_numpy(n), tabs))
    streams = runner.press_signals(edge_reads, NAME, max_b=4, device="cpu")
    for i, s in enumerate(edge_reads):
        want = host.press(s) if s.size else EMPTY_ENGINE
        assert ours[i] == want, i
        assert streams[i] == want, i
    # the ramp's 999 codes of 22 bits take 2,748 bytes: more than the
    # 2L + 8 that honours_tpu's engine sizes the bits for at its bucket's
    # L = 1024 (ROADMAP.md watch list)
    assert len(streams[9]) > 2 * L + 8


@pytest.fixture(scope="module")
def engine_batches(fixture_reads):
    """tests/test_engine_pipeline.py's batch, and six more reads at
    L = 1024 with an empty one and a ramp of 22-bit codes."""
    rng = np.random.default_rng(11)
    first = [
        fixture_reads[0][:L],
        fixture_reads[1][500: 500 + L // 2],
        np.array([256, 5, -3, 700, 0, 0, 0, 1], np.int16),
        np.zeros(5, np.int16),
        rng.integers(-600, 600, 321).astype(np.int16),
        np.tile(np.array([0, 30000], np.int16), 200),
    ]
    second = [
        np.zeros(0, np.int16), fixture_reads[2][5000: 5000 + L],
        np.array([3], np.int16), ramp(600),
        np.tile(np.array([-32768, 32767], np.int16), 35),
        np.full(L - 1, 600, np.int16),
    ]
    return first, second


def _both_engines(reads, tabs):
    lengths, codes = jpipe.canned_huffman_tables()
    sig, n = jpipe.pad_batch(reads, L)
    assert sig.shape == (6, L)
    jst, jsl = jpipe.press_shuff_batch(sig, n, lengths, codes)
    theirs = [np.asarray(jst)[i, : int(m)].tobytes()
              for i, m in enumerate(np.asarray(jsl))]
    ours = _rows_of(*press_shuff_batch(
        torch.from_numpy(np.array(sig)), torch.from_numpy(np.array(n)),
        tabs))
    return ours, theirs


def test_encode_matches_jax_engine(engine_batches, tabs):
    for reads in engine_batches:
        ours, theirs = _both_engines(reads, tabs)
        assert ours == theirs
    assert ours[0] == EMPTY_ENGINE


def test_encode_sizes_bits_for_the_longest_codes(engine_batches, tabs):
    """honours_tpu's engine sizes a row's bits for 2L + 8 bytes; a ramp
    of 1,000 samples (999 codes of 22 bits, 2,748 bytes) overflows it,
    and only the port's stream is the host codec's (ROADMAP.md watch
    list).  The other rows agree."""
    reads = list(engine_batches[1])
    reads[3] = ramp(1000)
    ours, theirs = _both_engines(reads, tabs)
    assert ours[3] == registry.get(NAME).press(reads[3])
    assert len(theirs[3]) == len(ours[3])
    assert [i for i in range(6) if ours[i] != theirs[i]] == [3]


def test_round_trips(edge_reads):
    """The port's streams and the host codec's (its empty read's 8 zero
    bytes, and the JAX engine's form) decode in the port."""
    lens = [s.size for s in edge_reads]
    host = registry.get(NAME)
    ours = runner.press_signals(edge_reads, NAME, max_b=4, device="cpu")
    theirs = [host.press(s) for s in edge_reads]
    assert theirs[-1] == bytes(8) and ours[-1] == EMPTY_ENGINE
    for streams in (ours, theirs):
        out = runner.depress_signals(streams, lens, NAME, max_b=4,
                                     device="cpu")
        for i, s in enumerate(edge_reads):
            assert out[i].dtype == np.int16 and np.array_equal(out[i], s), i
        # the host codec decodes the port's streams (n >= 1)
        for i, s in enumerate(edge_reads[:-1]):
            assert np.array_equal(host.depress(streams[i], s.size), s), i


def test_cut_stream_raises(edge_reads):
    s = edge_reads[0]
    st = runner.press_signals([s], NAME, device="cpu")[0]
    with pytest.raises(ValueError, match="corrupt"):
        runner.depress_signals([st[: len(st) // 2]], [s.size], NAME,
                               device="cpu")


def test_cli_round_trip_decodes_in_reference(tmp_path, src_file,
                                             mixed_reads):
    ours, back = tmp_path / "ours.blow5", tmp_path / "back.blow5"
    assert cli.main(["press", str(src_file), str(ours), "--codec", NAME,
                     "--device", "cpu"]) == 0
    f5 = tb.read_blow5(str(ours), decode_signal=False)
    assert tb.htpu_codec_name(f5.header) == NAME
    assert [r.signal_stream for r in f5.reads] == runner.press_signals(
        mixed_reads, NAME, device="cpu")
    # honours_tpu decodes the file with its host codec
    for r, s in zip(jb.read_blow5(str(ours)).reads, mixed_reads):
        assert np.array_equal(r.signal, s), r.read_id
    assert cli.main(["depress", str(ours), str(back), "--device", "cpu"]) == 0
    got = tb.read_blow5(str(back))
    assert got.signal_press == tb.SIGNAL_PRESS_SVB_ZD
    for r, s in zip(got.reads, mixed_reads):
        assert np.array_equal(r.signal, s), r.read_id
