"""Kernel M's plain version (engine/hdrwalk_cuda.py hdrwalk_plain, the
segment-header walk of turbopfor's blocks and flat_uint_submin's
segments) against a row-by-row numpy model (tests/block_rows.py
hdrwalk_np) on the host codecs' streams, on random bytes, on cut streams
(a byte past a row reads as 0), first offsets past the row, negative
counts and segment counts past S; and the offsets on the host codecs'
streams against the offsets their depress walks.  Offsets must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

import block_rows
from honours_tpu.codecs.base import get as get_codec
from honours_tpu_torch.engine.hdrwalk_cuda import (
    FLATS,
    TURBOPFOR,
    hdrwalk,
    hdrwalk_plain,
)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

FORMATS = {"turbopfor": TURBOPFOR, "flats": FLATS}


def _model(stream, first, nseg, counts, fmt):
    return np.array([block_rows.hdrwalk_np(stream[b], int(first[b]),
                                           int(nseg[b]), counts[b], fmt)
                     for b in range(stream.shape[0])], np.int64)


def _both(stream, first, nseg, counts, fmt):
    got = hdrwalk_plain(*[torch.from_numpy(np.ascontiguousarray(a))
                          for a in (stream, first, nseg, counts)], fmt)
    assert got.dtype == torch.int64 and got.shape == counts.shape
    want = _model(stream, first, nseg, counts, fmt)
    assert np.array_equal(got.numpy(), want)
    return want


def _pfor_rows(reads):
    """turbopfor's host streams of `reads` and each block's item count."""
    streams = [get_codec("turbopfor").press(r) for r in reads]
    S = max(1, max(-(-r.size // 128) for r in reads))
    counts = np.zeros((len(reads), S), np.int64)
    for i, r in enumerate(reads):
        m = -(-r.size // 128)
        counts[i, :m] = np.minimum(128, r.size - 128 * np.arange(m))
    nseg = np.array([-(-r.size // 128) for r in reads], np.int64)
    return streams, counts, nseg


def _host_pfor_offsets(stream: bytes, n: int):
    """The offsets TurboPforCodec.depress walks, written out."""
    out, off = [], 0
    for a in range(0, n, 128):
        blen = min(128, n - a)
        out.append(off)
        b, nex = stream[off], stream[off + 1]
        off += 2 + (blen * b + 7) // 8 + 3 * nex
    return out, off


def test_turbopfor_offsets_equal_the_host_walk():
    """On turbopfor's host streams of the edge and block reads: every
    block's offset is the host depress's, and past the last block the
    walk ends at the stream's length."""
    reads = block_rows.block_reads(1)
    streams, counts, nseg = _pfor_rows(reads)
    buf = block_rows.stream_rows(streams)
    got = _both(buf, np.zeros(len(reads), np.int64), nseg, counts,
                TURBOPFOR)
    for i, (r, s) in enumerate(zip(reads, streams)):
        offs, end = _host_pfor_offsets(s, r.size)
        assert got[i, : len(offs)].tolist() == offs
        assert end == len(s)
        assert (got[i, len(offs):] == end).all()


def test_flats_offsets_equal_the_codec():
    """On flat_uint_submin's host streams: from the first segment header
    (after [nseg:u32] and the svb32 of the lengths) over the partition's
    segment lengths, every header's width byte is its segment's, and the
    walk ends at the stream's length."""
    import raw_rows
    from honours_tpu.codecs.flats import partition_flats

    reads = [r for r in raw_rows.flats_reads(64) if r.size]
    host = get_codec("flat_uint_submin")
    streams = [host.press(r) for r in reads]
    cuts = [partition_flats(r.view(np.uint16), host.step) for r in reads]
    nseg = np.array([len(c) - 1 for c in cuts], np.int64)
    # a column past the longest: every row's walk ends in it
    counts = np.zeros((len(reads), int(nseg.max()) + 1), np.int64)
    first = np.zeros(len(reads), np.int64)
    for i, c in enumerate(cuts):
        lens = np.diff(c)
        counts[i, : lens.size] = lens
        # svb32 (1234): a key byte a 4 lengths, 1-4 bytes a length
        first[i] = 4 + -(-lens.size // 4) + sum(
            max(1, (int(m).bit_length() + 7) // 8) for m in lens)
    buf = block_rows.stream_rows(streams, extra=8)
    got = _both(buf, first, nseg, counts, FLATS)
    for i, (r, c, s) in enumerate(zip(reads, cuts, streams)):
        assert got[i, -1] == len(s)
        u = r.view(np.uint16).astype(np.int64)
        for j, (a, b) in enumerate(zip(c, c[1:])):
            width = int(u[a:b].max() - u[a:b].min()).bit_length()
            assert int(buf[i, got[i, j] + 2]) == width


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_the_model_on_random_bytes(fmt, seed):
    """Random bytes (widths up to 255, exception counts up to 255), random
    counts (some negative), segment counts from -1 to past S, first
    offsets inside, at and past the row's end and negative."""
    rng = np.random.default_rng(seed)
    B, M, S = 24, 300, 40
    stream = rng.integers(0, 256, (B, M)).astype(np.uint8)
    stream[: B // 2] &= 0x1F  # small widths: many segments fit
    counts = rng.integers(-3, 200, (B, S)).astype(np.int64)
    nseg = rng.integers(-1, S + 5, B).astype(np.int64)
    first = rng.integers(0, M // 4, B).astype(np.int64)
    first[:4] = [M, M - 1, -2, 10 * M]
    _both(stream, first, nseg, counts, FORMATS[fmt])


def test_cut_streams_read_zeros_past_the_row():
    """turbopfor's streams cut to every length a few blocks in: the walk
    reads the missing bytes as 0, so a block past the cut is 2 bytes."""
    reads = [block_rows.walk(np.random.default_rng(9), 1000)]
    streams, counts, nseg = _pfor_rows(reads)
    s = streams[0]
    cut = [s[:m] for m in range(0, min(len(s), 60))]
    buf = block_rows.stream_rows(cut)
    B = len(cut)
    got = _both(buf, np.zeros(B, np.int64), np.repeat(nseg, B),
                np.repeat(counts, B, axis=0), TURBOPFOR)
    assert got[0].tolist() == [2 * s for s in range(counts.shape[1])]


def test_empty_rows_and_no_segments():
    """S = 0, a row of width 0 and segment counts of 0."""
    for B, M, S in ((3, 8, 0), (2, 0, 4), (1, 5, 3)):
        stream = np.full((B, M), 7, np.uint8)
        counts = np.full((B, S), 5, np.int64)
        _both(stream, np.zeros(B, np.int64), np.zeros(B, np.int64), counts,
              TURBOPFOR)
        _both(stream, np.ones(B, np.int64), np.full(B, S, np.int64), counts,
              FLATS)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    reads = block_rows.block_reads(2)[:8]
    streams, counts, nseg = _pfor_rows(reads)
    args = [torch.from_numpy(a) for a in (block_rows.stream_rows(streams),
                                          np.zeros(len(reads), np.int64),
                                          nseg, counts)]
    assert torch.equal(hdrwalk(*args, TURBOPFOR),
                       hdrwalk_plain(*args, TURBOPFOR))
