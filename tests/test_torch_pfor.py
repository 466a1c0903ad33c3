"""turbopfor in the port (engine/pfor.py over the plain versions of
kernels I, J, M and kernel 1) vs honours_tpu's host codec
(codecs/pfor.py TurboPforCodec): the streams equal the host's press
byte for byte for every read, n = 0 included, in one bucket and alone,
and both decodes give the reads back from either package's streams.
The reads: every length around the 128-value blocks (0-5, 127-129,
4,095-4,097, 8,193), full-range samples (b = 16), a block at b = 0 whose
exceptions' high parts are 16 bits wide, flat and ramp reads, walks,
the main-path fixture reads.  Bytes and samples must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

import block_rows
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.codecs.pfor import _choose_b
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.engine.pfor import depress_pfor_batch, press_pfor_batch
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

HOST = get_codec("turbopfor")


def _round(reads):
    ours = runner.press_signals(reads, "turbopfor", device="cpu")
    assert ours == [HOST.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads],
                                  "turbopfor", device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    return ours


@pytest.mark.parametrize("seed", [0, 1])
def test_streams_equal_the_host_codec(seed):
    ours = _round(block_rows.block_reads(seed))
    assert ours[0] == b""


def test_fixture_reads(fixture_reads):
    """The three main-path fixture reads (7,329, 155,185 and 95,350
    samples); the host decodes the port's streams."""
    ours = _round(list(fixture_reads))
    for r, s in zip(fixture_reads, ours):
        assert np.array_equal(HOST.depress(s, r.size), r)


def test_widths_equal_choose_b():
    """Every block's width byte is _choose_b's: the first cheapest over b
    = 0..16 (b = 16 for the full-range read, 0 for the wide
    exceptions)."""
    reads = block_rows.block_reads(3)
    sig, n = block_rows.pad_rows(reads, align=128)
    st, sl = press_pfor_batch(torch.from_numpy(sig), torch.from_numpy(n))
    from honours_tpu.transforms.core import zigdelta

    seen = set()
    for i, r in enumerate(reads):
        s = st[i, : int(sl[i])].numpy().tobytes()
        z = zigdelta(r)
        off = 0
        for a in range(0, r.size, 128):
            blk = z[a: a + 128].astype(np.uint16)
            assert s[off] == _choose_b(blk), (i, a)
            seen.add(s[off])
            blen = blk.size
            off += 2 + (blen * s[off] + 7) // 8 + 3 * s[off + 1]
        assert off == len(s)
    assert {0, 16} <= seen


def test_wide_exceptions():
    """A flat read with jumps of +-32,767: b = 0, and the exceptions' high
    parts are the zigzag deltas whole, 16 bits wide."""
    read = block_rows.wide_exceptions_read()
    (s,) = _round([read])
    assert s[0] == 0 and s[1] > 0
    hi = np.frombuffer(s, "<u2", count=s[1], offset=2 + s[1])
    assert hi.max() >= 1 << 15


def test_batched_press_and_depress_at_several_widths():
    """press_pfor_batch / depress_pfor_batch on one bucket at the reads'
    width and wider (L a multiple of 128 and not): the same streams,
    zeros past n."""
    reads = block_rows.block_reads(4)[:16]
    want = [HOST.press(r) for r in reads]
    for L in (8193, 8320, 9001):
        sig, n = block_rows.pad_rows(reads, L)
        st, sl = press_pfor_batch(torch.from_numpy(sig), torch.from_numpy(n))
        got = [st[i, : int(sl[i])].numpy().tobytes() for i in range(len(n))]
        assert got == want
        out = depress_pfor_batch(torch.from_numpy(block_rows.stream_rows(
            want, 5)), torch.from_numpy(n), L)
        assert out.shape == (len(reads), L) and out.dtype == torch.int16
        assert np.array_equal(out.numpy(), sig)


def test_cut_streams_read_zeros_past_the_row():
    """Streams cut inside a block's header or low bits decode as the host
    decodes them padded with zeros: a byte past the row reads as 0."""
    read = block_rows.walk(np.random.default_rng(8), 700)
    s = HOST.press(read)
    offs, cuts = [], []
    off = 0
    for a in range(0, read.size, 128):
        offs.append(off)
        blen = min(128, read.size - a)
        off += 2 + (blen * s[off] + 7) // 8 + 3 * s[off + 1]
    for o in offs[:4]:
        cuts += [s[:o], s[: o + 1], s[: o + 2 + s[o] * 8]]
    out = depress_pfor_batch(torch.from_numpy(block_rows.stream_rows(cuts)),
                             torch.full((len(cuts),), read.size), 704)
    assert out.shape == (len(cuts), 704)
    for i, c in enumerate(cuts):
        want = HOST.depress(c + bytes(3 * read.size + 64), read.size)
        assert np.array_equal(out[i, : read.size].numpy(), want), i
        assert not out[i, read.size:].any()


def test_bound_equals_the_host_codec():
    for n in (0, 1, 127, 128, 4097, 155185, 3_000_001):
        b = bound("turbopfor", n)
        assert b == HOST.bound(n) == 3 * n + 64 and type(b) is int
