"""rccdf on the port's CPU route (engine/rccdf.py, kernels F and G's plain
versions, the rccdf_vb*_zd codecs through engine.runner) vs honours_tpu's
host coder (kernels/rans.py: normalize_freqs, rans_encode_static,
rans_decode_static, rans_encode) and host codecs (codecs/rc.py
RcVbZdCodec): the per-row fit equals normalize_freqs on its hard cases
(a dominant symbol beside 255 the floor sends to 0, one symbol, all 256
equal, random and hypothesis histograms), the header and the body equal
the host's bytes, the codecs' streams equal the host's press for every
read (its press bytes for n = 0 too) and come back, the bounds, the
slice rule and a BLOW5 file across both CLIs.  rccdf is the JAX
package's own format, not the reference C's, so it is held to the host
codec only.  Bytes and samples must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from honours_tpu import cli as jcli
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.io import blow5 as jb
from honours_tpu.kernels import rans as jrans
from honours_tpu_torch import cli
from honours_tpu_torch.engine import rccdf as R
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.engine.permute import rowwise_concat
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.kernels import rans as trans
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RCCDF = [f"rccdf_{k}_zd" for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")]


def _hist(pairs):
    h = np.zeros(256, np.int64)
    for s, c in pairs:
        h[s] = c
    return h


#: histograms where normalize_freqs loops longest or degenerates
HARD = {
    "empty": np.zeros(256, np.int64),
    "one_symbol": _hist([(200, 17)]),
    "all_equal": np.full(256, 3, np.int64),
    # the floor sends 255 symbols to 0 and the lift to 1: diff -255,
    # which only the dominant symbol can pay, a cycle a unit
    "dominant": _hist([(0, 10_000_000)] + [(s, 1) for s in range(1, 256)]),
    "two_dominant": _hist([(5, 4_000_000), (9, 4_000_000)]
                          + [(s, 1) for s in range(10, 250)]),
    "ramp": np.arange(256, dtype=np.int64),
    "ties": _hist([(s, 7) for s in range(0, 256, 3)]),
}


def _rows(hists):
    """Byte rows whose histograms are `hists` (shuffled)."""
    rng = np.random.default_rng(0)
    rows = []
    for h in hists:
        r = np.repeat(np.arange(256), h).astype(np.uint8)
        rng.shuffle(r)
        rows.append(r)
    return rows


@pytest.mark.parametrize("case", list(HARD))
def test_fit_equals_normalize_freqs_on_hard_cases(case):
    h = HARD[case]
    got = R.fit_freqs_batch(torch.from_numpy(h)[None])[0].numpy()
    assert np.array_equal(got, jrans.normalize_freqs(h))
    assert np.array_equal(got, trans.normalize_freqs(h))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 1 << 20), min_size=256, max_size=256),
       st.integers(0, 255))
def test_fit_equals_normalize_freqs_hypothesis(counts, zeros):
    h = np.array(counts, np.int64)
    h[:zeros] = 0
    got = R.fit_freqs_batch(torch.from_numpy(h)[None])[0].numpy()
    assert np.array_equal(got, jrans.normalize_freqs(h))


def test_fit_equals_normalize_freqs_in_one_batch():
    """Every hard case and 40 random sparse histograms in one batch (rows
    that finish early stay as they are)."""
    rng = np.random.default_rng(3)
    hs = list(HARD.values())
    for _ in range(40):
        h = np.where(rng.random(256) < rng.random(), rng.integers(
            1, int(rng.integers(2, 100_000)), 256), 0)
        hs.append(h.astype(np.int64))
    got = R.fit_freqs_batch(torch.from_numpy(np.stack(hs))).numpy()
    for i, h in enumerate(hs):
        assert np.array_equal(got[i], jrans.normalize_freqs(h)), i


@pytest.fixture(scope="module")
def byte_rows():
    """Byte rows: empty, 1 to 17 bytes (lanes without a symbol), one
    symbol, random, residual-like, and the hard histograms' rows."""
    rng = np.random.default_rng(19)
    rows = [np.zeros(0, np.uint8), np.array([9], np.uint8),
            rng.integers(0, 256, 5).astype(np.uint8),
            rng.integers(0, 256, 17).astype(np.uint8),
            np.full(1000, 77, np.uint8),
            rng.integers(0, 256, 3001).astype(np.uint8),
            np.minimum(rng.geometric(0.15, 2500), 255).astype(np.uint8)]
    return rows + _rows([HARD["dominant"][:] // 1000, HARD["all_equal"],
                         HARD["ramp"]])


def _batch(rows):
    N = max(max(r.size for r in rows), 1)
    data = np.zeros((len(rows), N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    return (torch.from_numpy(data),
            torch.tensor([r.size for r in rows], dtype=torch.int64))


def test_header_equals_the_host(byte_rows):
    data, dlen = _batch(byte_rows)
    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen))
    st, sl = rowwise_concat(R.header_segments(freqs), 32 + 384)
    for i, r in enumerate(byte_rows):
        f = jrans.normalize_freqs(np.bincount(r, minlength=256))
        head = trans.rccdf_header(f)
        assert st[i, : int(sl[i])].numpy().tobytes() == head
        assert jrans.rans_encode(r)[: len(head)] == head
        back, n = trans.parse_rccdf_header(head + b"\x99" * 3)
        assert np.array_equal(back, f) and n == len(head)
    back, hlen = R.parse_header_batch(st, torch.zeros_like(dlen))
    assert torch.equal(back, freqs) and torch.equal(hlen, sl)


def test_encode_and_decode_plain_equal_the_host_walks(byte_rows):
    """F's plain version is rans_encode_static's bytes (an empty row: 16
    states of 2^23 and zero lane lengths) and G's gives the rows back as
    rans_decode_static does, from a body placed at an odd offset."""
    data, dlen = _batch(byte_rows)
    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen))
    body, blen = R.rccdf_encode_plain(data, dlen, freqs.to(torch.int32),
                                      R.cum_of(freqs).to(torch.int32))
    assert body.shape[1] == R.body_width(data.shape[1])
    for i, r in enumerate(byte_rows):
        want = jrans.rans_encode_static(r, freqs[i].numpy())
        got = body[i, : int(blen[i])].numpy().tobytes()
        assert got == want, i
        assert not body[i, int(blen[i]):].any()
        assert np.array_equal(jrans.rans_decode_static(
            got, r.size, freqs[i].numpy()), r)
    empty = body[0, :128].numpy()
    assert np.array_equal(empty[:64].view("<u4"), [1 << 23] * 16)
    assert not empty[64:].any()
    off = torch.arange(len(byte_rows)) % 3 + 1
    st = torch.zeros((len(byte_rows), body.shape[1] + 3), dtype=torch.uint8)
    for i in range(len(byte_rows)):
        st[i, int(off[i]): int(off[i]) + body.shape[1]] = body[i]
    back = R.rccdf_decode_plain(st, off, dlen, freqs.to(torch.int32),
                                data.shape[1])
    assert torch.equal(back, data)


def test_decode_plain_stops_at_count_and_reads_zeros_past_the_row(
        byte_rows):
    """Counts short of the row, and a body cut mid-lane: the host's walk
    over the same bytes (zeros past the cut)."""
    data, dlen = _batch(byte_rows[5:7])
    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen))
    body, blen = R.rccdf_encode_plain(data, dlen, freqs.to(torch.int32),
                                      R.cum_of(freqs).to(torch.int32))
    cut = body[:, :200].contiguous()
    for st in (body, cut):
        cnt = dlen // 2
        got = R.rccdf_decode_plain(st, torch.zeros_like(dlen), cnt,
                                   freqs.to(torch.int32), data.shape[1])
        for i in range(2):
            buf = st[i].numpy().tobytes() + b"\0" * 4 * data.shape[1]
            want = jrans.rans_decode_static(buf, int(cnt[i]),
                                            freqs[i].numpy())
            assert np.array_equal(got[i, : int(cnt[i])].numpy(), want)
            assert not got[i, int(cnt[i]):].any()


@pytest.fixture(scope="module")
def edge_reads(fixture_reads):
    """n = 0 to 200: empty, one and two samples, exceptions in every
    framing (one, many, a run past the cap of no container), full-range
    samples, a ramp of -128 steps, a walk, a fixture cut."""
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
    """The port's streams are the host's (n = 0 too); the port decodes
    them (every read back) and the host decodes them for n >= 1."""
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours == [host.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    for r, s in zip(reads, ours):
        if r.size:
            assert np.array_equal(host.depress(s, r.size), r)


@pytest.mark.parametrize("codec", RCCDF)
def test_codec_equals_the_host_codec(edge_reads, codec):
    _check(codec, edge_reads)


@pytest.mark.parametrize("codec", RCCDF)
def test_codec_on_the_fixture_reads(fixture_reads, codec):
    """The three fixture reads (7,329 to 155,185 samples), one bucket."""
    _check(codec, list(fixture_reads))


@pytest.mark.parametrize("codec", RCCDF)
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound(codec, n)
        assert b == get_codec(codec).bound(n) and type(b) is int, n


@pytest.mark.parametrize("codec", RCCDF)
def test_slice_rule_counts_the_table(codec, monkeypatch):
    """Rows a slice: a third of the device's memory over its bytes a slot
    times L plus its rows' table state (rccdf.STATE_BYTES)."""
    gb80 = 85_017_493_504  # an H100 80GB HBM3's total_memory
    monkeypatch.setattr(runner, "device_memory", lambda dev: gb80)
    row = runner.ROW_BYTES[codec]
    assert row == R.STATE_BYTES > 0
    for w in (4096, 1 << 16, 1 << 21):
        r = runner.slice_rows(codec, w, None)
        need = runner.BYTES_A_SLOT[codec] * w + row
        assert r == max(1, int(gb80 * runner.SLICE_SHARE) // need)


def test_blow5_file_across_the_two_clis(tmp_path, edge_reads):
    """A file pressed by the port's CLI with rccdf_vbsse21_zd is restored
    byte for byte by `python -m honours_tpu depress` (host codecs), and a
    file pressed by the host CLI by the port's."""
    src = tmp_path / "src.blow5"
    jb.write_blow5(str(src), jb.Blow5File(
        version=(0, 2, 0), record_press=1, signal_press=1, num_read_groups=1,
        header=b"#\n", reads=[
            jb.Blow5Read(read_id=f"r{i}", read_group=0, digitisation=2048.0,
                         offset=0.0, range=1.0, sampling_rate=4000.0,
                         signal=s, aux=b"")
            for i, s in enumerate(edge_reads[1:])]))
    ours, theirs = tmp_path / "ours.blow5", tmp_path / "theirs.blow5"
    codec = ["--codec", "rccdf_vbsse21_zd"]
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
