"""The raw-sample containers of the port (vb1e2, vbe21, vbbe21, vbsbe21,
vbsse21 over the samples as uint16: engine/vb_batch.py press_vb_batch /
depress_vb_batch; svb and svb0124: press_svb_batch / depress_svb_batch;
svb12_nosimd and svb12_zd_nosimd on svb12's kinds) on the CPU route vs
honours_tpu's host codecs (codecs/vb.py VbCodec, codecs/svb.py) and the
reference C's golden streams (tests/golden/read0/<codec>.0.press, the
sha256 of reads 1 and 2 in tests/golden/manifest.json).  Edge reads:
n = 0, 1 and 2, negative samples (every one an exception), alternating
+-32767, 1,024 and 1,025 samples, flat runs, and seeded random reads.
Bytes and samples must be equal (tolerance 0)."""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from honours_tpu import cli as jcli
from honours_tpu.bench import harness as jharness
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.io import blow5 as jb
from honours_tpu_torch import cli
from honours_tpu_torch.bench import harness
from honours_tpu_torch.engine import rc, runner, vb_batch
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.io import blow5 as tb
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

VB = ["vb1e2", "vbe21", "vbbe21", "vbsbe21", "vbsse21"]
SVB = ["svb", "svb0124"]
NOSIMD = ["svb12_nosimd", "svb12_zd_nosimd"]
CODECS = VB + SVB + NOSIMD
GOLDEN = Path(__file__).resolve().parent / "golden"


def _edge_reads():
    rng = np.random.default_rng(20)
    return [
        np.zeros(0, np.int16), np.array([5], np.int16),
        np.array([-3, 700], np.int16),
        np.array([-32768, -1, 255, 256, 0], np.int16),
        np.tile(np.array([-32767, 32767], np.int16), 35),
        np.full(3000, -32768, np.int16),
        rng.integers(-32768, 32768, 5000).astype(np.int16),
        rng.integers(0, 300, 1024).astype(np.int16),
        rng.integers(-40, 300, 1025).astype(np.int16),
        np.repeat(rng.integers(-50, 2000, 200), 17).astype(np.int16),
        (np.cumsum(rng.integers(-30, 31, 2000)) + 200).astype(np.int16),
        (np.arange(120) * -128).astype(np.int16),
    ]


@pytest.fixture(scope="module")
def edge_reads():
    return _edge_reads()


def _check(codec: str, reads):
    """The port's streams are the host's for every read (n = 0 too); the
    port decodes them and the host's (every read back), and the host
    decodes the port's."""
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours == [host.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    for r, s in zip(reads, ours):
        assert np.array_equal(host.depress(s, r.size), r)
    return ours


@pytest.mark.parametrize("codec", CODECS)
def test_codec_equals_the_host_codec(edge_reads, codec):
    _check(codec, edge_reads)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_on_random_reads(codec, seed):
    """Seeded reads of random lengths: full-range samples, and signals
    around 0 (half negative: exceptions in every vb container)."""
    rng = np.random.default_rng(100 + seed)
    reads = [rng.integers(-32768, 32768, int(rng.integers(1, 900))).astype(
                 np.int16),
             (rng.normal(0, 200, int(rng.integers(1, 3000)))).astype(
                 np.int16)]
    _check(codec, reads)


def _golden_reads():
    """The fixture reads through the port's reader (no honours_tpu)."""
    path = Path(__file__).resolve().parent / "data" / "three-reads.blow5"
    return [r.signal for r in tb.read_blow5(str(path), device="cpu").reads]


@pytest.mark.parametrize("codec", SVB + NOSIMD)
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


@pytest.mark.parametrize("codec", VB)
def test_rows_past_the_exception_cap_are_pressed_alone(codec):
    """A bucket of L = 4096 caps exceptions at emax = 256: a read of 400
    negative samples overflows it (its nex at byte 0 says so), is
    pressed alone with the host's bytes, and decodes alone."""
    rng = np.random.default_rng(7)
    reads = [rng.integers(-200, 0, 400).astype(np.int16),
             rng.integers(0, 255, 3000).astype(np.int16)]
    sig = np.zeros((2, 4096), np.int16)
    n = np.array([400, 3000], np.int32)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    streams = runner.press_bucket(sig, n, codec, device="cpu")
    assert runner._nex_overflowed(streams[0], f"vb:{codec}", 256)
    assert not runner._nex_overflowed(streams[1], f"vb:{codec}", 256)
    assert streams == [get_codec(codec).press(r) for r in reads]
    back = runner.depress_bucket(streams, n, 4096, codec, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(reads, back))


@pytest.mark.parametrize("codec", CODECS)
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound(codec, n)
        assert b == get_codec(codec).bound(n) and type(b) is int, n


def test_raw_block_helpers_have_one_copy():
    """The raw exception block's press and parse live in vb_batch.py
    only; the range-coder codecs over raw samples use them."""
    for name in ("vb_parts", "vb_parse", "vb_fill", "as_i16"):
        assert getattr(rc, name) is getattr(vb_batch, name)
        assert getattr(rc, name).__module__ == vb_batch.__name__
    assert runner.RAW_CODECS["svb12_nosimd"] == runner.CODECS["svb12"]
    assert runner.RAW_CODECS["svb12_zd_nosimd"] == runner.CODECS["svb12_zd"]


def _file_reads():
    """Reads that fit uint11's 11 bits, with means >= 0 (the host's
    uint_zsm depress fails on a negative mean) and samples past 255 (vb
    exceptions)."""
    rng = np.random.default_rng(9)
    return [np.array([5], np.int16),
            rng.integers(0, 2048, 700).astype(np.int16),
            (np.cumsum(rng.integers(-20, 21, 3000)) + 900).clip(
                0, 2047).astype(np.int16),
            np.repeat(rng.integers(0, 300, 40), 33).astype(np.int16)]


@pytest.mark.parametrize("codec", sorted(runner.RAW_CODECS))
def test_bench_row_equals_the_host_row(codec):
    """`bench --methods` takes each of the 16: its TSV row's bound, press
    bytes, ratio and raw bytes are the JAX harness's host row's."""
    reads = _file_reads()
    ours, theirs = io.StringIO(), io.StringIO()
    harness.run_method_tpu(codec, reads, out=ours, device="cpu")
    jharness.run_method(get_codec(codec), reads, out=theirs)
    assert ours.getvalue().split("\t")[:5] == theirs.getvalue().split(
        "\t")[:5]


@pytest.mark.parametrize("codec", sorted(runner.RAW_CODECS))
def test_blow5_file_across_the_two_clis(tmp_path, codec):
    """Each of the 16 raw-sample codecs: a file pressed by the port's CLI
    is the host CLI's (`python -m honours_tpu press`), and each CLI
    restores the other's file byte for byte to the reads (_file_reads)."""
    reads = _file_reads()
    src = tmp_path / "src.blow5"
    jb.write_blow5(str(src), jb.Blow5File(
        version=(0, 2, 0), record_press=1, signal_press=1, num_read_groups=1,
        header=b"#\n", reads=[
            jb.Blow5Read(read_id=f"r{i}", read_group=0, digitisation=2048.0,
                         offset=0.0, range=1.0, sampling_rate=4000.0,
                         signal=r, aux=b"")
            for i, r in enumerate(reads)]))
    ours, theirs = tmp_path / "ours.blow5", tmp_path / "theirs.blow5"
    assert cli.main(["press", str(src), str(ours), "--codec", codec,
                     "--device", "cpu"]) == 0
    jcli.main(["press", str(src), str(theirs), "--codec", codec])
    assert ours.read_bytes() == theirs.read_bytes()
    back, jback = tmp_path / "back.blow5", tmp_path / "jback.blow5"
    jcli.main(["depress", str(ours), str(jback)])
    assert cli.main(["depress", str(theirs), str(back), "--device",
                     "cpu"]) == 0
    assert back.read_bytes() == jback.read_bytes()
    for r, s in zip(tb.read_blow5(str(back)).reads, reads):
        assert np.array_equal(r.signal, s), r.read_id


@pytest.mark.parametrize("codec", sorted(runner.RAW_CODECS))
def test_slices_give_the_unsliced_streams(codec, monkeypatch):
    """A [10, 4096] bucket coded in slices of 3 rows gives the unsliced
    bucket's streams and decodes; the slice rule is a third of the
    device's memory over bytes a slot times L (no row state)."""
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(10, 4096, 5)
    whole = runner.press_bucket(sig, n, codec, device="cpu", rows=10)
    assert runner.press_bucket(sig, n, codec, device="cpu", rows=3) == whole
    back = runner.depress_bucket(whole, n, 4096, codec, device="cpu", rows=3)
    want = sig & 0x7FF if codec == "uint11" else sig
    assert all(np.array_equal(b, want[j, : n[j]]) for j, b in enumerate(back))
    gb80 = 85_017_493_504  # an H100 80GB HBM3's total_memory
    monkeypatch.setattr(runner, "device_memory", lambda dev: gb80)
    assert runner.ROW_BYTES[codec] == 0
    for w in (4096, 1 << 16, 1 << 21):
        assert runner.slice_rows(codec, w, None) == max(
            1, int(gb80 * runner.SLICE_SHARE) // (runner.BYTES_A_SLOT[codec]
                                                  * w))
