"""The bit-packing codecs of the port (uintx_16, uint11, uint,
uint_submin, uint_zd, uint_zsm: engine/uint.py) on the CPU route, and the
plain versions of kernels I and J (engine/bitpack.py) and L
(uint.zsm_mean_plain), vs honours_tpu's host codecs (codecs/uintc.py),
its bit packer (kernels/bitpack.py) and the reference C's golden streams
(tests/golden).  uint11 keeps 11 bits a sample, so the port gives the
host's bytes and the host's decoded values, not the read.  The host's
depress fails on two kinds of stream that it presses (uint_zd of an
empty read; uint_zsm with a negative mean, whose np.uint16(mean)
overflows): the port decodes them.  Bytes and samples must be equal
(tolerance 0)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import raw_rows
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.codecs.uintc import UintZsmCodec
from honours_tpu.kernels import bitpack as jbp
from honours_tpu.transforms import core as jtc
from honours_tpu_torch.engine import bitpack, runner, uint
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.transforms.core import unzigzag16, zigzag16
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CODECS = ["uintx_16", "uint11", "uint", "uint_submin", "uint_zd", "uint_zsm"]
GOLDEN = Path(__file__).resolve().parent / "golden"


def _edge_reads():
    rng = np.random.default_rng(21)
    return [
        np.zeros(0, np.int16), np.array([5], np.int16),
        np.array([-3, 700], np.int16), np.array([-3, -4, -5], np.int16),
        np.tile(np.array([-32767, 32767], np.int16), 35),
        np.full(3000, -32768, np.int16), np.full(50, 2047, np.int16),
        rng.integers(-32768, 32768, 2000).astype(np.int16),
        rng.integers(0, 2048, 1024).astype(np.int16),
        rng.integers(-40, 300, 1025).astype(np.int16),
        np.repeat(rng.integers(0, 2000, 200), 17).astype(np.int16),
        (np.cumsum(rng.integers(-30, 31, 3000)) + 200).astype(np.int16),
        raw_rows.drift_read(),
    ]


def _host_depress(host, stream, n):
    """The host's depress, or None where it fails on a stream it pressed
    (uint_zd of n = 0; uint_zsm with a negative mean)."""
    try:
        return host.depress(stream, n)
    except (ValueError, OverflowError):
        return None


@pytest.mark.parametrize("codec", CODECS)
def test_codec_equals_the_host_codec(codec):
    """Press bytes equal the host's for every read, n = 0 included; the
    port decodes them (every read back, uint11 to the host's 11-bit
    values); the host decodes the port's streams wherever its depress
    runs, and fails only where the docstring says."""
    reads = _edge_reads()
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours == [host.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    failed = []
    for r, s, b in zip(reads, ours, back):
        theirs = _host_depress(host, s, r.size)
        if theirs is None:
            failed.append(r)
        else:
            assert np.array_equal(b, theirs)
        if codec != "uint11":
            assert b.dtype == np.int16 and np.array_equal(b, r)
    if codec == "uint_zd":
        assert [r.size for r in failed] == [0]
    elif codec == "uint_zsm":
        assert failed and all(UintZsmCodec._mean16(r) < 0 for r in failed)
    else:
        assert not failed


def test_uint11_is_lossy_as_the_host():
    """uint11 keeps each sample's low 11 bits: the port's decode is the
    host's, which differs from reads with a sample outside [0, 2048)."""
    reads = _edge_reads()
    ours = runner.press_signals(reads, "uint11", device="cpu")
    back = runner.depress_signals(ours, [r.size for r in reads], "uint11",
                                  device="cpu")
    lossy = [not np.array_equal(b, r) for r, b in zip(reads, back)]
    for r, b, bad in zip(reads, back, lossy):
        assert np.array_equal(b, (r.astype(np.int64) & 0x7FF).astype(
            np.int16))
        assert bad == bool(((r < 0) | (r >= 2048)).any())
    assert any(lossy) and not all(lossy)


@pytest.mark.parametrize("codec", ["uint", "uint_submin", "uint_zd",
                                   "uint_zsm", "uint11"])
def test_codec_equals_the_reference_c(codec):
    """The port's streams of the three fixture reads are the reference
    C's: read 0's bytes, reads 1 and 2 by sha256 and size."""
    path = Path(__file__).resolve().parent / "data" / "three-reads.blow5"
    reads = [r.signal for r in tb.read_blow5(str(path), device="cpu").reads]
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours[0] == (GOLDEN / "read0" / f"{codec}.0.press").read_bytes()
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    for i in (1, 2):
        want = manifest[f"{codec}.{i}"]
        assert len(ours[i]) == want["size"]
        assert hashlib.sha256(ours[i]).hexdigest() == want["sha256"]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    if codec != "uint11":
        assert all(np.array_equal(a, b) for a, b in zip(reads, back))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_plain_equals_pack_bits(seed):
    """Kernel I's plain version on ragged rows (every width 0..16, counts
    0, 1, 2 and random, 32-bit values of which the low b bits count, rows
    laid with gaps into memory poisoned with 0xA5) equals pack_bits row
    for row and leaves every byte outside the rows."""
    values, val_off, count, width = raw_rows.ragged_rows(seed)
    nbytes = (count * width + 7) // 8
    out_off, O = raw_rows.layout(nbytes, seed)
    out = torch.full((O,), 0xA5, dtype=torch.uint8)
    bitpack.pack_msb_plain(*map(torch.from_numpy, (values, val_off, count,
                                                   width)),
                           out, torch.from_numpy(out_off))
    keep = np.ones(O, bool)
    for r in range(len(count)):
        k, b = int(count[r]), int(width[r])
        v = (values[val_off[r]: val_off[r] + k].astype(np.int64)
             & ((1 << b) - 1))
        got = out[out_off[r]: out_off[r] + nbytes[r]].numpy().tobytes()
        assert got == jbp.pack_bits(v, b), r
        keep[out_off[r]: out_off[r] + nbytes[r]] = False
    assert (out.numpy()[keep] == 0xA5).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_plain_equals_unpack_bits(seed):
    """Kernel J's plain version on the same rows equals unpack_bits, also
    from a stream cut to half its bytes, where a byte past a row's
    length reads as 0 (unpack_bits of the cut bytes padded with zeros:
    np.unpackbits past its input is undefined), and one past the
    stream's end."""
    values, val_off, count, width = raw_rows.ragged_rows(seed)
    nbytes = (count * width + 7) // 8
    out_off, O = raw_rows.layout(nbytes, seed)
    packed = torch.zeros(O, dtype=torch.uint8)
    c, w = torch.from_numpy(count), torch.from_numpy(width)
    bitpack.pack_msb_plain(torch.from_numpy(values),
                           torch.from_numpy(val_off), c, w, packed,
                           torch.from_numpy(out_off))
    f_off, F = raw_rows.layout(count, seed + 5)
    for cut in (1, 2):
        in_len = nbytes // cut
        out = torch.full((F,), -7, dtype=torch.int32)
        bitpack.unpack_msb_plain(packed, torch.from_numpy(out_off),
                                 torch.from_numpy(in_len), c, w, out,
                                 torch.from_numpy(f_off))
        for r in range(len(count)):
            k, b = int(count[r]), int(width[r])
            src = packed[out_off[r]: out_off[r] + in_len[r]].numpy()
            src = np.pad(src, (0, nbytes[r] - in_len[r]))
            want = jbp.unpack_bits(src.tobytes(), b, k, np.uint32)
            got = out[f_off[r]: f_off[r] + k].numpy().astype(np.uint32)
            assert np.array_equal(got, want), (cut, r)
    # a row whose bytes run past the stream's end reads zeros there
    out = torch.zeros(4, dtype=torch.int32)
    bitpack.unpack_msb_plain(torch.tensor([0xFF, 0xFF], dtype=torch.uint8),
                             torch.tensor([1]), torch.tensor([9]),
                             torch.tensor([4]), torch.tensor([6]), out,
                             torch.tensor([0]))
    assert out.tolist() == [63, 48, 0, 0]


def test_minbits_and_zigzag16_equal_the_host():
    x = np.concatenate([np.arange(0, 70000), [2 ** 31 - 1, 2 ** 32 - 1]])
    assert bitpack.minbits(torch.from_numpy(x)).tolist() == [
        jbp.minbits(int(v)) for v in x]
    u = np.arange(65536)
    z = zigzag16(torch.from_numpy(u)).numpy()
    assert np.array_equal(z, jtc.zigzag16(u.astype(np.uint16)))
    assert np.array_equal(unzigzag16(torch.from_numpy(z)).numpy(), u)


def test_zsm_mean_plain_equals_mean16():
    """L's plain version equals UintZsmCodec._mean16 on every tested read,
    among them the first seeded read whose running mean differs from
    int(sum / n) (the port follows the running mean) and negative means
    (truncated toward zero)."""
    reads = raw_rows.zsm_reads() + _edge_reads()
    drift = raw_rows.drift_read()
    assert int(np.float64(drift.astype(np.float64).sum() / drift.size)) != \
        UintZsmCodec._mean16(drift)
    sig, n = raw_rows.pad_rows(reads)
    got = uint.zsm_mean_plain(torch.from_numpy(sig), torch.from_numpy(n))
    assert got.tolist() == [UintZsmCodec._mean16(r) if r.size else 0
                            for r in reads]
    assert [raw_rows.mean16(r) for r in reads if r.size] == [
        UintZsmCodec._mean16(r) for r in reads if r.size]
    assert min(got.tolist()) < 0


@pytest.mark.parametrize("codec", CODECS)
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound(codec, n)
        assert b == get_codec(codec).bound(n) and type(b) is int, n
