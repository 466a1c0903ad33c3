"""`none`, the four byte layers and their 26 compositions in the port
(engine/layers.py: the inner codec through the runner on the CPU route,
the layer on the host) vs honours_tpu's host codecs (codecs/raw.py,
codecs/generic.py ByteLayerCodec and OuterLayerCodec, the ex-zd and flac
compositions): the streams equal the host's press byte for byte for
every read, n = 0 included, and decode back from either package's
streams; the zlib, zstd and bzip2 families that tests/test_golden_parity
.py's EXACT lists equal the reference C's golden streams of the fixture
reads (tests/golden; not fast_lzma2, whose FL2 container the JAX package
replaces with raw LZMA2).  A wrong embedded count raises ValueError; the
zstd codecs name the missing package where `zstandard` does not import;
batch_engine's layer pair and press_read give the runner's bytes.  The
zstd cases run where `zstandard` imports.  Bytes and samples must be
equal (tolerance 0)."""

import hashlib
import struct
import sys

import numpy as np
import pytest
import torch

import block_rows
from conftest import golden_bytes, golden_manifest
from honours_tpu.codecs.base import get as get_codec
from honours_tpu_torch.engine import layers, runner
from honours_tpu_torch.engine.bounds import bound
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

try:
    import zstandard  # noqa: F401

    HAVE_ZSTD = True
except ImportError:
    HAVE_ZSTD = False

CODECS = ["none", *layers.COMPOSED]
#: the layer codecs whose host bytes tests/test_golden_parity.py holds to
#: the reference C's (its EXACT list), with their golden names
GOLDEN = {
    **{f"zlib{s}": f"zlib{s}" for s in (
        "", "_uint_submin", "_uint_zd", "_svb_zd", "_svb0124_zd",
        "_svb12_zd", "_vbe21_zd", "_vbbe21_zd", "_vbsbe21_zd",
        "_vbsse21_zd")},
    **{f"zstd{s}": f"zstd{s}" for s in (
        "", "_uint_submin", "_uint_zd", "_svb_zd", "_svb0124_zd",
        "_svb12_zd", "_vb1e2_zd", "_vbe21_zd", "_vbbe21_zd", "_vbsbe21_zd",
        "_vbsse21_zd")},
    "zlib_hasgam_vbsse21_zdq": "zlib_exzd",
    "zstd_hasgam_vbsse21_zdq": "zstd_exzd",
    "bzip2": "bzip2", "bzip2_uint_zd": "bzip2_uint_zd",
    "bzip2_svb12_zd": "bzip2_svb12_zd",
}


def _needs(codec):
    if "zstd" in codec and not HAVE_ZSTD:
        pytest.skip("needs the zstandard package")


@pytest.fixture(scope="module")
def reads(fixture_reads):
    """The edge lengths (n = 0 included), full-range samples, a spike, a
    ramp and cuts of the fixture reads."""
    rng = np.random.default_rng(2)
    return ([block_rows.walk(rng, n) for n in block_rows.EDGE_LENGTHS[:9]]
            + [rng.integers(-32768, 32768, 3000).astype(np.int16),
               block_rows.spike_read(3000, 1000),
               np.arange(-2000, 2000, dtype=np.int16)]
            + [r[:5000].copy() for r in fixture_reads])


def test_the_30_layer_codecs_and_none_are_the_registry_s():
    assert len(layers.COMPOSED) == 30
    for name, (layer, inner, with_nin) in layers.COMPOSED.items():
        host = get_codec(name)
        if inner == "none":
            assert type(host).__name__ == "ByteLayerCodec" and not with_nin
        else:
            assert host.inner.name == inner and host.with_nin == with_nin


@pytest.mark.parametrize("codec", CODECS)
def test_streams_equal_the_host_codec(codec, reads):
    _needs(codec)
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    assert ours == [host.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads], codec,
                                  device="cpu")
    for r, s, b in zip(reads, ours, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
        if r.size:
            assert np.array_equal(host.depress(s, r.size), r)
    assert bound(codec, 4097) == host.bound(4097)


@pytest.mark.parametrize("codec", sorted(GOLDEN))
def test_golden_streams(codec, fixture_reads):
    """The port's streams of the fixture reads are the reference C's:
    read 0 byte for byte, reads 1 and 2 by their size and sha256."""
    _needs(codec)
    ours = runner.press_signals(list(fixture_reads), codec, device="cpu")
    name = GOLDEN[codec]
    assert ours[0] == golden_bytes(name, 0)
    man = golden_manifest()
    for i in (1, 2):
        entry = man[f"{name}.{i}"]
        assert len(ours[i]) == entry["size"]
        assert hashlib.sha256(ours[i]).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("codec", ["zlib_uint_zd", "bzip2_svb12_zd",
                                   "fast_lzma2_uint_zd"])
def test_wrong_embedded_count_raises(codec):
    read = np.arange(50, dtype=np.int16)
    (s,) = runner.press_signals([read], codec, device="cpu")
    with pytest.raises(ValueError, match="embedded count 50 != expected 49"):
        runner.depress_signals([s], [49], codec, device="cpu")
    empty = layers.layer_press(layers.COMPOSED[codec][0], b"\x01")
    with pytest.raises(ValueError, match="holds no sample count"):
        runner.depress_signals([empty], [1], codec, device="cpu")


def test_zstd_names_the_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for codec in ("zstd", "zstd_flac"):
        with pytest.raises(ModuleNotFoundError, match="zstandard") as e:
            runner.press_signals([np.arange(9, dtype=np.int16)], codec,
                                 device="cpu")
        assert e.value.name == "zstandard"
    (s,) = runner.press_signals([np.arange(9, dtype=np.int16)], "zlib",
                                device="cpu")
    assert s == get_codec("zlib").press(np.arange(9, dtype=np.int16))


def test_none_is_the_raw_bytes(reads):
    ours = runner.press_signals(reads, "none", device="cpu")
    assert ours == [r.astype("<i2").tobytes() for r in reads]


@pytest.mark.parametrize("codec", ["zlib", "bzip2_uint_zd", "zlib_vbbe21_zd",
                                   "fast_lzma2_svb12_zd", "zstd_flac"])
def test_batch_engine_and_press_read(codec, reads):
    """batch_engine's layer pair on one bucket (its rows zero-padded, the
    layers' decompressors stop at their streams' ends) and press_read
    give the runner's bytes and samples."""
    _needs(codec)
    cut = [r for r in reads if r.size <= 4096]
    sig, n = block_rows.pad_rows(cut, 4096)
    press, depress = runner.batch_engine(codec, torch.device("cpu"))
    # emax = L: no row passes the exception cap, which the runner's
    # one-row fallback handles
    st, sl = press(torch.from_numpy(sig), torch.from_numpy(n), 4096)
    got = [st[i, : int(sl[i])].numpy().tobytes() for i in range(len(cut))]
    assert got == runner.press_signals(cut, codec, device="cpu")
    out = depress(st, torch.from_numpy(n), 4096, 4096)
    assert np.array_equal(out.numpy(), sig)
    assert runner.press_read(cut[-1], codec, device="cpu") == got[-1]


def test_empty_reads_take_the_host_s_inner_bytes():
    """For n = 0 a composition compresses the host inner codec's empty
    stream (vb*_zd's 4 zero bytes, ex-zd's 14), with [0:u32] first over
    the uint and svb inners."""
    for codec, (layer, inner, with_nin) in layers.COMPOSED.items():
        if "zstd" in codec and not HAVE_ZSTD:
            continue
        (s,) = runner.press_signals([np.zeros(0, np.int16)], codec,
                                    device="cpu")
        body = layers.layer_depress(layer, s)
        want = get_codec(inner).press(np.zeros(0, np.int16)) if \
            inner != "none" else b""
        assert body == (struct.pack("<I", 0) if with_nin else b"") + want
