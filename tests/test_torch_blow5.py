"""The port's BLOW5 reader/writer, its svb32 copy and its press/depress
CLI vs honours_tpu's: the same reads, metadata and file bytes, files
pressed by either package decoding in the other, and the CLI's device
rule.  The CLI cases run on a small BLOW5 of tests/test_torch_runner.py's
mixed read set with --device cpu.  Bytes and samples must be equal
(tolerance 0)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from honours_tpu import cli as jcli
from honours_tpu.io import blow5 as jb
from honours_tpu.kernels import svb as jsvb
from honours_tpu_torch import cli
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.kernels import svb as tsvb
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "three-reads.blow5"
CLI_CODECS = ["drans_vbbe21_zd", "srans_vbbe21_zd", "srans2_vbbe21_zd",
              "hasgam_vbsse21_zdq"]
RICE = ["rice_vbe21_zd", "rice_vbbe21_zd", "rice_vbsbe21_zd",
        "rice_vbsse21_zd"]
#: the 25 range-coder codecs (honours_tpu/codecs/rc.py, codecs/stall.py)
RC = ([f"{c}_{k}_zd" for c in ("rc", "rcc", "rccm")
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")]
      + [f"{c}_{k}" for c in ("rc", "rccm")
         for k in ("vbbe21", "vbsbe21", "vbsse21")]
      + ["rc_zd", "rccm_svb_zd", "rccm_svb12_zd", "rccm_vbbe21_submin",
         "rccm_svbbe21_zd", "dstall_fz_1500", "dstall_fz"])
#: the 11 per-read entropy codecs (codecs/rc.py's rccdf, codecs/huffman.py)
ENTROPY = ([f"{c}_{k}_zd" for c in ("rccdf", "huffman")
            for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")]
           + [f"shuffman_{k}_zd" for k in ("vbe21", "vbsbe21", "vbsse21")])
#: the 16 raw-sample and bit-packing codecs (codecs/vb.py, svb.py,
#: uintc.py, flats.py)
RAW = ["vb1e2", "vbe21", "vbbe21", "vbsbe21", "vbsse21", "svb", "svb0124",
       "svb12_nosimd", "svb12_zd_nosimd", "uintx_16", "uint11", "uint",
       "uint_submin", "uint_zd", "uint_zsm", "flat_uint_submin"]
#: the last 33: turbopfor, flac, none and the byte layers over none and
#: their compositions (codecs/pfor.py, flac.py, raw.py, generic.py,
#: exzd.py)
LAST = (["turbopfor", "flac", "none", "zlib", "zstd", "bzip2",
         "fast_lzma2", "zlib_uint_submin", "zstd_uint_submin",
         "bzip2_uint_zd", "fast_lzma2_uint_zd", "bzip2_svb12_zd",
         "fast_lzma2_svb12_zd", "zstd_vb1e2_zd", "zlib_hasgam_vbsse21_zdq",
         "zstd_hasgam_vbsse21_zdq", "zstd_flac"]
        + [f"{c}_{k}" for c in ("zlib", "zstd")
           for k in ("uint_zd", "svb_zd", "svb0124_zd", "svb12_zd",
                     "vbe21_zd", "vbbe21_zd", "vbsbe21_zd", "vbsse21_zd")])

FIELDS = ("read_id", "read_group", "digitisation", "offset", "range",
          "sampling_rate", "aux")


def _same_file(a, b):
    assert (a.version, a.record_press, a.signal_press, a.num_read_groups,
            a.header) == (b.version, b.record_press, b.signal_press,
                          b.num_read_groups, b.header)
    assert len(a.reads) == len(b.reads)
    for ra, rb in zip(a.reads, b.reads):
        assert [getattr(ra, f) for f in FIELDS] == [getattr(rb, f)
                                                    for f in FIELDS]
        assert ra.signal.dtype == rb.signal.dtype == np.int16
        assert np.array_equal(ra.signal, rb.signal)


def test_fixture_reads_like_the_reference():
    ours = tb.read_blow5(str(FIXTURE))
    _same_file(ours, jb.read_blow5(str(FIXTURE)))
    assert [r.signal.size for r in ours.reads] == [7329, 155185, 95350]


def test_svb32_copy_is_exact():
    rng = np.random.default_rng(7)
    for v in (np.zeros(0, np.uint32), np.array([0, 255, 256, 65535, 65536,
                                                2 ** 24, 2 ** 32 - 1],
                                               np.uint32),
              rng.integers(0, 2 ** 32, 1001, dtype=np.uint32)):
        enc = tsvb.svb32_encode(v)
        assert enc == jsvb.svb32_encode(v)
        out, used = tsvb.svb32_decode(enc, v.size)
        assert np.array_equal(out, v) and used == len(enc)


@pytest.mark.parametrize("record_press,signal_press", [(1, 1), (0, 1), (0, 0)])
def test_writer_matches_reference(tmp_path, record_press, signal_press):
    f5 = tb.read_blow5(str(FIXTURE))
    f5.record_press, f5.signal_press = record_press, signal_press
    ours, theirs = tmp_path / "ours.blow5", tmp_path / "theirs.blow5"
    tb.write_blow5(str(ours), f5)
    jf5 = jb.read_blow5(str(FIXTURE))
    jf5.record_press, jf5.signal_press = record_press, signal_press
    jb.write_blow5(str(theirs), jf5)
    assert ours.read_bytes() == theirs.read_bytes()
    _same_file(tb.read_blow5(str(ours)), jb.read_blow5(str(theirs)))


@pytest.fixture(scope="module")
def src_file(tmp_path_factory, mixed_reads):
    """tests/test_runner.py's BLOW5 of the mixed reads, zlib records."""
    reads = [
        jb.Blow5Read(read_id=f"r{i}", read_group=0, digitisation=2048.0,
                     offset=0.0, range=1.0, sampling_rate=4000.0,
                     signal=np.asarray(s, np.int16), aux=b"")
        for i, s in enumerate(mixed_reads)
    ]
    f5 = jb.Blow5File(version=(0, 2, 0), record_press=1, signal_press=1,
                      num_read_groups=1, header=b"#\n", reads=reads)
    path = tmp_path_factory.mktemp("blow5") / "src.blow5"
    jb.write_blow5(str(path), f5)
    return path


@pytest.mark.parametrize("codec", CLI_CODECS)
def test_cli_files_match_reference_and_cross_decode(tmp_path, src_file,
                                                   mixed_reads, codec):
    ours, theirs = tmp_path / "ours.blow5", tmp_path / "theirs.blow5"
    assert cli.main(["press", str(src_file), str(ours), "--codec", codec,
                     "--device", "cpu"]) == 0
    jcli.main(["press", str(src_file), str(theirs), "--tpu", "--codec", codec])
    assert ours.read_bytes() == theirs.read_bytes()
    assert tb.htpu_codec_name(tb.read_blow5(
        str(ours), decode_signal=False).header) == codec

    # each package decodes the other's file (honours_tpu by its host
    # codec, the port by its runner)
    for f5 in (jb.read_blow5(str(ours)),
               tb.read_blow5(str(theirs), device="cpu")):
        for r, s in zip(f5.reads, mixed_reads):
            assert np.array_equal(r.signal, s), r.read_id

    back, jback = tmp_path / "back.blow5", tmp_path / "jback.blow5"
    assert cli.main(["depress", str(theirs), str(back), "--device",
                     "cpu"]) == 0
    jcli.main(["depress", str(ours), str(jback), "--tpu"])
    assert back.read_bytes() == jback.read_bytes()
    restored = tb.read_blow5(str(back))
    assert restored.signal_press == tb.SIGNAL_PRESS_SVB_ZD
    for r, s in zip(restored.reads, mixed_reads):
        assert np.array_equal(r.signal, s), r.read_id


def test_cli_rules(tmp_path, src_file, capsys):
    """Default device is the card (RuntimeError here without one);
    a name outside the registry raises NotImplementedError; `codecs`
    lists the 106 the port runs (the 21 engine codecs, the 25 range-coder
    codecs, the 11 per-read entropy codecs, the 16 raw-sample codecs and
    the last 33: turbopfor, flac, none and the byte layers), with no
    mark."""
    out = str(tmp_path / "out.blow5")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["press", str(src_file), out])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["depress", str(src_file), out])
    with pytest.raises(NotImplementedError,
                       match="not one of the 106 codecs this port runs"):
        cli.main(["press", str(src_file), out, "--codec",
                  "no_such_codec", "--device", "cpu"])
    f5 = tb.read_blow5(str(src_file))
    with pytest.raises(NotImplementedError,
                       match="not one of the 106 codecs this port runs"):
        tb.write_blow5(out, f5, signal_codec="no_such_codec",
                       signal_streams=[b""] * len(f5.reads))
    assert cli.main(["codecs"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == sorted([
        "drans_vbbe21_zd", "srans_vbbe21_zd", "srans2_vbbe21_zd",
        "srans3_vbbe21_zd", "shuffman_vbbe21_zd", "svb12_zd", "svb12",
        "vb1e2_zd", "vbe21_zd", "vbbe21_zd", "vbsbe21_zd", "vbsse21_zd",
        "svb_zd", "svb0124_zd", "hasgam_vbsse21_zdq", *RICE,
        "dstall_srans2", "dstall_drans", *RC, *ENTROPY, *RAW, *LAST])


@pytest.mark.parametrize("codec", RICE)
def test_cli_rice_file_presses_and_depress_raises(tmp_path, src_file,
                                                  mixed_reads, codec):
    """A rice file's streams are the runner's and the host codec decodes
    them; depress raises nothing and gives the reads back."""
    from honours_tpu.codecs import base as registry
    from honours_tpu_torch.engine import runner

    ours = tmp_path / "ours.blow5"
    assert cli.main(["press", str(src_file), str(ours), "--codec", codec,
                     "--device", "cpu"]) == 0
    f5 = tb.read_blow5(str(ours), decode_signal=False)
    assert tb.htpu_codec_name(f5.header) == codec
    streams = [r.signal_stream for r in f5.reads]
    assert streams == runner.press_signals(mixed_reads, codec, device="cpu")
    host = registry.get(codec)
    for st, s in zip(streams, mixed_reads):
        assert np.array_equal(host.depress(st, s.size), s)
    back = tmp_path / "back.blow5"
    assert cli.main(["depress", str(ours), str(back), "--device", "cpu"]) == 0
    got = tb.read_blow5(str(back)).reads
    assert all(np.array_equal(r.signal, s) for r, s in zip(got, mixed_reads))


def test_module_entry_point_loads_no_jax(tmp_path, src_file):
    """`python -m honours_tpu_torch press|depress` round-trips a file and
    never imports JAX or honours_tpu."""
    mid, out = tmp_path / "mid.blow5", tmp_path / "out.blow5"
    code = (
        "import sys, runpy\n"
        "for argv in (['press', sys.argv[1], sys.argv[2], '--codec', "
        "'srans_vbbe21_zd', '--device', 'cpu'], ['depress', sys.argv[2], "
        "sys.argv[3], '--device', 'cpu']):\n"
        "    sys.argv = ['honours_tpu_torch'] + argv\n"
        "    try:\n"
        "        runpy.run_module('honours_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'honours_tpu')]\n"
        "print('BAD', bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code, str(src_file), str(mid),
                        str(out)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout
    a, b = tb.read_blow5(str(src_file)), tb.read_blow5(str(out))
    for ra, rb in zip(a.reads, b.reads):
        assert np.array_equal(ra.signal, rb.signal)
