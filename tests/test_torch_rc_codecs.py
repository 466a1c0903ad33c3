"""The 25 range-coder codecs of the port (engine/rc.py, engine/stall_fz.py
through engine.runner on the CPU route) vs honours_tpu's registry host
codecs (codecs/rc.py, codecs/stall.py: numpy and native/rangecoder.c):
the port's streams equal the host codec's press for every read (its
press bytes for n = 0 too), the port decodes the host's streams (the
same bytes) and n = 0 back to the empty read, and the host decodes the
port's for n >= 1.  Edge reads of 0 to 230 samples for every codec, a
2,000-sample read for rccm_vbbe21_zd (a fixture cut) and for dstall_fz
(a stall read it splits), the HTPU_STALL_* / HTPU_DSTALL_THRESHOLD
settings, the slice rule with the coder state, a stall
past sample 65,535, the cases where the host raises, the bounds, and a
BLOW5 file across the two CLIs.  Bytes and samples must be equal
(tolerance 0).  No JAX engine is compiled: the host codecs need none.
The plain cm coder takes a few ms a byte, so reads stay short; the long
stall case swaps the coder for a copy on both sides (the coder itself is
held in tests/test_torch_rangecoder.py)."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

import honours_tpu.utils.config as jconfig
from honours_tpu import cli as jcli
from honours_tpu import native
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.io import blow5 as jb
import honours_tpu_torch.utils.config as tconfig
from honours_tpu_torch import cli
from honours_tpu_torch.engine import rc as trc
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.engine.rangecoder import STATE_BYTES
from honours_tpu_torch.io import blow5 as tb
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RC = sorted(runner.RC_CODECS)
STALL = ("rccm_svbbe21_zd", "dstall_fz_1500", "dstall_fz")
ENV = [f"HTPU_{f.name.upper()}" for f in dataclasses.fields(jconfig.Config)]


def _use(monkeypatch, env: dict):
    """Set the environment and drop both packages' cached configs."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jconfig, "_CONFIG", None)
    monkeypatch.setattr(tconfig, "_CONFIG", None)


def _stall_read(rng, before: int, stall: int, after: int):
    """Active signal, a flat stall inside the read's in-band range (mean
    +- 0.75 sd), active signal."""
    return np.concatenate([rng.integers(200, 1000, before),
                           600 + rng.integers(-4, 5, stall),
                           rng.integers(200, 1000, after)]).astype(np.int16)


@pytest.fixture(scope="module")
def edge_reads(fixture_reads):
    """n = 0 to 230: empty, one and two samples, exceptions in every
    framing (one, many, a run of bursts over the cap of no container),
    full-range samples, a ramp of -128 steps, a walk, a fixture cut, and
    a read whose stall the stall codecs split."""
    rng = np.random.default_rng(25)
    return [
        np.zeros(0, np.int16),
        np.array([5], np.int16),
        np.array([-32768, 32767], np.int16),
        np.array([256, 5, -3, 700], np.int16),
        np.tile(np.array([0, 30000], np.int16), 40),
        rng.integers(-32768, 32768, 60).astype(np.int16),
        (np.arange(120) * -128).astype(np.int16),
        (np.cumsum(rng.integers(-30, 31, 150)) + 500).astype(np.int16),
        fixture_reads[1][5000:5200],
        _stall_read(rng, 30, 170, 30),
    ]


def _check(codec: str, reads, host_decodes=True):
    """The port's streams are the host's; the port decodes them (every
    read back, n = 0 too) and the host decodes them for n >= 1."""
    host = get_codec(codec)
    ours = runner.press_signals(reads, codec, device="cpu")
    theirs = [host.press(r) for r in reads]
    assert ours == theirs
    back = runner.depress_signals(theirs, [r.size for r in reads], codec,
                                  device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    if host_decodes:
        for r, s in zip(reads, ours):
            if r.size:
                assert np.array_equal(host.depress(s, r.size), r)
    return ours


@pytest.mark.parametrize("codec", RC)
def test_codec_equals_the_host_codec(edge_reads, codec):
    ours = _check(codec, edge_reads)
    if codec == "rccm_svbbe21_zd":
        assert ours[-1][0] == 1  # the stall read split


@pytest.fixture(scope="module")
def long_reads(fixture_reads):
    """rccm_vbbe21_zd's 2,000-sample fixture cut, and dstall_fz's
    2,000-sample read with a stall of 1,200 (which it splits)."""
    rng = np.random.default_rng(2000)
    return {"rccm_vbbe21_zd": fixture_reads[2][10000:12000],
            "dstall_fz": _stall_read(rng, 300, 1200, 500)}


@pytest.mark.parametrize("codec", ["rccm_vbbe21_zd", "dstall_fz"])
def test_headline_codecs_on_2000_samples(long_reads, codec):
    (ours,) = _check(codec, [long_reads[codec]])
    if codec == "dstall_fz":
        assert ours[0] == 1  # the split flag


#: settings that move the stall-fz split, and the codec each moves
SETTINGS = {
    "margin60": ({"HTPU_STALL_MARGIN": "60"}, "rccm_svbbe21_zd"),
    "threshold300": ({"HTPU_STALL_THRESHOLD": "300"}, "rccm_svbbe21_zd"),
    "dstall_threshold150": ({"HTPU_DSTALL_THRESHOLD": "150"},
                            "dstall_fz_1500"),
}


@pytest.mark.parametrize("setting", SETTINGS)
def test_settings_move_the_split_as_the_host_codec(monkeypatch, edge_reads,
                                                   setting):
    env, codec = SETTINGS[setting]
    stall = edge_reads[-1:]
    _use(monkeypatch, {})
    at_defaults = get_codec(codec).press(stall[0])
    _use(monkeypatch, env)
    ours = _check(codec, stall)
    assert ours[0] != at_defaults


def _copy_coder(monkeypatch):
    """The cm coder swapped for a copy of its bytes, in both packages."""
    def enc(data):
        return np.ascontiguousarray(data, np.uint8).tobytes()

    def dec(stream, n):
        return np.frombuffer(bytes(stream[:n]).ljust(n, b"\0"), np.uint8)

    monkeypatch.setattr(native, "rccm_encode", enc)
    monkeypatch.setattr(native, "rccm_decode", dec)
    monkeypatch.setattr(get_codec("rccm_vbbe21_zd"), "_enc", enc)
    monkeypatch.setattr(get_codec("rccm_vbbe21_zd"), "_dec", dec)

    def t_enc(data, n, model):
        B, N = data.shape
        out = torch.zeros((B, N + N // 2 + 1024), dtype=torch.uint8)
        out[:, :N] = torch.where(torch.arange(N)[None, :] < n[:, None],
                                 data, 0)
        return out, n.to(torch.int64)

    def t_dec(stream, off, count, N, model):
        idx = off.to(torch.int64)[:, None] + torch.arange(N)[None, :]
        live = torch.arange(N)[None, :] < count[:, None]
        got = stream.gather(1, idx.clamp(max=stream.shape[1] - 1))
        return torch.where(live & (idx < stream.shape[1]), got, 0)

    monkeypatch.setattr(trc, "rc_encode", t_enc)
    monkeypatch.setattr(trc, "rc_decode", t_dec)


def test_stall_past_65535_splits_at_the_truncated_start(monkeypatch):
    """A stall that starts past sample 65,535: native.find_stall's uint16
    start wraps, and the host codecs split there (a region that is no
    stall); so do the port's (engine/dstall.py drops such a split)."""
    rng = np.random.default_rng(65536)
    read = _stall_read(rng, 70000, 600, 400)
    exists, start, length = native.find_stall(read)
    assert exists and abs(start + 65536 - 70000) <= 8 and length >= 140
    _copy_coder(monkeypatch)
    for codec in STALL:
        (ours,) = _check(codec, [read])
        if codec != "dstall_fz_1500":
            assert ours[0] == 1
            assert struct.unpack_from("<H", ours, 1)[0] == start + 20


def test_where_the_host_raises_the_port_raises(monkeypatch):
    """struct.error in the host codec (a start past 65,535 after the
    margin; a negative start under a negative margin) is ValueError in
    the port, for every stall codec."""
    rng = np.random.default_rng(65520)
    late = _stall_read(rng, 65525, 300, 100)
    exists, start, _ = native.find_stall(late)
    assert exists and 65516 <= start <= 65535
    early = _stall_read(rng, 0, 300, 100)
    cases = [({}, late), ({"HTPU_STALL_MARGIN": "-30"}, early)]
    _copy_coder(monkeypatch)
    for env, read in cases:
        _use(monkeypatch, env)
        for codec in ("rccm_svbbe21_zd", "dstall_fz"):
            with pytest.raises(struct.error):
                get_codec(codec).press(read)
            with pytest.raises(ValueError, match="uint16"):
                runner.press_signals([read], codec, device="cpu")


@pytest.mark.parametrize("codec", RC)
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound(codec, n)
        assert b == get_codec(codec).bound(n) and type(b) is int, n


def test_blow5_file_across_the_two_clis(tmp_path, edge_reads):
    """A file pressed by the port's CLI with rccm_vbbe21_zd is restored
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
    codec = ["--codec", "rccm_vbbe21_zd"]
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


@pytest.mark.parametrize("codec", RC)
def test_slice_rule_counts_the_coder_state(codec, monkeypatch):
    """Rows a slice of a range-coder codec: a third of the device's
    memory over its bytes a slot times L plus its rows' coder state
    (runner.ROW_BYTES: 33.8 MB a coder row for rccm, its order-2 table,
    two or three coder rows a bucket row for the stall-fz codecs)."""
    gb80 = 85_017_493_504  # an H100 80GB HBM3's total_memory
    monkeypatch.setattr(runner, "device_memory", lambda dev: gb80)
    row = runner.ROW_BYTES[codec]
    model = ("cm" if codec.startswith("rccm") or codec in STALL
             else "o1" if codec.startswith("rcc_") else "o0")
    coder_rows = {"rccm_svbbe21_zd": 2, "dstall_fz_1500": 2,
                  "dstall_fz": 3}.get(codec, 1)
    assert row == coder_rows * STATE_BYTES[model]
    for w in (4096, 1 << 16, 1 << 21):
        r = runner.slice_rows(codec, w, None)
        need = runner.BYTES_A_SLOT[codec] * w + row
        assert r == max(1, int(gb80 * runner.SLICE_SHARE) // need)
        assert r * need <= gb80 / 3
