"""The port's dstall_srans2 and dstall_drans (engines, runner and CLI on
the CPU) vs honours_tpu's host codecs, DstallSrans2Codec and
dstall_drans_press_reads / dstall_drans_depress_reads, which
tests/test_dstall.py and tests/test_dstall_drans.py hold equal to the
JAX engines.  No JAX engine is compiled here.  Streams and samples must
be equal (tolerance 0), for reads of n >= 1."""

import struct

import numpy as np
import pytest
import torch

import honours_tpu.codecs.dstall_drans as dd
from honours_tpu.codecs.base import get as get_codec
from honours_tpu_torch import cli
from honours_tpu_torch.engine import dstall_drans as tdd
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.dstall import (
    depress_dstall_batch,
    press_dstall_batch,
)
from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
from honours_tpu_torch.io import blow5 as tb
from honours_tpu_torch.io.batching import bucket_reads
from test_torch_blow5 import src_file  # noqa: F401  (fixture)
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from test_torch_segment import knife_cases, late_stall
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TABS = canned_o1_device_tables("cpu")


def _stall_signal(rng, n_stall=800, n_rest=3000, base=460):
    """tests/test_dstall.py's read: a flat stall, then active signal."""
    stall = base + rng.integers(-4, 5, n_stall)
    rest = rng.integers(300, 900, n_rest)
    return np.concatenate([stall, rest]).astype(np.int16)


def _walk(B, L, seed=5, burst=97):
    """tests/test_dstall_drans.py's random-walk batch."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, size=(B, L))
    steps[:, ::burst] = rng.integers(-900, 900,
                                     size=(B, (L + burst - 1) // burst))
    return np.cumsum(steps, axis=1).clip(-2000, 2000).astype(np.int16)


@pytest.fixture(scope="module")
def mixed(fixture_reads):
    """Reads of at most 4096 samples: fixture cuts, stall reads (some
    split), no-stall and constant reads, one- and two-sample reads."""
    rng = np.random.default_rng(21)
    return [
        fixture_reads[0][:4096], fixture_reads[1][:4000],
        fixture_reads[2][:3000], _stall_signal(rng),
        _stall_signal(rng, n_stall=2000, n_rest=1000),
        rng.integers(300, 900, 2500).astype(np.int16),
        np.full(500, 470, np.int16), np.array([5], np.int16),
        np.array([5, -7], np.int16),
    ]


def _rows(reads, L):
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    n = np.array([r.size for r in reads], np.int32)
    return torch.from_numpy(sig), torch.from_numpy(n)


def _buf(streams):
    W = -(-max(map(len, streams)) // 128) * 128
    buf = np.zeros((len(streams), W), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(buf)


def _streams(st, sl):
    return [st[i, : int(sl[i])].numpy().tobytes() for i in range(len(sl))]


def _decodes(out, reads):
    for i, r in enumerate(reads):
        assert out.dtype == torch.int16
        assert np.array_equal(out[i, : r.size].numpy(), r), i
        assert not out[i, r.size:].any(), i


def _srans2_case(reads, L):
    """Engine streams == host streams; the engine decodes its own and the
    host's streams."""
    sig, n = _rows(reads, L)
    ours = _streams(*press_dstall_batch(sig, n, TABS, L))
    host = get_codec("dstall_srans2")
    assert ours == [host.press(r) for r in reads]
    _decodes(depress_dstall_batch(_buf(ours), n, TABS, L, L), reads)
    return ours


def _drans_case(reads, L, emax=None):
    sig, n = _rows(reads, L)
    ours = _streams(*tdd.press_dstall_drans_batch(sig, n, TABS, emax))
    assert ours == dd.dstall_drans_press_reads(reads)
    _decodes(tdd.depress_dstall_drans_batch(_buf(ours), n, TABS, L, emax),
             reads)
    return ours


def test_dstall_srans2_mixed_batch(mixed):
    ours = _srans2_case(mixed, 4096)
    assert [s[0] for s in ours] == [0, 0, 0, 1, 1, 0, 0, 0, 0]


def test_dstall_srans2_knife_edge_reads():
    """tests/test_dstall.py's knife-edge reads at the threshold, margin
    and window edges, in one batch."""
    reads = [s for _, s in knife_cases() if s.size < 4096]
    assert len(reads) == 10
    ours = _srans2_case(reads, 2152)
    # the segments of 140 samples and more split, the shorter ones not
    assert [s[0] for s in ours] == [1, 1, 1, 0, 0, 0, 0, 0, 1, 1]


def test_stall_past_65535_is_not_split():
    """The port keeps int32 starts, so a stall found past 65535 fails
    the uint16 guard of _split_batch (which dstall_drans shares) and the
    read stays plain (ROADMAP.md, watch list); it round-trips."""
    x = late_stall()
    sig, n = _rows([x], x.size)
    st, sl = press_dstall_batch(sig, n, TABS, x.size)
    assert int(st[0, 0]) == 0
    _decodes(depress_dstall_batch(st, n, TABS, x.size, x.size), [x])


def test_dstall_drans_mixed_batch(mixed):
    ours = _drans_case(mixed, 4096)
    assert [s[0] for s in ours] == [0, 0, 0, 1, 1, 0, 0, 0, 0]


def test_dstall_drans_walk_batch():
    """tests/test_dstall_drans.py's 8 x 4096 walk batch, emax = L / 16."""
    sig = _walk(8, 4096)
    lens = [4096, 1, 2, 100, 4095, 777, 4000, 8]
    _drans_case([sig[i, :m] for i, m in enumerate(lens)], 4096, 256)


def test_dstall_drans_fixture_chunks(fixture_reads):
    """The first eight 8192-sample chunks of the fixture reads."""
    chunks = [s[o: o + 8192] for s in fixture_reads
              for o in range(0, s.size, 8192)][:8]
    _drans_case(chunks, 8192, 512)


def test_dstall_drans_decodes_forced_split_streams(fixture_reads,
                                                   monkeypatch):
    """Host streams whose pick was forced to split (all rows, then only
    the first) decode in the port."""
    reads = [s[:8192] for s in fixture_reads]
    monkeypatch.setattr(dd, "PLAIN_OVERHEAD", 10**9)
    sts = dd.dstall_drans_press_reads(reads)
    assert [s[0] for s in sts] == [1, 1, 1]
    assert all(struct.unpack_from("<H", s, 9)[0] == 3 for s in sts)
    sig, n = _rows(reads, 8192)
    _decodes(tdd.depress_dstall_drans_batch(_buf(sts), n, TABS, 8192),
             reads)

    real_split = dd._split
    monkeypatch.setattr(dd, "_split", lambda x: (
        real_split(x)[0] and x.size == reads[0].size and (x == reads[0]).all(),
        *real_split(x)[1:]))
    sts = dd.dstall_drans_press_reads(reads)
    assert [s[0] for s in sts] == [1, 0, 0]
    _decodes(tdd.depress_dstall_drans_batch(_buf(sts), n, TABS, 8192),
             reads)


def test_dstall_drans_group_mismatch_raises(fixture_reads):
    reads = [s[:4096] for s in fixture_reads]
    sts = dd.dstall_drans_press_reads(reads)
    sig, n = _rows(reads[:1], 4096)
    with pytest.raises(ValueError, match="group mismatch"):
        tdd.depress_dstall_drans_batch(_buf(sts[:1]), n, TABS, 4096)


def test_dstall_drans_raises_past_the_bound(mixed, monkeypatch):
    """A row that would emit past the assembly's bound raises (the JAX
    engine drops the bytes: ROADMAP.md, watch list)."""
    monkeypatch.setattr(tdd, "_bound", lambda L, width: 16)
    sig, n = _rows(mixed, 4096)
    with pytest.raises(RuntimeError, match="bound"):
        tdd.press_dstall_drans_batch(sig, n, TABS, 4096)


@pytest.fixture(scope="module")
def runner_reads(mixed_reads):
    """tests/test_torch_runner.py's mixed reads (rows 1, 5 and 7 overflow
    the exception cap) and two reads of a stall then a random walk."""
    rng = np.random.default_rng(4)
    return mixed_reads + [
        np.concatenate([460 + rng.integers(-4, 5, m), np.clip(
            460 + np.cumsum(rng.integers(-40, 41, 3000)), 0, 1200)]).astype(
                np.int16) for m in (900, 2000)]


def test_runner_dstall_srans2(runner_reads):
    codec = "dstall_srans2"
    ours = runner.press_signals(runner_reads, codec, max_b=4, device="cpu")
    host = get_codec(codec)
    assert ours == [host.press(r) for r in runner_reads]
    assert runner._nex_overflowed(ours[5], "dstall", runner._emax(1024))
    lens = [r.size for r in runner_reads]
    out = runner.depress_signals(ours, lens, codec, max_b=4, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(out, runner_reads))


def test_runner_dstall_drans(runner_reads):
    """Streams equal the host's grouped press over each bucket's rows,
    but for the rows over the exception cap, each its own group; the
    port's and the host's streams decode."""
    codec = "dstall_drans"
    ours = runner.press_signals(runner_reads, codec, max_b=4, device="cpu")
    host = [None] * len(runner_reads)
    alone = set()
    for b in bucket_reads(runner_reads, max_b=4):
        group = []
        for i in b.indices.tolist():
            if runner._nex_overflowed(ours[i], "dstall_drans",
                                      runner._emax(b.L)):
                alone.add(i)
                host[i] = get_codec(codec).press(runner_reads[i])
            else:
                group.append(i)
        if group:
            host_group = dd.dstall_drans_press_reads(
                [runner_reads[i] for i in group])
            for i, s in zip(group, host_group):
                host[i] = s
    assert alone == {1, 5, 7}
    assert ours == host
    lens = [r.size for r in runner_reads]
    for streams in (ours, host):
        out = runner.depress_signals(streams, lens, codec, max_b=4,
                                     device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(out, runner_reads))


@pytest.mark.parametrize("codec", ["dstall_srans2", "dstall_drans"])
def test_cli_round_trip(tmp_path, src_file, mixed_reads, codec):
    mid, back = tmp_path / "mid.blow5", tmp_path / "back.blow5"
    assert cli.main(["press", str(src_file), str(mid), "--codec", codec,
                     "--device", "cpu"]) == 0
    f5 = tb.read_blow5(str(mid), decode_signal=False)
    assert tb.htpu_codec_name(f5.header) == codec
    assert [r.signal_stream for r in f5.reads] == runner.press_signals(
        mixed_reads, codec, device="cpu")
    assert cli.main(["depress", str(mid), str(back), "--device", "cpu"]) == 0
    got = tb.read_blow5(str(back)).reads
    assert all(np.array_equal(r.signal, s) for r, s in zip(got, mixed_reads))
