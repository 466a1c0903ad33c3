"""The port's runner with the vb exception family, classic svb32 and
ex-zd codecs vs honours_tpu's runner and registry codec, on
tests/test_torch_runner.py's mixed read set plus an empty read, with
max_b = 4 (its nex > emax row, index 5, takes the capped codecs' one-row
path).  Stream bytes and samples must be equal (tolerance 0).

For the empty read the port gives the JAX runner's bytes, which differ
from the host codec's (ROADMAP.md, watch list), so the host comparison
covers the reads of n >= 1."""

import numpy as np
import pytest

from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu_torch.engine import runner
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CODECS = ["vb1e2_zd", "vbe21_zd", "vbbe21_zd", "vbsbe21_zd", "vbsse21_zd",
          "svb_zd", "svb0124_zd", "hasgam_vbsse21_zdq"]


@pytest.fixture(scope="module")
def reads(mixed_reads):
    return mixed_reads + [np.zeros(0, np.int16)]


def check_press(reads, codec):
    """The port's streams -> equal to the JAX runner's, and to the host
    codec's for every read of n >= 1."""
    ours = runner.press_signals(reads, codec, max_b=4, device="cpu")
    assert ours == jrunner.press_signals_tpu(reads, codec, max_b=4)
    host = registry.get(codec)
    for i, s in enumerate(reads):
        if s.size:
            assert ours[i] == host.press(s), i
    kind = runner.ENGINE_CODECS[codec]
    if not kind.startswith("svb32_zd"):  # row 5 took the one-row path
        assert runner._nex_overflowed(ours[5], kind, runner._emax(1024))
    return ours


@pytest.mark.parametrize("codec", CODECS)
def test_press_matches_jax_runner_and_registry(reads, codec):
    check_press(reads, codec)


@pytest.mark.parametrize("codec", CODECS)
def test_streams_round_trip(reads, codec):
    """The port's streams (equal to the JAX runner's) and the host's
    streams decode to the reads."""
    lens = [s.size for s in reads]
    streams = runner.press_signals(reads, codec, max_b=4, device="cpu")
    host = registry.get(codec)
    hstreams = [host.press(s) if s.size else streams[i]
                for i, s in enumerate(reads)]
    for st in (streams, hstreams):
        out = runner.depress_signals(st, lens, codec, max_b=4, device="cpu")
        for i, s in enumerate(reads):
            assert out[i].dtype == np.int16 and np.array_equal(out[i], s), i


@pytest.mark.parametrize("codec", ["svb_zd", "svb0124_zd"])
def test_svb32_bucket_of_short_streams(codec):
    """A bucket whose streams are all narrower than its L/4 key columns
    decodes (the JAX runner's decode fails there: ROADMAP.md, watch
    list)."""
    reads = [np.array([5], np.int16), np.array([1, 2, 300], np.int16)]
    streams = runner.press_signals(reads, codec, device="cpu")
    host = registry.get(codec)
    assert streams == [host.press(r) for r in reads]
    out = runner.depress_signals(streams, [1, 3], codec, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(out, reads))
