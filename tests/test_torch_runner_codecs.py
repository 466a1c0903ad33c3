"""The port's runner with the slice-2 codecs (svb12_zd, svb12,
srans3_vbbe21_zd) vs honours_tpu's runner and registry codec, on
tests/test_torch_runner.py's mixed read set (its nex > emax row takes
srans3's one-row path).  Stream bytes and samples must be equal
(tolerance 0)."""

import numpy as np
import pytest

from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu_torch.engine import runner
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)

SLICE2 = ["svb12_zd", "svb12", "srans3_vbbe21_zd"]


@pytest.mark.parametrize("codec", SLICE2)
def test_press_matches_jax_runner_and_registry(mixed_reads, codec):
    ours = runner.press_signals(mixed_reads, codec, max_b=4, device="cpu")
    assert ours == jrunner.press_signals_tpu(mixed_reads, codec, max_b=4)
    # no batch-shared state: every row is the host codec's bytes, the
    # srans3 nex > emax row (index 5) through the one-row path
    host = registry.get(codec)
    assert ours == [host.press(s) for s in mixed_reads]


@pytest.mark.parametrize("codec", SLICE2)
def test_streams_cross_decode(mixed_reads, codec):
    lens = [s.size for s in mixed_reads]
    streams = runner.press_signals(mixed_reads, codec, max_b=4, device="cpu")
    ours = runner.depress_signals(streams, lens, codec, max_b=4, device="cpu")
    theirs = jrunner.depress_signals_tpu(streams, lens, codec, max_b=4)
    host = registry.get(codec)
    back = runner.depress_signals([host.press(s) for s in mixed_reads], lens,
                                  codec, max_b=4, device="cpu")
    for i, s in enumerate(mixed_reads):
        assert np.array_equal(ours[i], s), i
        assert np.array_equal(theirs[i], s), i
        assert np.array_equal(back[i], s), i
