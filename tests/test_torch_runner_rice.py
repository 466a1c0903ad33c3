"""The port's runner with the four rice codecs vs honours_tpu's runner
and registry codec, on tests/test_torch_runner.py's mixed read set plus
an empty read, with max_b = 4: the streams equal the JAX runner's, and
the host codec's for every read of n >= 1, which the host codec decodes;
the port's depress decodes as the host codec does
(tests/test_torch_rice_decode.py holds it on more reads).  Tolerance
0."""

import numpy as np
import pytest

from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu_torch.engine import runner
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from test_torch_runner_vb import check_press, reads  # noqa: F401
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RICE = ["rice_vbe21_zd", "rice_vbbe21_zd", "rice_vbsbe21_zd",
        "rice_vbsse21_zd"]


@pytest.mark.parametrize("codec", RICE)
def test_press_matches_jax_runner_and_host_decodes(reads, codec):
    ours = check_press(reads, codec)
    host = registry.get(codec)
    for i, s in enumerate(reads):
        if s.size:
            assert np.array_equal(host.depress(ours[i], s.size), s), i


@pytest.mark.parametrize("codec", RICE)
def test_depress_of_jax_runner_streams(reads, codec):
    """The JAX runner's streams (equal to the port's) decode in the port
    as the host codec decodes them."""
    streams = jrunner.press_signals_tpu(reads, codec, max_b=4)
    lens = [s.size for s in reads]
    out = runner.depress_signals(streams, lens, codec, max_b=4,
                                 device="cpu")
    host = registry.get(codec)
    for i, s in enumerate(reads):
        assert np.array_equal(out[i], s), i
        if s.size:
            assert np.array_equal(out[i], host.depress(streams[i], s.size)), i


@pytest.mark.parametrize("codec", RICE)
def test_rice_depress_raises(codec):
    """Depress of a minimal stream (zd0 = 0, no exception, residual
    bytes all 0) raises nothing and decodes as the host codec does."""
    stream = b"\0" * 8
    out = runner.depress_signals([stream], [3], codec, device="cpu")
    assert np.array_equal(out[0], registry.get(codec).depress(stream, 3))
    assert np.array_equal(out[0], np.zeros(3, np.int16))
