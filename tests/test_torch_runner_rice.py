"""The port's runner with the four rice codecs (encode only) vs
honours_tpu's runner and registry codec, on tests/test_torch_runner.py's
mixed read set plus an empty read, with max_b = 4: the streams equal the
JAX runner's, and the host codec's for every read of n >= 1, which the
host codec decodes; the port's depress raises.  Tolerance 0."""

import numpy as np
import pytest

from honours_tpu.codecs import base as registry
from honours_tpu_torch.engine import runner
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from test_torch_runner_vb import check_press, reads  # noqa: F401

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
def test_rice_depress_raises(codec):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.depress_signals([b"\0" * 8], [3], codec, device="cpu")
