"""The port's analysis.py vs honours_tpu/analysis.py on the CPU: every
function on seeded reads, edge reads (n = 0, 1 and 2, full range, all
equal), stall reads (one past sample 65,535) and the three fixture
reads.  Reports must have the same keys in the same order and the same
Python types; integers and bools must be equal, floats equal within
1e-9 relative (float64 on both sides, sums in another order).  The
stall report runs the port's batched segmenter (the plain version of
kernel A here) against the C segmenter.  No JAX engine is compiled."""

import json
import math

import numpy as np
import pytest
import torch

from honours_tpu import analysis as J
from honours_tpu.transforms.core import zigdelta as jzigdelta
from honours_tpu_torch import analysis as T
from honours_tpu_torch import synth
from stall_rows import late_stall
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CPU = "cpu"
REL = 1e-9


def same(ours, theirs, where="report"):
    """Equal structure, keys in order, Python types; ints and bools
    exactly, floats within REL."""
    assert type(ours) is type(theirs), (where, ours, theirs)
    if isinstance(ours, dict):
        assert list(ours) == list(theirs), where
        for k in ours:
            same(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(ours, list):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            same(a, b, f"{where}[{i}]")
    elif isinstance(ours, float):
        assert math.isclose(ours, theirs, rel_tol=REL), (where, ours, theirs)
    else:
        assert ours == theirs, (where, ours, theirs)


@pytest.fixture(scope="module")
def reads(fixture_reads):
    """Seeded, edge, stall and fixture reads."""
    rng = np.random.default_rng(5)
    stall = synth.stall_set(0)[0]
    return [
        np.zeros(0, np.int16), np.array([-32768], np.int16),
        np.array([7, -9], np.int16), np.full(3000, 470, np.int16),
        rng.integers(-32768, 32768, 5000).astype(np.int16),
        np.tile(np.array([0, 30000], np.int16), 50),
        (rng.integers(-200, 200, 4000) * 8).astype(np.int16),
        synth.synthesize_corpus(20000, seed=3), stall, late_stall(),
        *fixture_reads,
    ]


def test_welford():
    rng = np.random.default_rng(0)
    x = rng.normal(100, 7, 50000)
    w, v = J.Welford(), T.Welford(device=CPU)
    for i in range(0, x.size, 1333):
        w.update(x[i: i + 1333])
        v.update(torch.from_numpy(x[i: i + 1333]))
    v.update(np.zeros(0))
    assert (v.n, v.min, v.max) == (w.n, w.min, w.max)
    for a in ("mean", "m2", "var", "sd"):
        assert math.isclose(getattr(v, a), getattr(w, a), rel_tol=REL), a
    assert T.Welford(device=CPU).sd == 0.0


def test_freq_tally_and_entropy(reads):
    for x in reads:
        assert np.array_equal(T.freq_tally(x, device=CPU).numpy(),
                              J.freq_tally(x))
        assert np.array_equal(
            T.freq_tally(x, minlength=70000, device=CPU).numpy(),
            J.freq_tally(x, minlength=70000))
        zd = jzigdelta(x)
        same(T.entropy_bits(x, device=CPU), J.entropy_bits(x))
        same(T.entropy_bits(zd, device=CPU), J.entropy_bits(zd))
    same(T.entropy_bits([], device=CPU), J.entropy_bits([]))


@pytest.mark.parametrize("fn", ["delta_stats", "exception_report",
                                "run_length_report", "value_histogram"])
def test_per_read_statistics(reads, fn):
    for i, x in enumerate(reads):
        same(getattr(T, fn)(x, device=CPU), getattr(J, fn)(x), f"{fn}[{i}]")
        same(getattr(T, fn)(torch.from_numpy(x), device=CPU),
             getattr(J, fn)(x), f"{fn}[{i}] tensor")
    for x in reads[3:8]:
        same(T.run_length_report(x, tol=3, device=CPU),
             J.run_length_report(x, tol=3))
        same(T.value_histogram(x, bucket=7, device=CPU),
             J.value_histogram(x, bucket=7))


def test_conditional_entropy(reads):
    for x in reads:
        zd = (jzigdelta(x)[1:] & 255).astype(np.uint8)
        same(T.conditional_entropy_bits(zd, device=CPU),
             J.conditional_entropy_bits(zd))
        same(T.conditional_entropy_bits(x, device=CPU),
             J.conditional_entropy_bits(x))


def test_stall_report_and_read_summary(reads):
    for i, x in enumerate(reads):
        same(T.stall_report(x, device=CPU), J.stall_report(x), f"stall[{i}]")
        same(T.read_summary(x, device=CPU), J.read_summary(x), f"read[{i}]")
    # the stall-set read splits; the late stall's start is past 65,535,
    # reported as the C segmenter reports it (uint16)
    assert J.stall_report(reads[8])["stall"]
    assert T.stall_report(reads[9], device=CPU)["stall"]


def test_analyze_reads(reads):
    ours = T.analyze_reads(reads, device=CPU)
    theirs = J.analyze_reads(reads)
    same(ours, theirs)
    assert json.dumps(ours, indent=1).count("\n") == json.dumps(
        theirs, indent=1).count("\n")
    same(T.analyze_reads([], device=CPU), J.analyze_reads([]))


def test_analyze_reads_in_parts(reads, monkeypatch):
    """Buckets cut into parts of at most 2,048 samples (one row a part
    from L = 2,048 up) give the same report, corpus tallies included."""
    monkeypatch.setattr(T, "_CHUNK", 2048)
    same(T.analyze_reads(reads, device=CPU), J.analyze_reads(reads))


METHODS = ["svb12_zd", "vbbe21_zd", "rice_vbbe21_zd", "drans_vbbe21_zd",
           "dstall_drans"]


def test_method_size_table(fixture_reads):
    cut = [x[:20000] for x in fixture_reads]
    same(T.method_size_table(cut, METHODS, device=CPU),
         J.method_size_table(cut, METHODS))


def test_method_size_table_rejects_host_only_codecs():
    with pytest.raises(NotImplementedError):
        T.method_size_table([np.arange(10, dtype=np.int16)],
                            ["no_such_codec"],
                            device=CPU)


def test_synthesize_corpus_is_the_reference():
    assert np.array_equal(T.synthesize_corpus(5000, seed=4),
                          J.synthesize_corpus(5000, seed=4))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.analyze_reads([np.arange(5, dtype=np.int16)])
