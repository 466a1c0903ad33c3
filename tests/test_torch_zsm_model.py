"""Kernel L's settled rule (csrc/zsm.cu), checked on the CPU: a numpy
model of the kernel without its chain (tests/raw_rows.py zsm_model: the
read's exact sum, the integer test, C's truncating S / n) against the
reference's get_mean_16 (raw_rows.mean16, tolerance 0), and the rule's
bound eps(n) = (n + 64) 2^-37 against the float64 running mean (taken a
column at a time over the reads), on seeded reads and walks, the drift
read, reads whose exact means are k and k +- j / n, and reads of 2^20
samples at the edges of the band.  No JAX."""

from fractions import Fraction

import numpy as np
import pytest

import raw_rows as R
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def running_means(reads) -> np.ndarray:
    """get_mean_16's float64 running mean of each read, before its
    truncation: mean += (x_i - mean) / (i + 1), a column at a time over
    the reads."""
    n = np.array([r.size for r in reads])
    x = np.zeros((len(reads), max(int(n.max()), 1)), order="F")
    for i, r in enumerate(reads):
        x[i, : r.size] = r
    mean = np.zeros(len(reads))
    for i in range(int(n.max())):
        step = mean + (x[:, i] - mean) / (i + 1)
        mean = np.where(i < n, step, mean)
    return mean


def check_rule(reads) -> int:
    """Every settled read's C division equals get_mean_16, every read
    where int(S / n) differs from it is flagged, and every running mean
    lies within eps(n) of S / n; returns the flagged reads' count."""
    flagged = 0
    for read, mean in zip(reads, running_means(reads)):
        n, S = read.size, int(read.astype(np.int64).sum())
        want = R.mean16(read)
        assert int(np.float64(mean)) == want  # the columns are its chain
        got = R.zsm_model(S, n)
        flagged += got is None
        if got is not None:
            assert got == want, (n, S)
        if n:
            assert abs(Fraction(float(mean)) - Fraction(S, n)) <= R.zsm_eps(n)
            if int(Fraction(S, n)) != want:
                assert got is None, (n, S)
    return flagged


def _random_reads(seed: int):
    """Full-range random reads, random walks and small alphabets of 1 to
    5,000 samples."""
    rng = np.random.default_rng(seed)
    reads = []
    for n in rng.integers(1, 5000, 36):
        kind = len(reads) % 3
        if kind == 0:
            x = rng.integers(-32768, 32768, n)
        elif kind == 1:
            x = np.clip(np.cumsum(rng.integers(-200, 201, n))
                        + rng.integers(-30000, 30000), -32768, 32767)
        else:
            x = rng.integers(-2, 3, n)
        reads.append(x.astype(np.int16))
    return reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_on_random_reads_and_walks(seed):
    check_rule(_random_reads(seed))


def test_rule_flags_the_drift_read():
    """The drift read (its truncated running mean differs from int(S /
    n)) and the GPU test's reads of kernel L."""
    drift = R.drift_read()
    S = int(drift.astype(np.int64).sum())
    assert R.zsm_model(S, drift.size) is None
    assert check_rule([drift] + R.zsm_reads()[1:]) >= 1


@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 4097, 65536])
def test_rule_at_and_beside_integer_means(n):
    """Means k and k +- j / n (j = 1, 2), k of both signs and 0: the
    integer means (k != 0) are flagged, the others settled."""
    reads = R.banded_reads(n, n)
    check_rule(reads)
    for read in reads:
        S = int(read.astype(np.int64).sum())
        assert (R.zsm_model(S, n) is None) == (S % n == 0 and S != 0)


def test_rule_at_the_band_edges_of_2_20():
    """At n = 2^20 the band is 8 / n wide: means k +- 8 / n are flagged,
    k +- 9 / n settled."""
    n = 1 << 20
    reads = R.banded_reads(7, n, ks=(-5, 3), js=(0, 8, 9))
    assert check_rule(reads) == 6
    for read in reads:
        S = int(read.astype(np.int64).sum())
        j = min(S % n, n - S % n)
        assert (R.zsm_model(S, n) is None) == (j <= 8)


@pytest.mark.parametrize("n", [2, 1000, 370_000, 370_800, 1 << 20, 1 << 22,
                               (1 << 22) + 1])
def test_band_width(n):
    """The least distance j / n from an integer mean k that settles a
    read: 1 / n up to n of about 370,000, then floor(n (n + 64) / 2^37) +
    1 (9 at 2^20, 129 at 2^22); past 2^22 samples every read is
    flagged."""
    settled = [j for j in range(1, min(n, 200))
               if R.zsm_model(5 * n + j, n) is not None]
    if n > R.ZSM_SETTLED_MAX:
        assert not settled and R.zsm_model(0, n) is None
        return
    assert settled[0] == (n * (n + 64) >> 37) + 1
    assert settled[0] == 1 if n <= 370_000 else settled[0] > 1
    assert R.zsm_model(5 * n, n) is None and R.zsm_model(0, n) == 0
