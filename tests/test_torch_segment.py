"""The port's stall segmenter (the plain version of kernel A, which the
CPU route runs) vs the C oracle honours_tpu.native.find_stall on every
read of tests/test_segment_tpu.py and on the knife-edge reads of
tests/test_dstall.py, and vs honours_tpu.segment.find_stall_batch at the
shapes tests/test_segment_tpu.py compiles.  (exists, start, length)
must be equal (tolerance 0); the C truncates start and length to
uint16, so they are compared modulo 2^16 with it."""

import numpy as np
import pytest
import torch

from honours_tpu import native
from honours_tpu.segment import find_stall_batch as jax_find_stall_batch
from honours_tpu_torch.segment import find_stall_batch, segment_cuda
from stall_rows import knife_cases, late_stall
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _batch(signals):
    """tests/test_segment_tpu.py's batch: L the longest read rounded up
    to 8."""
    L = -(-max(s.size for s in signals) // 8) * 8
    sig = np.zeros((len(signals), L), np.int16)
    n = np.zeros(len(signals), np.int32)
    for i, s in enumerate(signals):
        sig[i, : s.size] = s
        n[i] = s.size
    return sig, n


def _ours(signals):
    sig, n = _batch(signals)
    ex, st, ln = find_stall_batch(torch.from_numpy(sig), torch.from_numpy(n))
    assert ex.dtype == torch.bool
    assert st.dtype == ln.dtype == torch.int32
    return ex.numpy(), st.numpy(), ln.numpy()


def _check_c(signals):
    ex, st, ln = _ours(signals)
    for i, s in enumerate(signals):
        c_ex, c_st, c_ln = native.find_stall(np.asarray(s, np.int16))
        got = (bool(ex[i]), int(st[i]) & 0xFFFF, int(ln[i]) & 0xFFFF)
        assert got == (c_ex, c_st, c_ln), i
        if not c_ex:
            assert (int(st[i]), int(ln[i])) == (0, 0), i


# tests/test_segment_tpu.py's reads


def _synthetic():
    rng = np.random.default_rng(8)
    base = rng.integers(420, 470, 4000).astype(np.int16)
    noisy = rng.integers(0, 1200, 4000).astype(np.int16)
    return [
        base,
        noisy,
        np.concatenate([noisy[:500], base[:800], noisy[500:1500]]).astype(
            np.int16),
        np.concatenate([base[:200], noisy[:100], base[200:500]]).astype(
            np.int16),
        rng.integers(-500, 1500, 3000).astype(np.int16),
        np.full(2000, 450, np.int16),
        rng.integers(440, 460, 30).astype(np.int16),
    ]


def _random():
    rng = np.random.default_rng(9)
    sigs = []
    for _ in range(12):
        parts = []
        for _ in range(rng.integers(1, 5)):
            kind = rng.integers(0, 3)
            m = int(rng.integers(50, 1200))
            if kind == 0:
                c = int(rng.integers(300, 700))
                parts.append(rng.integers(c - 20, c + 20, m))
            elif kind == 1:
                parts.append(rng.integers(0, 1200, m))
            else:
                parts.append(rng.integers(200, 900, m))
        sigs.append(np.concatenate(parts).astype(np.int16))
    return sigs


# tests/test_dstall.py's knife-edge reads and a stall past sample 65,535:
# stall_rows.knife_cases, stall_rows.late_stall


def test_fixture_reads_match_c(fixture_reads):
    _check_c(list(fixture_reads))


def test_synthetic_stalls_match_c():
    _check_c(_synthetic())


def test_random_reads_match_c():
    _check_c(_random())


@pytest.mark.parametrize("name,sig", knife_cases(),
                         ids=[c[0] for c in knife_cases()])
def test_knife_edge_matches_c(name, sig):
    _check_c([sig])


def test_stall_past_65535_keeps_int32_start():
    """The C's start is the port's modulo 2^16; the port's is the whole
    sample index."""
    x = late_stall()
    ex, st, ln = _ours([x])
    assert ex[0] and int(st[0]) >= 70000 and int(ln[0]) >= 2900
    _check_c([x])


@pytest.mark.parametrize("signals", ["fixture", "synthetic", "random"])
def test_plain_matches_jax_scan(fixture_reads, signals):
    """The batch shapes of tests/test_segment_tpu.py, so its compiles are
    reused."""
    sigs = {"fixture": lambda: list(fixture_reads), "synthetic": _synthetic,
            "random": _random}[signals]()
    sig, n = _batch(sigs)
    want = [np.asarray(x) for x in jax_find_stall_batch(sig, n)]
    got = _ours(sigs)
    for g, w in zip(got, want):
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


def test_rows_read_to_n_only():
    """Samples past n, n = 0 rows, and n beyond the row (clamped to L)."""
    x = _synthetic()[2]
    L = 4096
    sig = np.full((4, L), 460, np.int16)
    sig[0, : x.size] = x
    sig[1, : x.size] = x
    n = torch.tensor([x.size, 0, x.size, L + 100], dtype=torch.int32)
    ex, st, ln = segment_cuda.find_stall_plain(torch.from_numpy(sig), n)
    c = native.find_stall(x)
    assert (bool(ex[0]), int(st[0]), int(ln[0])) == c
    assert (bool(ex[1]), int(st[1]), int(ln[1])) == (False, 0, 0)
    assert (bool(ex[3]), int(st[3]), int(ln[3])) == native.find_stall(
        sig[3])


def test_serial_float32_sums():
    """The thresholds come from serial float32 sums: they equal a Python
    loop over numpy float32 scalars, where a pairwise sum (torch.sum)
    differs on this read."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1200, 100_000).astype(np.float32)
    s = np.float32(0)
    for v in a:
        s = np.float32(s + v)
    acc = np.add.accumulate(a, dtype=np.float32)[-1]
    assert acc == s
    assert float(torch.from_numpy(a).sum()) != float(s)
    top, bot = segment_cuda._thresholds(a)
    assert top.dtype == bot.dtype == np.float32 and bot < top
