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


# tests/test_dstall.py's knife-edge reads


def _stall_exact(rng, stall_len, n_rest=2000, base=460, jitter=4):
    stall = base + rng.integers(-jitter, jitter + 1, stall_len)
    rest = np.empty(n_rest, np.int64)
    rest[0::2] = rng.integers(0, 60, (n_rest + 1) // 2)
    rest[1::2] = rng.integers(1100, 1200, n_rest // 2)
    return np.concatenate([stall, rest]).astype(np.int16)


def knife_cases():
    """(name, read) of tests/test_dstall.py's knife-edge cases: stall
    lengths at the threshold, margin and window edges, a float-stress
    read and a read whose stall-like run starts past 65535."""
    rng = np.random.default_rng(77)
    thr, margin, window = 140, 20, 150
    cases = []
    for d in (-1, 0, 1):
        cases.append(("thr%+d" % d, _stall_exact(rng, thr + d)))
    for d in (-1, 0, 1):
        cases.append(("margin%+d" % d, _stall_exact(rng, 2 * margin + d)))
    for ln in (int(window * 0.25), int(window * 0.25) + 1, window,
               window + 1):
        cases.append(("win%d" % ln, _stall_exact(rng, ln)))
    x = np.empty(120000, np.int64)
    x[0::2] = rng.integers(0, 40, 60000)
    x[1::2] = rng.integers(1150, 1200, 60000)
    x[:700] = 460 + rng.integers(-3, 4, 700)
    cases.append(("floatstress", x.astype(np.int16)))
    y = np.concatenate([
        rng.integers(300, 900, 66000),
        460 + rng.integers(-3, 4, 3000),
        rng.integers(300, 900, 2000),
    ]).astype(np.int16)
    cases.append(("u16start", y))
    return cases


def late_stall(seed=3, at=70000):
    """Alternating extremes (never in band) for `at` samples, then a
    stall of 3000 at 460 +- 3 and 500 more extremes: the first segment
    starts past 65535."""
    rng = np.random.default_rng(seed)
    x = np.empty(at + 3500, np.int64)
    x[0::2] = rng.integers(0, 40, x[0::2].size)
    x[1::2] = rng.integers(1150, 1200, x[1::2].size)
    x[at: at + 3000] = 460 + rng.integers(-3, 4, 3000)
    return x.astype(np.int16)


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
