"""Rows for kernels I and J (ragged bit packing), K (the flats partition)
and L (uint_zsm's running mean, and a model of its settled rule), shared
by the CPU tests, the GPU tests and chip_smoke.py: numpy only, made from
seeds."""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np


def ragged_rows(seed: int, R: int = 48, max_count: int = 300):
    """(values int32 [V], val_off, count, width int64 [R]): every width
    0..16 twice, counts 0, 1, 2 and random up to max_count, values random
    32-bit words (negative too: only each field's low b bits count), each
    row's values at a random offset (rows may share values)."""
    rng = np.random.default_rng(seed)
    width = np.concatenate([np.arange(17), np.arange(17),
                            rng.integers(0, 17, R - 34)]).astype(np.int64)
    count = rng.integers(0, max_count, R).astype(np.int64)
    count[[0, 1, 2, 17, 18, 33]] = [0, 1, 2, 1, 0, 2]
    V = 4 * max_count
    values = rng.integers(-2 ** 31, 2 ** 31, V, dtype=np.int64).astype(
        np.int32)
    val_off = rng.integers(0, V - max_count, R).astype(np.int64)
    return values, val_off, count, width


def layout(sizes, seed: int):
    """(offsets int64 [R], total): rows of `sizes` items laid in order
    with a random gap of 0-5 items before each, and 7 after the last."""
    rng = np.random.default_rng(seed + 1)
    gaps = rng.integers(0, 6, len(sizes))
    off = np.cumsum(gaps + sizes) - sizes
    return off.astype(np.int64), int(off[-1] + sizes[-1] + 7)


def mean16(x: np.ndarray) -> int:
    """The reference's get_mean_16 (press/util.c:74-88): the serial
    float64 running mean, truncated toward zero."""
    mean = 0.0
    for i, v in enumerate(x.astype(np.float64)):
        mean += (v - mean) / (i + 1)
    return int(np.float64(mean))


def drift_read():
    """The first seeded read (seeds from 0, 2-59 full-range samples) whose
    truncated running mean differs from int(sum / n)."""
    for seed in range(10_000):
        rng = np.random.default_rng(seed)
        x = rng.integers(-32768, 32768, int(rng.integers(2, 60))).astype(
            np.int16)
        if int(np.float64(x.astype(np.float64).sum() / x.size)) != mean16(x):
            return x
    raise AssertionError("no drift read among the seeds")


def zsm_reads():
    """Reads for kernel L: empty, one sample, a negative mean (-4: its
    truncation is not its floor), the drift read, full-range random, a
    ramp, and a long walk around -1,000."""
    rng = np.random.default_rng(31)
    return [np.zeros(0, np.int16), np.array([-7], np.int16),
            np.array([-3, -4, -5], np.int16), drift_read(),
            rng.integers(-32768, 32768, 5000).astype(np.int16),
            np.arange(-2000, 2000, 3).astype(np.int16),
            (np.cumsum(rng.integers(-40, 41, 20000)) - 1000).astype(np.int16)]


#: csrc/zsm.cu's settled rule covers reads of up to 2^22 samples
ZSM_SETTLED_MAX = 1 << 22


def zsm_eps(n: int) -> Fraction:
    """eps(n) = (n + 64) 2^-37: csrc/zsm.cu's bound on |running mean -
    S / n| over a read of n samples."""
    return Fraction(n + 64, 1 << 37)


def zsm_model(S: int, n: int):
    """Kernel L without its chain, for a read of n samples whose exact
    sum is S: C's truncating S / n where the settled rule holds (S = 0,
    or 2^37 min(r, n - r) > n (n + 64) with r = |S| mod n, for n <=
    2^22), 0 for an empty read, and None for a flagged read, which takes
    the float64 chain."""
    if n == 0:
        return 0
    r = abs(S) % n
    if n > ZSM_SETTLED_MAX or (S != 0
                               and (min(r, n - r) << 37) <= n * (n + 64)):
        return None
    q = abs(S) // n
    return q if S >= 0 else -q


def with_sum(x, S: int):
    """x (int) moved by a constant and by 1 on its first samples so that
    it sums to S, as int16."""
    y = np.asarray(x, np.int64).copy()
    q, r = divmod(S - int(y.sum()), y.size)
    y += q
    y[:r] += 1
    assert y.min() >= -32768 and y.max() <= 32767 and int(y.sum()) == S
    return y.astype(np.int16)


def banded_reads(seed: int, n: int, ks=(-517, -3, -1, 0, 1, 2, 450),
                 js=(0, 1, 2)):
    """Reads of n samples, noise around k, whose exact means are k and k
    +- j / n for each k in ks and j in js (one read for j = 0): the
    means at and beside an integer, of both signs and around 0."""
    rng = np.random.default_rng(seed)
    reads = []
    for k in ks:
        for j in js:
            for sign in (1,) if j == 0 else (1, -1):
                noise = k + rng.integers(-60, 61, n)
                reads.append(with_sum(noise, k * n + sign * j))
    return reads


def integer_mean_rows(sig, n):
    """[B, L] int16 rows (first n valid) moved by 1 on their first (S mod
    n) samples, so that every read's exact mean is an integer: each read
    nonzero in the mean takes kernel L's chain."""
    sig = np.array(sig, np.int64)
    n = np.asarray(n, np.int64)
    col = np.arange(sig.shape[1])[None, :]
    S = np.where(col < n[:, None], sig, 0).sum(axis=1)
    r = np.where(n > 0, S % np.maximum(n, 1), 0)
    sig -= col < r[:, None]
    assert sig.min() >= -32768
    return sig.astype(np.int16)


def tie_read():
    """(read, step): a read at step 8 whose partition has a tie: one
    segment of 16 (3 + 16 * 2 / 8 = 7 bytes) costs what the split at 8
    costs ((3 + 0) + (3 + 8 * 1 / 8) = 7); the least i wins, so it
    stays one segment."""
    return np.array([0] * 8 + [2, 3] * 4, np.int16), 8


def flats_designs():
    """Kernel K's designs in the order its entry (csrc/flats.cu
    htt_flats_partition) tries them: (the most chunks it takes, None for
    the last; threads; register slots a thread, 0 for the memory design;
    steps a round)."""
    src = (Path(__file__).resolve().parent.parent / "honours_tpu_torch"
           / "csrc" / "flats.cu").read_text()
    return [(int(most) if most else None, int(t), int(k), int(d))
            for most, t, k, d in re.findall(
                r"(?:if \(mmax <= (\d+)\) )?return launch<(\d+), (\d+), "
                r"(\d+)>", src)]


def flats_design(m: int):
    """(threads, register slots, steps a round) of the design K's entry
    picks for rows of m chunks."""
    for most, *design in flats_designs():
        if most is None or m <= most:
            return tuple(design)


def flats_reads(seed: int):
    """Reads for kernel K: empty, one and two samples, a constant run,
    the tie read repeated, steps of flat levels, a small-alphabet read
    (many ties), a noisy walk, full-range random samples and a read
    whose length is no multiple of 64."""
    rng = np.random.default_rng(seed)
    tie, _ = tie_read()
    return [np.zeros(0, np.int16), np.array([9], np.int16),
            np.array([-32768, 32767], np.int16), np.full(700, -5, np.int16),
            np.tile(tie, 40),
            np.repeat(rng.integers(0, 1000, 60), 37).astype(np.int16),
            rng.integers(0, 4, 3000).astype(np.int16),
            (np.cumsum(rng.integers(-30, 31, 6000)) + 500).astype(np.int16),
            rng.integers(-32768, 32768, 1500).astype(np.int16),
            np.concatenate([rng.integers(0, 4, 640),
                            rng.integers(0, 4000, 453),
                            np.full(300, 7)]).astype(np.int16)]


def pad_rows(reads, L: int = None):
    """Reads padded to [B, L] int16 and their lengths int32."""
    L = L or max(1, max(r.size for r in reads))
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    return sig, np.array([r.size for r in reads], np.int32)


def caller_rows(shape: str, seed: int):
    """(values int32 [V], val_off, count, width, out_off int64 [R], O) of
    kernel I's rows as one of its callers lays them out: "uint" (one long
    row a read, values at r L, bytes at 2 r L), "turbopfor" (blocks of 128
    fields, a read's last short, widths 0-16, packed back to back with a
    2-byte header before each), "flats" (a segment a row: 1-64 fields of
    widths 0-12, some empty, a header byte before each) or "ragged"
    (ragged_rows laid out with gaps)."""
    rng = np.random.default_rng(seed)
    if shape == "uint":
        L = 6000
        count = np.array([5999, 4096, 1], np.int64)
        width = np.array([10, 13, 16], np.int64)
        values = rng.integers(0, 1 << 16, 3 * L).astype(np.int32)
        return (values, np.arange(3, dtype=np.int64) * L, count, width,
                np.arange(3, dtype=np.int64) * 2 * L, 6 * L)
    if shape == "ragged":
        values, val_off, count, width = ragged_rows(seed)
        out_off, O = layout((count * width + 7) // 8, seed)
        return values, val_off, count, width, out_off, O
    if shape == "turbopfor":
        count = np.concatenate([np.full(40, 128), [77], np.full(20, 128),
                                [3]])
        width = rng.integers(0, 17, count.size)
        width[[5, 6]] = 0
        head = 2
    else:
        count = rng.integers(1, 65, 300)
        count[::37] = 0
        width = rng.integers(0, 13, count.size)
        head = 1
    count, width = count.astype(np.int64), width.astype(np.int64)
    values = rng.integers(0, 1 << 16, int(count.sum())).astype(np.int32)
    nb = (count * width + 7) // 8
    return (values, np.cumsum(count) - count, count, width,
            np.cumsum(nb + head) - nb, int((nb + head).sum()) + 8)
