"""Rows for the per-read entropy codecs' tests (CPU and card; no JAX):
Fibonacci histograms, whose Huffman tree has a code of a chosen depth,
a read whose residual bytes have one, and histograms whose merges tie
(kernel H's run rule)."""

import numpy as np


def fib_hist(depth: int, at: int = 0) -> np.ndarray:
    """depth + 1 Fibonacci counts from symbol `at`: with the reference's
    tie rule, a tree with a code of `depth` bits (a code of d bits needs
    a total count of at least F(d + 2))."""
    fib = [1, 1]
    while len(fib) < depth + 1:
        fib.append(fib[-1] + fib[-2])
    h = np.zeros(256, np.int64)
    h[at: at + depth + 1] = fib
    return h


def long_code_read(depth: int = 24, seed: int = 22) -> np.ndarray:
    """A read whose zigzag-deltas after the first are symbols 0..depth
    with Fibonacci counts, shuffled (no exceptions): for depth 24,
    196,418 samples whose Huffman table has a code of 24 bits."""
    zd = np.repeat(np.arange(256), fib_hist(depth))
    np.random.default_rng(seed).shuffle(zd)
    d = np.where(zd & 1, -((zd + 1) >> 1), zd >> 1)
    return np.cumsum(np.concatenate([[500], d])).astype(np.int16)


def tie_histograms(seed: int = 23, count: int = 300) -> list:
    """Histograms whose merges tie often: counts in 1-2, 1-4 and 1-8 over
    random symbol sets, 256 symbols of count 1 (and of 2), the [1, 1, 2, 2,
    4, 4, ...] and [2, 2, 4, 4, 8, 8, 16, 16] patterns, sums of leaves
    that equal a run of internal nodes not yet taken, Fibonacci counts, a
    lone symbol and an empty row."""
    rng = np.random.default_rng(seed)
    hs = [np.zeros(256, np.int64), np.ones(256, np.int64),
          np.full(256, 2, np.int64), fib_hist(31), fib_hist(22, at=7)]
    h = np.zeros(256, np.int64)
    h[40] = 7
    hs.append(h)
    for period in (2, 3):
        h = np.zeros(256, np.int64)
        m = 2 * 30
        h[:m] = 1 << (np.arange(m) // period)
        hs.append(h)
    h = np.zeros(256, np.int64)
    h[:8] = [2, 2, 4, 4, 8, 8, 16, 16]
    hs.append(h)
    # four 1s make two internal 2s, untaken while the 1s of these pairs
    # merge into more 2s beside leaves of 2 and 4
    h = np.zeros(256, np.int64)
    h[:12] = [1, 1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 8]
    hs.append(h)
    h = np.zeros(256, np.int64)
    h[100:116] = [3, 1, 2, 1, 1, 2, 3, 1, 2, 6, 1, 2, 4, 1, 3, 6]
    hs.append(h)
    while len(hs) < count:
        k = int(rng.integers(2, 256 + 1))
        top = int(rng.choice([2, 3, 4, 5, 8, 16]))
        h = np.zeros(256, np.int64)
        h[rng.choice(256, k, replace=False)] = rng.integers(1, top + 1, k)
        if rng.random() < 0.3:  # powers of two: sums tie with leaves
            h = np.where(h > 0, 1 << (h % 5), 0).astype(np.int64)
        hs.append(h)
    return hs
