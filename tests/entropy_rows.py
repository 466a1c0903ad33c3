"""Rows for the per-read entropy codecs' tests (CPU and card; no JAX):
Fibonacci histograms, whose Huffman tree has a code of a chosen depth,
and a read whose residual bytes have one."""

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
