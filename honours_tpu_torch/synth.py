"""Seeded nanopore-like synthetic signal.

An event/noise model with parameters fitted to the three NA12878 reads
of tests/data/three-reads.blow5 (mean 460.6, sd 76.8, |delta| > 30 jump
rate 0.0387 -> mean dwell ~26, median |delta| 5): piecewise-constant
event levels with geometric dwell plus AR(1) noise.  It is not real
signal; its use is data that the canned tables never saw, made from a
seed.
"""

from __future__ import annotations

import numpy as np


def synthesize_corpus(n_samples: int, seed: int = 0) -> np.ndarray:
    """n_samples of int16 signal, deterministic in `seed`."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    out = np.empty(0, np.float64)
    while out.size < n_samples:
        m = n_samples - out.size
        n_ev = int(m / 26 * 1.3) + 16
        dwell = rng.geometric(1 / 26.0, n_ev)
        lvl = np.clip(rng.normal(461, 72, n_ev), 253, 697)
        out = np.concatenate([out, np.repeat(lvl, dwell)[:m]])
    eps = rng.normal(0, 5.5, n_samples)
    noise = lfilter([1.0], [1.0, -0.55], eps)  # AR(1), pole 0.55
    x = np.rint(out + noise)
    return np.clip(x, -32768, 32767).astype(np.int16)


def synthesize_bucket(B: int, L: int, seed: int = 0):
    """B synthetic reads with lengths uniform in (L/2, L], padded to one
    [B, L] int16 bucket.  Returns (sig, n int32)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    flat = synthesize_corpus(int(n.sum()), seed=seed)
    sig = np.zeros((B, L), np.int16)
    off = 0
    for i, m in enumerate(n):
        sig[i, :m] = flat[off: off + m]
        off += m
    return sig, n


def stall_set(seed: int = 0, stall: int = 30000) -> list[np.ndarray]:
    """16 reads, each 500 random samples in [300, 900), a stall of `stall`
    samples at 460 +- 4, then a random walk of 2 * `stall` steps (steps
    in [-40, 40]) from 460, clipped to [0, 1200]."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(16):
        walk = np.clip(460 + np.cumsum(rng.integers(-40, 41, 2 * stall)), 0,
                       1200)
        reads.append(np.concatenate([
            rng.integers(300, 900, 500), 460 + rng.integers(-4, 5, stall),
            walk]).astype(np.int16))
    return reads
