"""rANS constants shared by the encoder and decoder, and the
deterministic frequency normalizer the table builders use."""

from __future__ import annotations

import numpy as np

PROB_BITS = 12
M = 1 << PROB_BITS
RANS_L = 1 << 23
#: lanes per read in the shared-stream formats (one warp)
K_SHARED = 32
#: virtual context of each lane's first symbol (row 256 of an o1 table)
CTX0 = 256


def normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Normalize to sum M with every present symbol >= 1 (deterministic)."""
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum()
    if total == 0:
        return np.zeros(256, dtype=np.int64)
    f = counts * M // total
    f[(counts > 0) & (f == 0)] = 1
    diff = M - f.sum()
    # adjust the largest entries (stable order) until the sum is exact
    order = np.argsort(-f, kind="stable")
    i = 0
    while diff != 0:
        s = order[i % len(order)]
        step = 1 if diff > 0 else -1
        if f[s] + step >= 1 or counts[s] == 0:
            if counts[s] > 0 and (f[s] + step) >= 1:
                f[s] += step
                diff -= step
        i += 1
    return f
