"""Canned order-1 frequency table (NA12878-trained, 64 context clusters).

257 rows x 256 symbols of 12-bit frequencies; every row sums to M and
every cell is >= 1, so any byte stream is encodable.  Row c < 256 models
P(byte | previous byte = c); row 256 is the marginal used as the context
of each lane's first symbol (CTX0).  Stored as zlib(uint16 LE [257, 256])
in na12878_o1.bin.z beside this module.  `_cluster_contexts` is the
deterministic k-means that tables/o1n.py clusters the nibble rows with.
"""

from __future__ import annotations

import functools
import zlib
from pathlib import Path

import numpy as np

_PATH = Path(__file__).parent / "na12878_o1.bin.z"


def _cluster_contexts(counts: np.ndarray, r: int, iters: int = 30):
    """Deterministic Hellinger k-means over context count rows.

    counts [C, 256] float64 (strictly positive).  Returns
    (assign [C] int, crows [r, 256] count-sums of each cluster).
    Farthest-point init starting from the heaviest row; fixed iteration
    count; ties resolved by argmin/argmax first-index so the result is
    platform-independent in float64.
    """
    w = counts.sum(axis=1)
    P = counts / w[:, None]
    X = np.sqrt(P)
    cent = [int(np.argmax(w))]
    d2 = ((X - X[cent[0]]) ** 2).sum(axis=1)
    for _ in range(r - 1):
        cent.append(int(np.argmax(d2 * w)))
        d2 = np.minimum(d2, ((X - X[cent[-1]]) ** 2).sum(axis=1))
    C = X[cent].copy()
    assign = np.zeros(counts.shape[0], dtype=np.int64)
    for _ in range(iters):
        d = ((X[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        assign = d.argmin(axis=1)
        for j in range(r):
            sel = assign == j
            if sel.any():
                cj = np.sqrt(np.average(P[sel], axis=0, weights=w[sel]))
                C[j] = cj / np.linalg.norm(cj)
    crows = np.zeros((r, counts.shape[1]), dtype=np.float64)
    for j in range(r):
        sel = assign == j
        crows[j] = counts[sel].sum(axis=0) if sel.any() else counts.sum(axis=0)
    return assign, crows


@functools.cache
def canned_o1_freqs() -> np.ndarray:
    """The committed NA12878 order-1 table, [257, 256] int64 (read-only)."""
    raw = zlib.decompress(_PATH.read_bytes())
    tab = np.frombuffer(raw, dtype="<u2").astype(np.int64).reshape(257, 256)
    tab.setflags(write=False)
    return tab
