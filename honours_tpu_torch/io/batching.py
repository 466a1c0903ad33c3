"""Read batching: power-of-two length buckets, padding, order restoration.

Reads are independent compression streams; the parallel unit is a padded
[B, L] block.  Power-of-two L bounds the padding waste and the number of
distinct shapes; original read order is restored from the carried
indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_L = 1 << 10


@dataclass
class Bucket:
    L: int
    indices: np.ndarray  # original read positions
    sig: np.ndarray  # [B, L] int16
    n: np.ndarray  # [B] int32


def bucket_reads(signals, min_l: int = MIN_L, max_b: int = None):
    """Group reads into power-of-two-length padded buckets.

    Returns list of Bucket; every read appears in exactly one bucket.
    """
    sizes = np.array([s.size for s in signals], dtype=np.int64)
    Ls = np.maximum(min_l, 1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(int))
    buckets = []
    for L in sorted(set(Ls.tolist())):
        idx = np.nonzero(Ls == L)[0]
        for lo in range(0, idx.size, max_b or idx.size):
            part = idx[lo : lo + (max_b or idx.size)]
            B = part.size
            sig = np.zeros((B, L), dtype=np.int16)
            n = np.zeros(B, dtype=np.int32)
            for row, i in enumerate(part):
                sig[row, : sizes[i]] = signals[i]
                n[row] = sizes[i]
            buckets.append(Bucket(L=int(L), indices=part, sig=sig, n=n))
    return buckets


def restore_order(buckets, per_bucket_outputs):
    """Flatten per-bucket outputs (lists aligned with bucket rows) back
    into original read order."""
    total = sum(b.indices.size for b in buckets)
    out = [None] * total
    for b, outputs in zip(buckets, per_bucket_outputs):
        for row, i in enumerate(b.indices):
            out[i] = outputs[row]
    return out
