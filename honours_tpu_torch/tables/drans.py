"""drans table fitting — the self-contained dynamic order-1 model.

The drans_vbbe21_zd stream ships no table bytes: lane-grid steps
t < ceil(S / PREFIX_DEN) are coded with the canned o1 table, a bucketed
order-1 histogram of those prefix symbols is fitted by encoder and
decoder alike, and the remaining steps are coded with the fitted table.
Everything here is exact integer arithmetic, so every side of the
format fits bit-identical tables.
"""

from __future__ import annotations

import functools

import numpy as np

from honours_tpu_torch.kernels.rans import M, normalize_freqs
from honours_tpu_torch.tables.o1 import canned_o1_freqs

#: fitted-count weight: effective counts = prefix_counts * W_FIT + base
W_FIT = 4
#: prefix fraction: lane-grid steps t < ceil(S / PREFIX_DEN) use the
#: canned table and feed the fit
PREFIX_DEN = 4
#: number of context buckets (<= 64, the engine's cluster-table limit)
NB = 58

_THRESHOLDS = (48, 56, 64, 80, 96, 128, 160, 192, 224)


def bucket_of(ctx):
    """Closed-form context bucket map (numpy arrays or torch tensors).

    ctx 0..47 -> own bucket; [48,56) [56,64) [64,80) [80,96) [96,128)
    [128,160) [160,192) [192,224) [224,256) -> buckets 48..56;
    CTX0 (256) -> 57.
    """
    b = ctx * 0 + 47
    for lo in _THRESHOLDS:
        b = b + (ctx >= lo) * 1
    b = b + (ctx >= 256) * 1
    small = (ctx < _THRESHOLDS[0]) * 1
    return small * ctx + (1 - small) * b


@functools.cache
def base_rows() -> np.ndarray:
    """[NB, 256] canned-model bucket rows (each sums to M, read-only)."""
    canned = canned_o1_freqs()
    bmap = bucket_of(np.arange(257, dtype=np.int64))
    rows = np.stack(
        [normalize_freqs(canned[bmap == r].sum(axis=0)) for r in range(NB)]
    )
    rows.setflags(write=False)
    return rows


def dnorm(e: np.ndarray) -> np.ndarray:
    """Deterministic normalization of one count row to sum M.

    Each present symbol gets >= 1; the remainders of the proportional
    split are resolved by rank (largest remainder first, ties to the
    lower symbol index).  Counts are first rescaled so the row total is
    < 2^18, which keeps e*t below 2^31."""
    e = np.asarray(e, dtype=np.int64)
    present = (e > 0).astype(np.int64)
    npres = int(present.sum())
    tot = int(e.sum())
    assert tot > 0
    s = (tot >> 17) + 1
    e = np.maximum(e // s, present)
    tot = int(e.sum())
    t = M - npres
    q = (e * t) // tot
    rem = e * t - q * tot
    f = q + present
    diff = M - int(f.sum())  # in [0, npres)
    key = rem * 256 + (255 - np.arange(256, dtype=np.int64))
    order = np.argsort(-key, kind="stable")
    f[order[:diff]] += 1
    return f


def fit_freqs(counts: np.ndarray) -> np.ndarray:
    """[NB, 256] prefix counts -> [257, 256] fitted o1 table (rows sum
    to M, every cell >= 1 because the base rows are)."""
    eff = np.asarray(counts, dtype=np.int64) * W_FIT + base_rows()
    rows = np.stack([dnorm(eff[r]) for r in range(NB)])
    return rows[bucket_of(np.arange(257, dtype=np.int64))]


def prefix_steps(S: int) -> int:
    """Format-defined table-switch step: t < T0 canned, t >= T0 fitted."""
    return -(-S // PREFIX_DEN)
