"""Nibble-factorized order-1 tables for srans3 (wire format v4).

Derived deterministically from the canned byte-level o1 table
(tables/o1.py): P(b | cl) = P(hi | cl) * P(lo | cl, hi) factorizes
exactly, so
  H[cl, hi]  = sum_lo T[cl, hi*16+lo]        (sums to M exactly)
  lo rows    = T[cl, hi*16 : hi*16+16] blocks, Hellinger-clustered to
               R_LO rows and requantized to M.
"""

from __future__ import annotations

import functools

import numpy as np

from honours_tpu_torch.kernels.rans import M
from honours_tpu_torch.tables.o1 import _cluster_contexts, canned_o1_freqs

R_LO = 64


def _quant16(row: np.ndarray) -> np.ndarray:
    """[16] positive float counts -> int64 summing to M, cells >= 1."""
    q = np.maximum((row / row.sum() * M).astype(np.int64), 1)
    order = np.argsort(-q, kind="stable")
    i = 0
    while q.sum() != M:
        s = order[i % 16]
        if q.sum() < M:
            q[s] += 1
        elif q[s] > 1:
            q[s] -= 1
        i += 1
    return q


def build_nibble_tables(freq_tab: np.ndarray, r_lo: int = R_LO) -> dict:
    """[257, 256] byte o1 table -> dict(H [r, 16], L [r_lo, 16],
    cmap [257], lo_assign [r*16]), all int64."""
    T = np.asarray(freq_tab, np.int64)
    urows, cmap = np.unique(T, axis=0, return_inverse=True)
    r = urows.shape[0]
    Trows = urows.reshape(r, 16, 16)
    H = Trows.sum(axis=2)  # [r, 16], rows sum to M, cells >= 16
    lo_rows = Trows.reshape(r * 16, 16).astype(np.float64)
    assign, crows = _cluster_contexts(lo_rows + 1e-9, r_lo)
    L = np.stack([_quant16(crows[j]) for j in range(r_lo)])
    if not ((H.sum(axis=1) == M).all() and (L.sum(axis=1) == M).all()):
        raise AssertionError("nibble table rows must sum to M")
    return {
        "H": H,
        "L": L,
        "cmap": cmap.reshape(-1).astype(np.int64),
        "lo_assign": assign.astype(np.int64),
    }


@functools.cache
def canned_nibble_tables() -> dict:
    """The nibble tables of the canned o1 table (computed once; the
    arrays are read-only)."""
    nib = build_nibble_tables(canned_o1_freqs())
    for a in nib.values():
        a.setflags(write=False)
    return nib
