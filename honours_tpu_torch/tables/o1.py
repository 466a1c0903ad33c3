"""Canned order-1 frequency table (NA12878-trained, 64 context clusters).

257 rows x 256 symbols of 12-bit frequencies; every row sums to M and
every cell is >= 1, so any byte stream is encodable.  Row c < 256 models
P(byte | previous byte = c); row 256 is the marginal used as the context
of each lane's first symbol (CTX0).  Stored as zlib(uint16 LE [257, 256])
in na12878_o1.bin.z beside this module.

`build_o1_freqs` regenerates it from the vbbe21 residual byte streams of
the three fixture reads (`fixture_streams`): order-1 counts shrunk
towards the marginal (SHRINK pseudo-counts a row), the 257 contexts
clustered to R_CLUSTERS rows by `_cluster_contexts` (a deterministic
Hellinger k-means, which tables/o1n.py also clusters the nibble rows
with), each cluster normalized to M.  `heldout_o1_freqs` is the same
build over read 0 alone: the held-out protocol scores reads 1-2, which
that table never saw.  numpy float64 throughout, so the integers are
those of honours_tpu's build_o1_freqs.
"""

from __future__ import annotations

import functools
import zlib
from pathlib import Path

import numpy as np

from honours_tpu_torch.kernels.rans import M, normalize_freqs

_PATH = Path(__file__).parent / "na12878_o1.bin.z"
_FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "data"
            / "three-reads.blow5")

SHRINK = 200.0
R_CLUSTERS = 64
_SCALE = 1 << 20


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


def build_o1_freqs(streams) -> np.ndarray:
    """Deterministic [257, 256] int64 table from training byte streams."""
    J = np.zeros((256, 256), dtype=np.float64)
    m = np.zeros(256, dtype=np.float64)
    for s in streams:
        s = np.asarray(s, dtype=np.uint8)
        if s.size > 1:
            np.add.at(J, (s[:-1].astype(np.int64), s[1:].astype(np.int64)), 1)
        m += np.bincount(s, minlength=256)
    marg = m + 1.0
    marg /= marg.sum()
    counts = np.concatenate([J + SHRINK * marg[None, :], marg[None, :]])
    assign, crows = _cluster_contexts(counts, R_CLUSTERS)
    rows = np.zeros((R_CLUSTERS, 256), dtype=np.int64)
    for j in range(R_CLUSTERS):
        # float -> exact integers before the deterministic normalizer
        rows[j] = normalize_freqs((crows[j] * _SCALE).astype(np.int64))
    out = rows[assign]
    assert (out >= 1).all() and (out.sum(axis=1) == M).all()
    return out


def fixture_streams() -> list[np.ndarray]:
    """The vbbe21 residual byte streams of the committed fixture reads
    (tests/data/three-reads.blow5): each read's zigzag-delta after its
    first value, less the exceptions (values > 255), as uint8."""
    import torch

    from honours_tpu_torch.engine.vbbe21 import vbbe21_parts_batch
    from honours_tpu_torch.io.blow5 import read_blow5
    from honours_tpu_torch.transforms.core import zigdelta

    streams = []
    for r in read_blow5(str(_FIXTURE), device="cpu").reads:
        zd = zigdelta(torch.from_numpy(r.signal)[None, :])
        n = torch.tensor([zd.shape[1] - 1])
        parts = vbbe21_parts_batch(zd[:, 1:], n)
        streams.append(parts["data"][0, : int(parts["data_len"][0])].numpy())
    return streams


@functools.cache
def heldout_o1_freqs() -> np.ndarray:
    """Order-1 table trained on fixture read 0 only (7,329 samples),
    [257, 256] int64 (read-only): the held-out protocol scores reads 1-2
    (155,185 and 95,350 samples), which it never saw."""
    tab = build_o1_freqs(fixture_streams()[:1])
    tab.setflags(write=False)
    return tab
