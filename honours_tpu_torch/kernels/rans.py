"""rANS constants shared by the encoder and decoder, the deterministic
frequency normalizer the table builders use, and the table header of
rccdf's per-read static-CDF body (honours_tpu/kernels/rans.py:55-64,
111-123):

  [bitmap:32B, bit s & 7 of byte s >> 3 set where symbol s is present]
  [f - 1 of each present symbol in 12 bits, MSB-first, zero-padded]
"""

from __future__ import annotations

import numpy as np

PROB_BITS = 12
M = 1 << PROB_BITS
RANS_L = 1 << 23
#: lanes per read in the shared-stream formats (one warp)
K_SHARED = 32
#: virtual context of each lane's first symbol (row 256 of an o1 table)
CTX0 = 256
#: lanes per read of rccdf's static-CDF body (each lane its own bytes)
K_DEFAULT = 16
#: bytes of rccdf's presence bitmap
BITMAP_BYTES = 32


def rans_bound(n: int, K: int = K_DEFAULT) -> int:
    """The host's stream bound over n payload bytes (its rans_bound)."""
    return 32 + 384 + 8 * K + 2 * n + 64


def rccdf_header(freqs: np.ndarray) -> bytes:
    """The table header of a normalized [256] table (sum M, or all 0)."""
    f = np.asarray(freqs, dtype=np.int64)
    present = f > 0
    head = np.packbits(present.astype(np.uint8), bitorder="little").tobytes()
    vals = (f[present] - 1).astype(np.uint64)
    if not vals.size:
        return head
    bits = (vals[:, None] >> np.arange(PROB_BITS - 1, -1, -1,
                                       dtype=np.uint64)) & 1
    return head + np.packbits(bits.astype(np.uint8).ravel()).tobytes()


def parse_rccdf_header(buf: bytes):
    """rccdf_header's inverse -> (freqs [256] int64, header bytes)."""
    b = np.frombuffer(buf, dtype=np.uint8)
    present = np.unpackbits(b[:BITMAP_BYTES], bitorder="little").astype(bool)
    P = int(present.sum())
    nbytes = (P * PROB_BITS + 7) // 8
    bits = np.unpackbits(b[BITMAP_BYTES:BITMAP_BYTES + nbytes])
    bits = bits[: P * PROB_BITS].reshape(P, PROB_BITS).astype(np.int64)
    freqs = np.zeros(256, dtype=np.int64)
    freqs[present] = bits @ (1 << np.arange(PROB_BITS - 1, -1, -1)) + 1
    return freqs, BITMAP_BYTES + nbytes


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
