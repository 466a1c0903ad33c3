"""Canned order-1 frequency table (NA12878-trained, 64 context clusters).

257 rows x 256 symbols of 12-bit frequencies; every row sums to M and
every cell is >= 1, so any byte stream is encodable.  Row c < 256 models
P(byte | previous byte = c); row 256 is the marginal used as the context
of each lane's first symbol (CTX0).  Stored as zlib(uint16 LE [257, 256])
in na12878_o1.bin.z beside this module.
"""

from __future__ import annotations

import functools
import zlib
from pathlib import Path

import numpy as np

_PATH = Path(__file__).parent / "na12878_o1.bin.z"


@functools.cache
def canned_o1_freqs() -> np.ndarray:
    """The committed NA12878 order-1 table, [257, 256] int64 (read-only)."""
    raw = zlib.decompress(_PATH.read_bytes())
    tab = np.frombuffer(raw, dtype="<u2").astype(np.int64).reshape(257, 256)
    tab.setflags(write=False)
    return tab
