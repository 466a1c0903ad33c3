"""Huffman decode lookup table over LSB-first bit windows."""

from __future__ import annotations

import numpy as np

from honours_tpu_torch.tables.huffman import HuffmanTable


def make_decode_lut(table: HuffmanTable, width: int = None):
    """LUT over `width`-bit windows -> (symbol, code length).

    Requires width >= max code length.  LSB-first: window bit 0 is the
    first stream bit.  Windows no code starts with hold (0, 0).
    """
    width = width or table.max_len
    assert width >= table.max_len <= 64
    sym_lut = np.zeros(1 << width, dtype=np.uint8)
    len_lut = np.zeros(1 << width, dtype=np.uint8)
    for s in table.present():
        L = int(table.lengths[s])
        code = int(table.codes[s])
        # all windows whose low L bits == code
        n_fill = 1 << (width - L)
        idx = code + (np.arange(n_fill, dtype=np.int64) << L)
        sym_lut[idx] = s
        len_lut[idx] = L
    return sym_lut, len_lut
