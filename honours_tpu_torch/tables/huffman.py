"""Huffman code tables: parsing and the canned NA12878 table.

Code representation: for each byte symbol s, `lengths[s]` bits and
`codes[s]` where bit j (1 << j) is the j-th emitted bit, the
reference's LSB-first bit order both in serialized code bytes
(huffman.c:24-31 get_bit) and in the encoded stream (huffman.c
do_memory_encode, decode mask walk huffman.c:1248-1260).

File format of NA12878_zd.huffman (reference:
press/huffman/huffman.c:426-480):

  [count:u32 BE][dataBytes:u32 BE]([sym:1B][numbits:1B][code bytes])*
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAX_SYMBOLS = 256
_PATH = Path(__file__).parent / "NA12878_zd.huffman"


@dataclass
class HuffmanTable:
    lengths: np.ndarray  # [256] int32
    codes: np.ndarray  # [256] uint64, LSB-first emitted bits
    present_mask: np.ndarray = None  # [256] bool; length 0 + present is the
    # degenerate single-symbol code (reference emits a numbits=0 entry)

    def __post_init__(self):
        if self.present_mask is None:
            self.present_mask = self.lengths > 0

    @property
    def max_len(self) -> int:
        return int(self.lengths.max())

    def present(self) -> np.ndarray:
        return np.nonzero(self.present_mask)[0]


def _parse_entries(buf: bytes, off: int, n: int):
    lengths = np.zeros(MAX_SYMBOLS, np.int32)
    codes = np.zeros(MAX_SYMBOLS, np.uint64)
    present = np.zeros(MAX_SYMBOLS, bool)
    for _ in range(n):
        sym = buf[off]
        nb = buf[off + 1]
        off += 2
        nbytes = (nb + 7) // 8
        codes[sym] = int.from_bytes(buf[off: off + nbytes], "little")
        lengths[sym] = nb
        present[sym] = True
        off += nbytes
    return HuffmanTable(lengths, codes, present), off


def parse_file(buf: bytes):
    """Returns (table, data_bytes)."""
    n, data_bytes = struct.unpack_from(">II", buf, 0)
    table, _ = _parse_entries(buf, 8, n)
    return table, data_bytes


@functools.cache
def na12878_table() -> HuffmanTable:
    """The canned NA12878 zigzag-delta static table of shuffman_vbbe21_zd
    (reference: press/NA12878_zd.huffman, generated by
    press/gen_huffman.c): 256 symbols, codes of 4 to 22 bits."""
    table, _ = parse_file(_PATH.read_bytes())
    return table
