"""Huffman code tables: the reference's tree build, the in-memory
serialisation of huffman_vb*_zd, parsing, and the canned NA12878 table.

Code representation: for each byte symbol s, `lengths[s]` bits and
`codes[s]` where bit j (1 << j) is the j-th emitted bit, the
reference's LSB-first bit order both in serialized code bytes
(huffman.c:24-31 get_bit) and in the encoded stream (huffman.c
do_memory_encode, decode mask walk huffman.c:1248-1260).

Serialized formats (reference: press/huffman/huffman.c:426-480, the
file format of NA12878_zd.huffman; :483-540, the in-memory variant whose
count field is one byte, the entries' count less one, mod 256):

  file:   [count:u32 BE][dataBytes:u32 BE]([sym:1B][numbits:1B][code bytes])*
  memory: [count-1:1B ][dataBytes:u32 BE]([sym:1B][numbits:1B][code bytes])*

with each entry's code in ceil(numbits / 8) bytes, little-endian, and
the entries in symbol order.  These are numpy helpers for the tests and
one-row paths; the batched encode and decode are engine/huffman.py's.
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


def build_table(freq) -> HuffmanTable:
    """The reference's tree (huffman.c:373-424 calculate_huffman_codes):
    leaves in symbol order, sorted stably by count; each round merges the
    two lowest (the first taken is the zero branch) and puts the merged
    node first, then sorts stably again, so it goes before every item of
    equal count.  A lone symbol gets a code of length 0."""
    freq = np.asarray(freq, dtype=np.uint64)
    items = [(int(freq[s]), s) for s in range(MAX_SYMBOLS) if freq[s] > 0]
    lengths = np.zeros(MAX_SYMBOLS, np.int32)
    codes = np.zeros(MAX_SYMBOLS, np.uint64)
    if not items:
        return HuffmanTable(lengths, codes)
    while len(items) > 1:
        items.sort(key=lambda t: t[0])  # stable, as glibc's mergesort qsort
        (c1, p1), (c2, p2) = items[0], items[1]
        items = [(c1 + c2, (p1, p2))] + items[2:]
    stack = [(items[0][1], 0, 0)]
    while stack:
        payload, code, depth = stack.pop()
        if isinstance(payload, tuple):
            stack.append((payload[0], code, depth + 1))  # zero branch
            stack.append((payload[1], code | (1 << depth), depth + 1))
        else:
            lengths[payload] = depth
            codes[payload] = code
    return HuffmanTable(lengths, codes, freq > 0)


def entries_bytes(table: HuffmanTable) -> bytes:
    """[sym][len][code, little-endian, ceil(len / 8) bytes] for each
    present symbol, in symbol order."""
    out = []
    for s in table.present():
        nb = int(table.lengths[s])
        out.append(bytes([s, nb])
                   + int(table.codes[s]).to_bytes((nb + 7) // 8, "little"))
    return b"".join(out)


def serialize_memory(table: HuffmanTable, data_bytes: int) -> bytes:
    """The in-memory table of huffman_vb*_zd: [(P - 1) & 0xFF][dataBytes:
    u32 BE][entries], P the present symbols (0xFF for an empty body)."""
    n = table.present().size
    return (bytes([(n - 1) & 0xFF]) + struct.pack(">I", data_bytes)
            + entries_bytes(table))


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


def parse_memory(buf: bytes):
    """serialize_memory's inverse -> (table, data_bytes, header_len).  An
    empty body (data_bytes 0) holds no entries, whatever its count byte
    says: an empty table and a header of 5 bytes."""
    n = buf[0] + 1
    (data_bytes,) = struct.unpack_from(">I", buf, 1)
    if data_bytes == 0:
        return (HuffmanTable(np.zeros(MAX_SYMBOLS, np.int32),
                             np.zeros(MAX_SYMBOLS, np.uint64)), 0, 5)
    table, off = _parse_entries(buf, 5, n)
    return table, data_bytes, off


@functools.cache
def na12878_table() -> HuffmanTable:
    """The canned NA12878 zigzag-delta static table of shuffman_vbbe21_zd
    (reference: press/NA12878_zd.huffman, generated by
    press/gen_huffman.c): 256 symbols, codes of 4 to 22 bits."""
    table, _ = parse_file(_PATH.read_bytes())
    return table
