"""MSB-first fixed-width bit packing over ragged rows: the plain versions
of kernels I (pack) and J (unpack), csrc/bitpack.cu, whose wrappers
(engine/bitpack_cuda.py) route by the tensors' device.

The counterpart of honours_tpu/kernels/bitpack.py (pack_bits,
unpack_bits, minbits): each value's low b bits, MSB-first, the last byte
of a row padded with zeros in its low bits, as np.packbits does.  A row
is (its values' offset, count, width b, its bytes' offset): the uint
codecs (engine/uint.py) have one row a read, flat_uint_submin
(engine/flats.py) one a segment.  Widths are clamped to [0, 16] and
counts below 0 count as 0, on both routes; a row of width 0 has no
bytes.
"""

from __future__ import annotations

import torch

#: the widest field the kernels take
MAX_WIDTH = 16


def minbits(x: torch.Tensor) -> torch.Tensor:
    """int(x).bit_length() elementwise for 0 <= x < 2^53 (honours_tpu's
    minbits): 0 for 0."""
    x = x.to(torch.int64)
    return torch.where(x > 0, torch.frexp(x.to(torch.float64))[1].to(
        torch.int64), 0)


def _rows(count, width):
    cnt = count.to(torch.int64).clamp(min=0)
    b = width.to(torch.int64).clamp(0, MAX_WIDTH)
    return cnt, b


def exclusive(x: torch.Tensor) -> torch.Tensor:
    """[R] -> [R + 1] exclusive prefix sum, the total last."""
    return torch.nn.functional.pad(torch.cumsum(x.to(torch.int64), 0), (1, 0))


def _items(sizes: torch.Tensor):
    """(row of each item, its index within the row) of rows of `sizes`
    items, laid end to end."""
    R = sizes.numel()
    dev = sizes.device
    row = torch.repeat_interleave(torch.arange(R, device=dev), sizes)
    idx = torch.arange(row.numel(), device=dev) - exclusive(sizes)[row]
    return row, idx


def pack_msb_plain(values, val_off, count, width, out, out_off):
    """Kernel I's plain version.  values [V] int32 (each field's low b
    bits taken), val_off / count / width / out_off [R] int64: row r's
    ceil(count b / 8) packed bytes are written to out [O] u8 (flat) at
    out_off[r], every bit of them; nothing else of out changes.  Returns
    out."""
    cnt, b = _rows(count, width)
    nbytes = (cnt * b + 7) // 8
    total = int(nbytes.sum())
    if total == 0:
        return out
    pk = exclusive(nbytes)
    row, i = _items(cnt)
    bf = b[row]
    v = values.to(torch.int64)[val_off.to(torch.int64)[row] + i] & (
        (1 << bf) - 1)
    packed = torch.zeros(total, dtype=torch.int64, device=out.device)
    for k in range(MAX_WIDTH):  # bit k of each field, from its MSB
        live = k < bf
        p = i * bf + k
        bit = (v >> (bf - 1 - k).clamp(min=0)) & 1
        at = torch.where(live, pk[row] + (p >> 3), 0)
        packed.index_add_(0, at, torch.where(live, bit << (7 - (p & 7)), 0))
    brow, j = _items(nbytes)
    out[out_off.to(torch.int64)[brow] + j] = packed.to(torch.uint8)
    return out


def unpack_msb_plain(stream, in_off, in_len, count, width, out, out_off):
    """Kernel J's plain version.  stream [S] u8 (flat); row r's fields
    start at byte in_off[r], and its bytes at or past in_len[r] (or
    outside the stream) read as 0; its count[r] fields of width b go to
    out [O] int32 (flat) at out_off[r] + i.  Returns out."""
    cnt, b = _rows(count, width)
    if int(cnt.sum()) == 0:
        return out
    S = stream.numel()
    if S == 0:  # every byte reads as 0
        stream = torch.zeros(1, dtype=torch.uint8, device=stream.device)
    row, i = _items(cnt)
    bf = b[row]
    bit0 = i * bf
    base = in_off.to(torch.int64)[row]
    length = in_len.to(torch.int64)[row]
    win = torch.zeros_like(bit0)
    for q in range(3):
        pos = (bit0 >> 3) + q
        src = base + pos
        ok = (pos < length) & (src >= 0) & (src < S)
        byte = stream[torch.where(ok, src, 0)].to(torch.int64)
        win = (win << 8) | torch.where(ok, byte, 0)
    v = (win >> (24 - (bit0 & 7) - bf)) & ((1 << bf) - 1)
    out[out_off.to(torch.int64)[row] + i] = v.to(torch.int32)
    return out
