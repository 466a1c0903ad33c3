"""Kernel M: the segment-header walk (csrc/hdrwalk.cu), beside its plain
version hdrwalk_plain.

No TPU kernel stands behind it: honours_tpu walks these headers on the
host only (honours_tpu/codecs/pfor.py TurboPforCodec.depress, a block at
a time; codecs/flats.py FlatUintSubminCodec.depress, a segment at a
time).  A row's segments lie end to end, and each one's size follows
from its own header and its item count:
    H + ceil(count * byte[off + ib] / 8) + E * byte[off + ie]
turbopfor's blocks (engine/pfor.py) take TURBOPFOR, flat_uint_submin's
segments (engine/flats.py) FLATS.  The wrapper routes by device: CPU
tensors take the plain version, CUDA tensors launch the kernel, one
thread a row.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.bits import bytes_at

_WALK = kernel("hdrwalk", "hdrwalk.cu", "htt_hdrwalk", "pllppplllllpp")

#: (H, ib, ie, E) of each format: the header's bytes, the byte that
#: holds the width b, the byte that holds the exception count and the
#: bytes an exception
TURBOPFOR = (2, 0, 1, 3)
FLATS = (3, 2, 0, 0)


def hdrwalk_plain(stream, first, nseg, count, fmt):
    """Kernel M's plain version.  stream [B, M] u8, first / nseg [B],
    count [B, S] (any integer type), fmt = (H, ib, ie, E) -> [B, S]
    int64: segment s's offset for s < nseg (clamped to [0, S]), the byte
    after the last segment from there on.  Bytes outside a row read as 0
    and negative counts count as 0.  A step over every row a segment."""
    H, ib, ie, E = fmt
    B, S = count.shape
    dev = stream.device
    m = nseg.to(torch.int64).clamp(0, S)
    cnt = count.to(torch.int64).clamp(min=0)
    off = first.to(torch.int64).clone()
    out = torch.empty((B, S), dtype=torch.int64, device=dev)
    for s in range(S):
        out[:, s] = off
        size = H + (cnt[:, s] * bytes_at(stream, off + ib) + 7) // 8
        if E:
            size = size + E * bytes_at(stream, off + ie)
        off = torch.where(s < m, off + size, off)
    return out


def hdrwalk(stream, first, nseg, count, fmt):
    """Each segment's offset, [B, S] int64; see hdrwalk_plain."""
    if is_cpu(stream, first, nseg, count):
        return hdrwalk_plain(stream, first, nseg, count, fmt)
    check(stream, "stream", (torch.uint8,))
    if stream.dim() != 2 or count.dim() != 2:
        raise ValueError(f"stream {tuple(stream.shape)} and count "
                         f"{tuple(count.shape)} must be [B, M] and [B, S]")
    B, M = stream.shape
    S = count.shape[1]
    first = first.to(torch.int64).contiguous()
    nseg = nseg.to(torch.int64).contiguous()
    count = count.to(torch.int64).contiguous()
    check(first, "first", (torch.int64,), (B,))
    check(nseg, "nseg", (torch.int64,), (B,))
    check(count, "count", (torch.int64,), (B, S))
    H, ib, ie, E = fmt
    out = torch.empty((B, S), dtype=torch.int64, device=stream.device)
    _WALK(stream.data_ptr(), B, M, first.data_ptr(), nseg.data_ptr(),
          count.data_ptr(), S, H, ib, ie, E, out.data_ptr(),
          stream_ptr(stream.device))
    return out
