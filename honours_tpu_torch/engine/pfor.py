"""Batched turbopfor: block-wise patched frame-of-reference over the
zigzag deltas.

The counterpart of honours_tpu/codecs/pfor.py (TurboPforCodec), which
runs on the host only.  Stream, byte for byte the host codec's for every
read (an empty read is empty), per 128-value block of the zigzag-delta
stream (prev = 0):
  [b:1B][nex:1B][the low b bits of every value, MSB-first]
  [exception index:1B x nex][exception high part v >> b: u16 LE x nex]
b is the block's first cheapest width, 2 + ceil(blen b / 8) + 3 nex(b)
over b = 0..16, nex(b) the block's values of 2^b or more.

Press: the widths of every block at once from a histogram of the values'
bit lengths; the low bits packed by kernel I (engine/bitpack_cuda.py),
a row a block; the exception bytes placed by kernel 1's compaction and
expansion (engine/bits.py monotone_place).  Depress: kernel M
(engine/hdrwalk_cuda.py) finds each block's offset from the headers,
kernel J unpacks the low bits, the high parts are ORed in at their
indices, then the inverse zigzag delta.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.bitpack import MAX_WIDTH, _items, minbits
from honours_tpu_torch.engine.bitpack_cuda import pack_msb, unpack_msb
from honours_tpu_torch.engine.bits import bytes_at, monotone_place
from honours_tpu_torch.engine.hdrwalk_cuda import TURBOPFOR, hdrwalk
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

BLOCK = 128


def block_lengths(n, L: int):
    """(blocks of an L-wide row, [B, nblk] int64 values a block holds)."""
    nblk = -(-L // BLOCK)
    at = torch.arange(nblk, device=n.device)[None, :] * BLOCK
    return nblk, (n.to(torch.int64)[:, None] - at).clamp(0, BLOCK)


def press_pfor_batch(sig, n):
    """turbopfor of [B, L] int16 (first n valid) -> (stream [B, W] u8,
    len [B] int64)."""
    B, L = sig.shape
    dev = sig.device
    n = n.to(torch.int64).clamp(0, L)
    nblk, blen = block_lengths(n, L)
    N = nblk * BLOCK
    col = torch.arange(N, device=dev)[None, :]
    valid = col < n[:, None]
    z = torch.where(valid, F.pad(zigdelta(sig), (0, N - L)), 0)
    bits = minbits(z)
    # nex(b) = the block's values of more than b bits, from a histogram
    hist = torch.zeros((B, nblk, MAX_WIDTH + 2), dtype=torch.int64,
                       device=dev)
    hist.scatter_add_(2, bits.reshape(B, nblk, BLOCK),
                      valid.reshape(B, nblk, BLOCK).to(torch.int64))
    above = hist.flip(2).cumsum(2).flip(2)[:, :, 1:]  # [B, nblk, 17]
    widths = torch.arange(MAX_WIDTH + 1, device=dev)
    cost = 2 + (blen[:, :, None] * widths + 7) // 8 + 3 * above
    b = torch.argmin(cost, dim=2)  # the first minimum
    nex = above.gather(2, b[:, :, None])[:, :, 0]
    live = blen > 0
    low_bytes = (blen * b + 7) // 8
    size = torch.where(live, 2 + low_bytes + 3 * nex, 0)
    off = torch.cumsum(size, dim=1) - size
    W = 2 * nblk + 2 * N
    # column W takes the headers of empty blocks, and is dropped
    stream = torch.zeros((B, W + 1), dtype=torch.uint8, device=dev)
    for k, byte in enumerate((b, nex)):
        stream.scatter_(1, torch.where(live, off + k, W), byte.to(torch.uint8))
    rows = torch.arange(B, device=dev)[:, None]
    blk = torch.arange(nblk, device=dev)[None, :]
    pack_msb(z.to(torch.int32).reshape(-1),
             ((rows * nblk + blk) * BLOCK).reshape(-1), blen.reshape(-1),
             b.reshape(-1), stream.reshape(-1),
             (rows * (W + 1) + off + 2).reshape(-1))
    # the exceptions: index bytes, then u16 LE high parts, in index order
    bcol = b.repeat_interleave(BLOCK, dim=1)
    ex = valid & (bits > bcol)
    rank = torch.cumsum(ex.reshape(B, nblk, BLOCK).to(torch.int64),
                        dim=2).reshape(B, N) - 1
    ex_at = (off + 2 + low_bytes).repeat_interleave(BLOCK, dim=1)
    nex_col = nex.repeat_interleave(BLOCK, dim=1)
    idx, cov_i = monotone_place((col % BLOCK).expand(B, N).to(torch.int32),
                                ex, (ex_at + rank).to(torch.int32), W)
    hi, cov_h = monotone_place((z >> bcol).to(torch.int32), ex,
                               (ex_at + nex_col + 2 * rank).to(torch.int32),
                               W)
    hi = torch.where(cov_h, hi, 0)
    extra = (torch.where(cov_i, idx, 0) | (hi & 0xFF)
             | F.pad(hi >> 8, (1, 0))[:, :W])
    return stream[:, :W] | extra.to(torch.uint8), size.sum(dim=1)


def depress_pfor_batch(stream, n, L: int):
    """Inverse of press_pfor_batch (streams from either package) -> [B,
    L] int16, zero past n.  Bytes past a row read as 0."""
    B, M = stream.shape
    dev = stream.device
    n = n.to(torch.int64).clamp(0, L)
    nblk, blen = block_lengths(n, L)
    N = nblk * BLOCK
    stream = stream.contiguous()
    flat = stream.reshape(-1)
    rows = torch.arange(B, device=dev)[:, None]
    off = hdrwalk(stream, torch.zeros((B,), dtype=torch.int64, device=dev),
                  (n + BLOCK - 1) // BLOCK, blen, TURBOPFOR)
    b, nex = bytes_at(stream, off), bytes_at(stream, off + 1)
    blk = torch.arange(nblk, device=dev)[None, :]
    z = torch.zeros(B * N, dtype=torch.int32, device=dev)
    base = ((rows * nblk + blk) * BLOCK).reshape(-1)
    unpack_msb(flat, (rows * M + off + 2).reshape(-1),
               (M - off - 2).reshape(-1), blen.reshape(-1), b.reshape(-1),
               z, base)
    # the exceptions of every live block, laid end to end
    cnt = torch.where(blen > 0, nex, 0).reshape(-1)
    which, i = _items(cnt)
    if which.numel():
        r = which // nblk
        ex_at = (off + 2 + (blen * b + 7) // 8).reshape(-1)[which] + i
        hi_at = ex_at + nex.reshape(-1)[which] + i
        rel = torch.stack([ex_at, hi_at, hi_at + 1])
        ok = (rel >= 0) & (rel < M)
        got = torch.where(ok, flat[torch.where(ok, r * M + rel, 0)]
                          .to(torch.int64), 0)
        at, hi = got[0], got[1] | (got[2] << 8)
        keep = at < blen.reshape(-1)[which]
        pos = torch.where(keep, base[which] + at, 0)
        shift = b.reshape(-1)[which].clamp(0, 63)
        v = (z[pos].to(torch.int64) | (hi << shift)) & 0xFFFF
        z[pos[keep]] = v[keep].to(torch.int32)
    x = unzigdelta(z.reshape(B, N)[:, :L])
    col = torch.arange(L, device=dev)[None, :]
    return torch.where(col < n[:, None], x, 0).to(torch.int16)
