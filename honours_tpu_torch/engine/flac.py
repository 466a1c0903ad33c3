"""Batched flac: fixed polynomial predictors of order 0-4 and Rice-coded
residuals, a block of 4,096 samples at a time.

The counterpart of honours_tpu/codecs/flac.py (FlacCodec), which runs on
the host only.  Stream, byte for byte the host codec's for every read
(an empty read is empty), per block (the last one shorter):
  [15][the samples, i16 LE]                           verbatim, or
  [order][k][warm-up i16 LE x order][Rice bits]       byte aligned
the Rice bits LSB-first: per residual z (the zigzag of the order-th
difference) q = z >> k ones, a zero, then the k low bits of z LSB-first.

Press, every block of the bucket at once: the residuals of each order o
< min(5, blen) (at most 2^20 once zigzagged, an order-4 difference of
int16), k0 from the integer mean sum // count (which equals the host's
int(float mean): the float64 sum of at most 4,096 values below 2^20 is
exact, and a quotient's distance to the next integer, at least 1/4,096,
is far above its rounding), then k in k0 - 2 .. min(30, k0 + 2) with the
first least sum(z >> k) + count (1 + k); the order with the first least
2 + 2 order + ceil(bits / 8); verbatim where that is not below 1 + 2
blen.  The Rice bits are one pass of pack_fields_lsb (engine/bits.py):
ones over each block's Rice region XOR, at each residual's zero bit, the
field ((z & mask_k) << 1) ^ (2^(1 + k) - 1) of 1 + k <= 31 bits, so a
unary run of any length costs nothing (engine/rice.py's scheme, without
its bit reversal).  Decode: kernel N (engine/flac_cuda.py), a walk a
read over all its blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.bitpack import minbits
from honours_tpu_torch.engine.bits import pack_fields_lsb
from honours_tpu_torch.engine.flac_cuda import (
    BLOCK,
    MAX_K,
    MAX_ORDER,
    VERBATIM,
    flac_decode,
)

#: a cost above any block's
_NEVER = 1 << 62


def _best_k(z, cnt):
    """Each block's k and Rice bits: z [B, nblk, w] zigzagged residuals
    (zeros past cnt), cnt [B, nblk] > 0 where it counts."""
    k0 = (minbits(z.sum(dim=2) // cnt.clamp(min=1)) - 1).clamp(min=0)
    best_k = best = None
    for d in range(-2, 3):  # k0 - 2 .. k0 + 2, ascending
        k = k0 + d
        ok = (k >= 0) & (k <= MAX_K)
        kk = k.clamp(0, MAX_K)
        cost = (z >> kk[:, :, None]).sum(dim=2) + cnt * (1 + kk)
        cost = torch.where(ok, cost, _NEVER)
        if best is None:
            best_k, best = kk, cost
        else:
            better = cost < best
            best_k = torch.where(better, kk, best_k)
            best = torch.minimum(cost, best)
    return best_k, best


def press_flac_batch(sig, n):
    """flac of [B, L] int16 (first n valid) -> (stream [B, W] u8, len [B]
    int64)."""
    B, L = sig.shape
    dev = sig.device
    n = n.to(torch.int64).clamp(0, L)
    nblk = -(-L // BLOCK)
    N = nblk * BLOCK
    blen = (n[:, None] - torch.arange(nblk, device=dev)[None, :] * BLOCK
            ).clamp(0, BLOCK)
    x = F.pad(sig.to(torch.int64), (0, N - L)).reshape(B, nblk, BLOCK)
    i = torch.arange(BLOCK, device=dev)
    best = order = k = zsel = None
    r = x
    for o in range(MAX_ORDER + 1):
        if o:
            r = r[:, :, 1:] - r[:, :, :-1]
        cnt = (blen - o).clamp(min=0)
        z = torch.where(i[: BLOCK - o] < cnt[:, :, None], (r << 1) ^ (r >> 63),
                        0)
        ko, bits = _best_k(z, cnt)
        cost = torch.where(o < blen, 2 + 2 * o + (bits + 7) // 8, _NEVER)
        z = F.pad(z, (0, o))
        if best is None:
            best, order, k, zsel, nbits = cost, cost * 0, ko, z, bits
            continue
        better = cost < best  # the first least order
        best = torch.where(better, cost, best)
        order = torch.where(better, o, order)
        k = torch.where(better, ko, k)
        nbits = torch.where(better, bits, nbits)
        zsel = torch.where(better[:, :, None], z, zsel)
    live = blen > 0
    verb = live & (best >= 1 + 2 * blen)
    rice = live & ~verb
    nbits = torch.where(rice, nbits, 0)
    size = torch.where(verb, 1 + 2 * blen, torch.where(rice, best, 0))
    off = torch.cumsum(size, dim=1) - size
    end = off + size
    rs = off + 2 + 2 * order  # each block's first Rice byte
    W = N * 2 + nblk
    n_words = -(-W // 4) + 1

    # the correction fields: one a residual of a Rice block, at its zero
    # bit; every other column a field of 0 at its block's end, so the
    # offsets never fall
    cnt = torch.where(rice, blen - order, 0)
    kk = k[:, :, None]
    q = zsel >> kk
    field = (i < cnt[:, :, None])
    lens = torch.where(field, q + 1 + kk, 0)
    at = 8 * rs[:, :, None] + torch.cumsum(lens, dim=2) - lens + q
    corr = ((zsel & ((1 << kk) - 1)) << 1) ^ ((1 << (1 + kk)) - 1)
    corr = torch.where(field, corr, 0)
    at = torch.where(field, at, 8 * end[:, :, None])
    valid = torch.ones((B, N), dtype=torch.bool, device=dev)
    stream = pack_fields_lsb(corr.reshape(B, N), at.reshape(B, N), valid,
                             n_words)[:, :W]

    # ones over each Rice region: whole bytes, then the last byte's bits
    full = rs + nbits // 8
    edge = torch.zeros((B, W + 2), dtype=torch.int32, device=dev)
    one = torch.ones_like(rs, dtype=torch.int32)
    edge.scatter_add_(1, torch.where(rice, rs, W + 1), one)
    edge.scatter_add_(1, torch.where(rice, full, W + 1), -one)
    ones = torch.where(torch.cumsum(edge, dim=1)[:, :W] > 0, 0xFF, 0)
    part = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)
    part.scatter_(1, torch.where(rice & (nbits % 8 > 0), full, W),
                  (1 << (nbits % 8)) - 1)
    stream = stream ^ (ones | part[:, :W]).to(torch.uint8)

    # the headers, the warm-up and the verbatim samples (columns W and W
    # + 1 take what is not written, and are dropped)
    stream = F.pad(stream, (0, 2))
    stream.scatter_(1, torch.where(live, off, W),
                    torch.where(verb, VERBATIM, order).to(torch.uint8))
    stream.scatter_(1, torch.where(rice, off + 1, W), k.to(torch.uint8))
    u = x & 0xFFFF
    warm = rice[:, :, None] & (i < order[:, :, None])
    put = verb[:, :, None] & (i < blen[:, :, None])
    p = torch.where(put, off[:, :, None] + 1 + 2 * i,
                    torch.where(warm, off[:, :, None] + 2 + 2 * i, W))
    p = p.reshape(B, N)
    stream.scatter_(1, p, (u & 0xFF).reshape(B, N).to(torch.uint8))
    stream.scatter_(1, torch.where(p < W, p + 1, W),
                    (u >> 8).reshape(B, N).to(torch.uint8))
    return stream[:, :W], size.sum(dim=1)


def depress_flac_batch(stream, n, L: int):
    """Inverse of press_flac_batch (streams from either package) -> [B,
    L] int16, zero past n."""
    return flac_decode(stream.contiguous(), n.to(torch.int32).contiguous(), L)
