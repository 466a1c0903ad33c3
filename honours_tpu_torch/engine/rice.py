"""Batched Golomb-Rice encode and decode (the rice_vb*_zd family).

The reference's rice coder (press/press.c:4854-5391) emits, for each
residual byte v: q = v >> k ones, a zero, then the k low bits of v
MSB-first, LSB-first within stream bytes, after a 3-bit k header.  The
batched form: per-value code lengths -> prefix-sum bit offsets -> one
pack_fields_lsb pass.  Unary runs are never built as fields: the stream
is all ones over [0, total_bits) XOR a correction field of 1 + k bits
at each value's terminator position, so a run of any length costs
nothing.

Streams equal honours_tpu's engine byte for byte, and its host codec
(codecs/rice.py) for every read of n >= 1.

Decode: a rice stream is one serial bit stream per read with
data-dependent record lengths, so kernel B (rice_cuda.py) walks it, a
read a thread.  honours_tpu decodes it on the host only
(codecs/rice.py RiceVbZdCodec.depress); the port parses the exception
block as the vb_zd decode does, rice-decodes the n - 1 - nex residual
bytes after it and fills them in around the exceptions.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import (
    _words_to_bytes_le,
    pack_fields_lsb,
    read_u16le,
    rowwise_concat,
    u16le_bytes,
)
from honours_tpu_torch.engine.permute import M32
from honours_tpu_torch.engine.pipeline import _zd_merge, _zd_parts
from honours_tpu_torch.engine.rice_cuda import rice_decode
from honours_tpu_torch.engine.vb_batch import (
    _exblock_parts,
    parse_exblock_batch,
)
from honours_tpu_torch.engine.vbbe21 import vbbe21_fill_batch


def rice_encode_batch(data, dlen):
    """[B, N] byte values + lengths -> (blob [B, 4 * n_words] u8,
    blob_len [B]): codecs.rice.rice_encode(data[:dlen]) of each row,
    with the final byte's unused bits 0."""
    B, N = data.shape
    dev = data.device
    dlen = dlen.to(torch.int64)
    valid = torch.arange(N, device=dev)[None, :] < dlen[:, None]
    v = torch.where(valid, data.to(torch.int64), 0)

    # k in [0, 8) minimising sum(v >> k) + n (1 + k); the first on ties
    sizes = torch.stack([(v >> k).sum(dim=1) + dlen * (1 + k)
                         for k in range(8)])
    k = torch.argmin(sizes, dim=0)[:, None]  # [B, 1]

    q = v >> k
    lens = torch.where(valid, q + 1 + k, 0)
    ends = 3 + torch.cumsum(lens, dim=1)
    total_bits = ends[:, -1]

    # rev_k(v): the low k bits of v reversed (value bits go MSB-first)
    rev = torch.zeros_like(v)
    for j in range(7):
        sh = (k - 1 - j).clamp(0, 31)
        rev = rev | torch.where(j < k, ((v >> j) & 1) << sh, 0)
    corr = (rev << 1) ^ ((1 << (1 + k)) - 1)  # field [0, rev] inverted

    # 3-bit k header at stream bits 0..2: k2, k1, k0 (a field of its own,
    # like each value's 1 + k bit correction)
    hdr = (((k >> 2) & 1) | (((k >> 1) & 1) << 1) | ((k & 1) << 2)) ^ 7

    ones = torch.ones((B, 1), dtype=torch.int64, device=dev)
    n_words = (9 * N + 3 + 31) // 32 + 1
    corr_bytes = pack_fields_lsb(
        torch.cat([hdr, corr], dim=1),
        torch.cat([0 * ones, ends - lens + q], dim=1),
        torch.cat([ones.bool(), valid], dim=1), n_words)

    w = torch.arange(n_words, device=dev)[None, :]
    tb = total_bits[:, None]
    ones_words = torch.where((w + 1) * 32 <= tb, M32,
                             torch.where((tb >> 5) == w, (1 << (tb & 31)) - 1,
                                         0))
    return _words_to_bytes_le(ones_words) ^ corr_bytes, (total_bits + 7) // 8


def press_rice_vb_zd_batch(sig, n, kind: str, emax: int = None):
    """Batched rice_<kind>_zd encode of [B, L] int16 (first n valid) ->
    (stream [B, M] u8, len [B]): [zd0:u16][<kind> exception block][rice
    blob of the residual bytes].  Rows with more than emax exceptions
    give invalid streams (the nex field at byte 2 is exact either
    way)."""
    B, L = sig.shape
    emax = emax or L
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    segs, _, data, data_len = _exblock_parts(kind, rest, n - 1, emax)
    blob, blob_len = rice_encode_batch(data, data_len)
    two = torch.full((B,), 2, dtype=torch.int64, device=sig.device)
    segs = [(u16le_bytes(zd0), two)] + segs + [(blob, blob_len)]
    return rowwise_concat(segs, 2 + 32 + 7 * emax + blob.shape[1])


def depress_rice_vb_zd_batch(stream, n, kind: str, L: int, emax: int = None):
    """Batched rice_<kind>_zd decode -> [B, L] int16 (zero past n)."""
    B, M = stream.shape
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    zd0 = read_u16le(stream, zero)
    parsed = parse_exblock_batch(kind, stream, zero + 2, n - 1, L, emax)
    ndata = (n - 1 - parsed["nex"]).clamp(0, L)
    data = rice_decode(stream, parsed["end_off"].clamp(0, M).to(torch.int32),
                       ndata.to(torch.int32), L)
    vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    return _zd_merge(zd0, vals, n, L)
