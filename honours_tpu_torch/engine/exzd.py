"""Batched ex-zd (`hasgam_vbsse21_zdq`), the production slow5lib codec
variant.

Pipeline (reference: press/ex_zd.c:403-457 ptr_compress_ex_zd_v0): the
largest shift q <= 5 that every sample's low bits allow (qts,
press/ex_zd.c:358-381) -> arithmetic right shift -> zigzag-delta ->
exception block whose position deltas and values minus 256 are both
svb32-coded -> one-byte residual.  The exception scan is
engine/vb_batch._ex_parts, the blobs ride the batched svb32 engine, and
the residual merge is vbbe21_fill_batch.

Stream: [ver:1][nin:u64 LE][q:1][zd0:u16][nex:u32][exception block]
[residual bytes].  Streams equal honours_tpu's engine byte for byte, and
its host codec (codecs/exzd.py ExZdCodec) for every read of n >= 1.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import (
    read_u16le,
    read_u32le,
    rowwise_concat,
    u16le_bytes,
    u32le_bytes,
)
from honours_tpu_torch.engine.permute import rowwise_shift_left
from honours_tpu_torch.engine.svb32 import (
    svb32_decode_batch,
    svb32_encode_batch,
)
from honours_tpu_torch.engine.vb_batch import _ex_parts, _place, _round4
from honours_tpu_torch.engine.vbbe21 import vbbe21_fill_batch, wrap_i32
from honours_tpu_torch.transforms.core import find_qts

HDR = 12  # [ver:1][nin:u64 LE][q:1][zd0:u16]


def _zigdelta_q(sig, q):
    """qts shift, then zigzag-delta, in masked uint16 space."""
    u = sig.to(torch.int64) & 0xFFFF
    s = u - ((u & 0x8000) << 1)  # sign-extended int16
    uq = (s >> q[:, None]) & 0xFFFF  # arithmetic shift, back to u16
    prev = torch.nn.functional.pad(uq[:, :-1], (1, 0))
    d = (uq - prev) & 0xFFFF
    sign = (0x10000 - (d >> 15)) & 0xFFFF
    return ((d + d) & 0xFFFF) ^ sign


def _u64le_bytes(x):
    """[B] counts < 2^31 -> [B, 8] u8 little-endian."""
    lo = u32le_bytes(x)
    return torch.cat([lo, torch.zeros_like(lo)], dim=1)


def press_exzd_batch(sig, n, emax: int = None):
    """Batched hasgam_vbsse21_zdq encode of [B, L] int16 (first n valid)
    -> (stream [B, M] u8, len [B]).  `emax` caps the exception buffers;
    rows with nex > emax give invalid streams (the nex field at byte 12
    is exact either way)."""
    B, L = sig.shape
    dev = sig.device
    emax = emax or L
    e4 = _round4(emax)
    n = n.to(torch.int64)
    q = find_qts(sig, n)
    zd = _zigdelta_q(sig, q)
    rest = torch.nn.functional.pad(zd[:, 1:], (0, 1))
    p = _ex_parts(rest, n - 1, emax)
    nex, ex_pos = p["nex"], p["ex_pos"]
    prev = torch.nn.functional.pad(ex_pos[:, :-1], (1, 0), value=-1)
    pos_delta = torch.nn.functional.pad(ex_pos - prev - 1, (0, e4 - emax))
    vals32 = torch.nn.functional.pad((p["ex_val"] - 256) & 0xFFFF,
                                     (0, e4 - emax))
    pos_buf, pos_len = svb32_encode_batch(pos_delta, nex)
    val_buf, val_len = svb32_encode_batch(vals32, nex)
    many = nex > 1
    raw1 = torch.cat([u32le_bytes(ex_pos[:, 0]), u32le_bytes(vals32[:, 0])],
                     dim=1)
    hdr = torch.cat([
        torch.zeros((B, 1), dtype=torch.uint8, device=dev),  # version 0
        _u64le_bytes(n),  # nin
        q.to(torch.uint8)[:, None],  # qts shift
        u16le_bytes(zd[:, 0]),  # first zigzag-delta
    ], dim=1)
    ones = torch.ones((B,), dtype=torch.int64, device=dev)
    segs = [
        (hdr, HDR * ones),
        (u32le_bytes(nex), 4 * ones),
        (u32le_bytes(pos_len), torch.where(many, 4, 0)),
        (pos_buf, torch.where(many, pos_len, 0)),
        (u32le_bytes(val_len), torch.where(many, 4, 0)),
        (val_buf, torch.where(many, val_len, 0)),
        (raw1, torch.where(nex == 1, 8, 0)),
        (p["data"], p["data_len"]),
    ]
    total = HDR + 4 + 4 + pos_buf.shape[1] + 4 + val_buf.shape[1] + 8 + L
    return rowwise_concat(segs, total)


def depress_exzd_batch(stream, n, L: int, emax: int = None):
    """Batched hasgam_vbsse21_zdq decode -> [B, L] int16 (zero past n)."""
    B = stream.shape[0]
    dev = stream.device
    emax = emax or L
    e4 = _round4(emax)
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    q = stream[:, 9].to(torch.int64)
    zd0 = read_u16le(stream, zero + 10)
    nex = wrap_i32(read_u32le(stream, zero + HDR))
    many = nex > 1
    off = zero + HDR + 4
    pos_len = wrap_i32(read_u32le(stream, off))
    pos_blob = rowwise_shift_left(stream, off + 4, 4 + 5 * e4)
    pos_delta = wrap_i32(svb32_decode_batch(pos_blob, nex, e4)[:, :emax])
    ex_pos_many = torch.cumsum(pos_delta + 1, dim=1) - 1
    off_after_pos = torch.where(many, off + 4 + pos_len, off)
    val_len = wrap_i32(read_u32le(stream, off_after_pos))
    val_blob = rowwise_shift_left(stream, off_after_pos + 4, 4 + 5 * e4)
    ex_val_many = wrap_i32(svb32_decode_batch(val_blob, nex, e4)[:, :emax])
    pos1 = wrap_i32(read_u32le(stream, off))
    val1 = wrap_i32(read_u32le(stream, off + 4))
    ex_pos = torch.where(many[:, None], ex_pos_many, pos1[:, None])
    ex_val = torch.where(many[:, None], ex_val_many, val1[:, None])
    end_off = torch.where(many, off_after_pos + 4 + val_len,
                          torch.where(nex == 1, off + 8, off))
    ex_grid, ex_mask = _place(ex_val + 256, ex_pos, nex, L)
    parsed = {"ex_grid": ex_grid, "ex_mask": ex_mask, "nex": nex,
              "end_off": end_off}
    data = rowwise_shift_left(stream, end_off, L)
    vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    # merge zd0 and vals, invert the zigzag-delta, then undo the qts shift
    pos = torch.arange(L, device=dev)[None, :]
    live = pos < n[:, None]
    zd = torch.cat([zd0[:, None], vals[:, : L - 1].to(torch.int64)], dim=1)
    z = torch.where(live, zd, 0) & 0xFFFF
    d = ((z >> 1) ^ (0x10000 - (z & 1)) & 0xFFFF) & 0xFFFF
    s = torch.cumsum(d, dim=1) & 0xFFFF
    # a shift of 16 or more leaves no low 16 bits, as XLA's does
    out = (s << q.clamp(max=16)[:, None]) & 0xFFFF  # qts unshift, u16 wrap
    out = out - ((out & 0x8000) << 1)
    return torch.where(live, out, 0).to(torch.int16)
