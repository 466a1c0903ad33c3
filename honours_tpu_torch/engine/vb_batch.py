"""Batched vb exception containers: vb1e2, vbe21, vbsbe21, vbsse21, and
the classic svb over zigzag-deltas.

The reference's exception family (press/press.c:2575-3360; vbbe21 lives
in engine/vbbe21.py).  All containers share one machinery: the exception
mask (values above 255) drives monotone compactions of positions, values
and residual bytes (kernel 1), u32/u16 grids serialise raw position and
value lists, and the svb-coded variants code their lists with the
batched svb32 (positions) and svb16 with zd off (vbsse21's values,
kernels 5 and 6).  Decode parsers give the same {ex_grid, ex_mask, nex,
end_off} dict as vbbe21_parse_batch, so vbbe21_fill_batch merges the
residual bytes for every container.

The *_zd pipelines are [zd0:u16][container over zd[1:]]
(press/press.c:3367-3580): press_vb_zd_batch / depress_vb_zd_batch.
svb_zd and svb0124_zd are svb32 over the whole zigzag-delta, no header:
press_svb_zd_batch / depress_svb_zd_batch.  Streams equal honours_tpu's
engine byte for byte, and its host codecs for every read of n >= 1.

The raw containers (codecs/vb.py VbCodec, codecs/svb.py Svb and
Svb0124) code the samples themselves as uint16, so a negative sample is
a value of 0x8000-0xFFFF and an exception: press_vb_batch /
depress_vb_batch ([<kind> block][1-byte data], or vb1e2's payload) and
press_svb_batch / depress_svb_batch (svb32 of the samples widened to
uint32).  Their streams are the host codec's for every read, n = 0
included.  vb_parts, vb_parse and vb_fill are the raw block's press
and parse, which the range-coder codecs over raw samples share
(engine/rc.py).
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import (
    monotone_place,
    read_u16le,
    read_u32le,
    rowwise_concat,
    u16le_bytes,
    u32le_bytes,
    unpack_fields_msb,
)
from honours_tpu_torch.engine.permute import (
    compaction_shifts,
    monotone_compact,
    monotone_expand,
    rowwise_shift_left,
)
from honours_tpu_torch.engine.pipeline import _zd_merge, _zd_parts
from honours_tpu_torch.engine.svb16 import (
    _interleave2,
    svb16_decode_batch,
    svb16_encode_batch,
)
from honours_tpu_torch.engine.svb32 import (
    svb32_decode_batch,
    svb32_encode_batch,
)
from honours_tpu_torch.engine.vbbe21 import (
    _uint_pack,
    vbbe21_fill_batch,
    vbbe21_parse_batch,
    vbbe21_parts_batch,
    wrap_i32,
)
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

def _round4(x: int) -> int:
    return -(-x // 4) * 4


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _ex_scan(v, n):
    """(pos, valid, ex, nex) of [B, L] uint16-valued ints, first n
    valid: the exception mask is v > 255."""
    L = v.shape[1]
    pos = torch.arange(L, device=v.device)[None, :]
    valid = pos < n.to(torch.int64)[:, None]
    ex = (v > 255) & valid
    return pos, valid, ex, ex.sum(dim=1)


def _ex_positions(pos, ex, emax: int):
    """The exception positions packed left, first emax -> [B, emax]."""
    out, _ = monotone_compact(pos.expand(ex.shape).to(torch.int32), ex)
    return out[:, :emax].to(torch.int64)


def _ex_parts(v, n, emax: int):
    """Shared exception scan: counts, compacted positions and values
    (first emax), residual low bytes and their lengths."""
    v = v.to(torch.int64)
    n = n.to(torch.int64)
    pos, valid, ex, nex = _ex_scan(v, n)
    ex_val, _ = monotone_compact(torch.where(ex, v, 0).to(torch.int32), ex)
    plain = valid & ~ex
    data, _ = monotone_compact(torch.where(plain, v & 0xFF, 0).to(torch.uint8),
                               plain)
    return dict(nex=nex, ex_pos=_ex_positions(pos, ex, emax),
                ex_val=ex_val[:, :emax].to(torch.int64), data=data,
                data_len=n - nex)


def _u32_grid_bytes(x):
    """[B, E] uint32 -> [B, 4E] u8 little-endian."""
    B, E = x.shape
    sh = torch.tensor([0, 8, 16, 24], device=x.device)
    return ((x.to(torch.int64)[:, :, None] >> sh) & 0xFF).to(
        torch.uint8).reshape(B, 4 * E)


def _u16_grid_bytes(x):
    """[B, E] uint16 -> [B, 2E] u8 little-endian."""
    B, E = x.shape
    sh = torch.tensor([0, 8], device=x.device)
    return ((x.to(torch.int64)[:, :, None] >> sh) & 0xFF).to(
        torch.uint8).reshape(B, 2 * E)


def _u32_grid_read(stream, off, E: int):
    """Per-row u32 list at byte offset off -> [B, E] (their int32
    reading, in int64)."""
    B = stream.shape[0]
    b = rowwise_shift_left(stream, off, 4 * E).to(torch.int64).reshape(
        B, E, 4)
    return wrap_i32(b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16)
                    | (b[:, :, 3] << 24))


def _u16_grid_read(stream, off, E: int):
    B = stream.shape[0]
    b = rowwise_shift_left(stream, off, 2 * E).to(torch.int64).reshape(
        B, E, 2)
    return b[:, :, 0] | (b[:, :, 1] << 8)


def _four(B: int, dev):
    return torch.full((B,), 4, dtype=torch.int64, device=dev)


def _place(ex_val, ex_pos, nex, L: int):
    """Exception values on the [B, L] grid at their positions ->
    (ex_grid, ex_mask)."""
    eidx = torch.arange(ex_pos.shape[1], device=ex_pos.device)[None, :]
    ex_valid = eidx < nex[:, None]
    tgt = torch.where(ex_valid, ex_pos.clamp(0, L - 1), 0)
    return monotone_place(ex_val.to(torch.int32), ex_valid,
                          tgt.to(torch.int32), L)


# ---------------------------------------------------------------------------
# vb1e2: [nex:u32][ex_pos u32 x nex][1B data, exceptions inline 2B LE]
# ---------------------------------------------------------------------------


def _vb1e2_segs(v, n, emax: int):
    B, L = v.shape
    v = v.to(torch.int64)
    pos, valid, ex, nex = _ex_scan(v, n)
    lo = (v & 0xFF).to(torch.uint8)
    hi = ((v >> 8) & 0xFF).to(torch.uint8)
    data, data_len = monotone_compact(_interleave2(lo, hi),
                                      _interleave2(valid, ex))
    segs = [
        (u32le_bytes(nex), _four(B, v.device)),
        (_u32_grid_bytes(_ex_positions(pos, ex, emax)), 4 * nex),
        (data, data_len),
    ]
    return segs, 4 + 4 * emax + 2 * L


def vb1e2_encode_batch(v, n, emax: int = None):
    """vb1e2 payload of [B, L] uint16-valued ints (first n valid) ->
    (stream, len)."""
    return rowwise_concat(*_vb1e2_segs(v, n, emax or v.shape[1]))


def vb1e2_decode_batch(stream, base_off, n, L: int, emax: int = None):
    """The vb1e2 payload at base_off of each row -> [B, L] values
    (int64), zero past n."""
    emax = emax or L
    dev = stream.device
    base_off = base_off.to(torch.int64)
    nex = wrap_i32(read_u32le(stream, base_off))
    ex_pos = _u32_grid_read(stream, base_off + 4, emax)
    _, ex_mask = _place(torch.ones_like(ex_pos), ex_pos, nex, L)
    valid = torch.arange(L, device=dev)[None, :] < n.to(torch.int64)[:, None]
    data = rowwise_shift_left(stream, base_off + 4 + 4 * nex, 2 * L)
    shift, cnt = compaction_shifts(_interleave2(valid, valid & ex_mask))
    validc = torch.arange(2 * L, device=dev)[None, :] < cnt[:, None]
    grid, _ = monotone_expand(data, shift, validc, 2 * L)
    b0 = grid[:, 0::2].to(torch.int64)
    b1 = grid[:, 1::2].to(torch.int64)
    return torch.where(valid, torch.where(ex_mask, b0 | (b1 << 8), b0), 0)


# ---------------------------------------------------------------------------
# vbe21: [nex:u32][ex_pos u32 x nex][ex u16 x nex][1B data]
# ---------------------------------------------------------------------------


def vbe21_encode_batch(v, n, emax: int = None):
    """vbe21 payload -> (stream, len)."""
    return rowwise_concat(*_encoder_segs("vbe21", v, n, emax or v.shape[1]))


def vbe21_parse_batch(stream, base_off, n, L: int, emax: int = None):
    """Parse the vbe21 exception block at base_off -> {ex_grid, ex_mask,
    nex, end_off}."""
    emax = emax or L
    base_off = base_off.to(torch.int64)
    nex = wrap_i32(read_u32le(stream, base_off))
    ex_pos = _u32_grid_read(stream, base_off + 4, emax)
    ex_val = _u16_grid_read(stream, base_off + 4 + 4 * nex, emax)
    ex_grid, ex_mask = _place(ex_val, ex_pos, nex, L)
    return {"ex_grid": ex_grid, "ex_mask": ex_mask, "nex": nex,
            "end_off": base_off + 4 + 6 * nex}


# ---------------------------------------------------------------------------
# vbsbe21 / vbsse21: vbbe21 framing with svb-coded exception blocks
# (press/press.c:2972-2978, 3178-3184)
# ---------------------------------------------------------------------------


def _svb16_values(vals, emax: int):
    """vbsse21's exception values minus 256 (uint16) -> the [B,
    round8(emax)] int16 rows that svb16 with zd off codes."""
    v = torch.nn.functional.pad(vals, (0, _round8(emax) - emax))
    return (v - ((v & 0x8000) << 1)).to(torch.int16)  # uint16 wrap


def _svb_exblock_parts(p, emax: int, val_svb: bool):
    """nex > 1 block: [poslen:u32][svb32 pos deltas][vallen:u32][value
    blob: svb16 with zd off (vbsse21) or uint_press (vbsbe21)] of the
    values minus 256; nex == 1: [pos:u32][value - 256:u16].  Returns
    (segs, width)."""
    nex = p["nex"]
    B = nex.shape[0]
    ex_pos = p["ex_pos"]
    e4 = _round4(emax)
    prev = torch.nn.functional.pad(ex_pos[:, :-1], (1, 0), value=-1)
    pos_delta = torch.nn.functional.pad(ex_pos - prev - 1, (0, e4 - emax))
    pos_buf, pos_len = svb32_encode_batch(pos_delta, nex)
    vals = (p["ex_val"] - 256) & 0xFFFF
    if val_svb:
        val_buf, val_len = svb16_encode_batch(_svb16_values(vals, emax), nex,
                                              zd=False)
    else:
        val_buf, val_len = _uint_pack(vals, nex, 2 * emax)
    many = nex > 1
    raw1 = torch.cat([u32le_bytes(ex_pos[:, 0]), u16le_bytes(vals[:, 0])],
                     dim=1)
    segs = [
        (u32le_bytes(nex), _four(B, nex.device)),
        (u32le_bytes(pos_len), torch.where(many, 4, 0)),
        (pos_buf, torch.where(many, pos_len, 0)),
        (u32le_bytes(val_len), torch.where(many, 4, 0)),
        (val_buf, torch.where(many, val_len, 0)),
        (raw1, torch.where(nex == 1, 6, 0)),
    ]
    return segs, 4 + 4 + pos_buf.shape[1] + 4 + val_buf.shape[1] + 6


def vbs_encode_batch(v, n, emax: int = None, val_svb: bool = False):
    """vbsbe21 (val_svb=False) / vbsse21 (val_svb=True) payload ->
    (stream, len)."""
    kind = "vbsse21" if val_svb else "vbsbe21"
    return rowwise_concat(*_encoder_segs(kind, v, n, emax or v.shape[1]))


def vbs_parse_batch(stream, base_off, n, L: int, val_svb: bool,
                    emax: int = None):
    """Parse the vbsbe21 / vbsse21 exception block at base_off ->
    {ex_grid, ex_mask, nex, end_off}."""
    B, M = stream.shape
    emax = emax or L
    e4 = _round4(emax)
    base_off = base_off.to(torch.int64)
    nex = wrap_i32(read_u32le(stream, base_off))
    many = nex > 1
    off = base_off + 4
    pos_len = wrap_i32(read_u32le(stream, off))
    pos_blob = rowwise_shift_left(stream, off + 4, 4 + 5 * e4)
    pos_delta = wrap_i32(svb32_decode_batch(pos_blob, nex, e4)[:, :emax])
    ex_pos_many = torch.cumsum(pos_delta + 1, dim=1) - 1
    off_after_pos = torch.where(many, off + 4 + pos_len, off)
    val_len = wrap_i32(read_u32le(stream, off_after_pos))
    if val_svb:
        e8 = _round8(emax)
        val_blob = rowwise_shift_left(stream, off_after_pos + 4,
                                      e8 // 8 + 2 * e8)
        ex_val_many = svb16_decode_batch(
            val_blob, nex, e8, zd=False)[:, :emax].to(
            torch.int64) & 0xFFFF
    else:
        val_b_off = off_after_pos + 4
        val_bits = stream.gather(1, val_b_off.clamp(0, M - 1)[:, None])[:, 0]
        ex_val_many = unpack_fields_msb(stream, val_b_off + 1, val_bits, nex,
                                        emax)
    pos1 = wrap_i32(read_u32le(stream, off))
    val1 = read_u16le(stream, off + 4)
    ex_pos = torch.where(many[:, None], ex_pos_many, pos1[:, None])
    ex_val = torch.where(many[:, None], ex_val_many, val1[:, None])
    end_off = torch.where(many, off_after_pos + 4 + val_len,
                          torch.where(nex == 1, off + 6, off))
    ex_grid, ex_mask = _place(ex_val + 256, ex_pos, nex, L)
    return {"ex_grid": ex_grid, "ex_mask": ex_mask, "nex": nex,
            "end_off": end_off}


# ---------------------------------------------------------------------------
# *_zd pipelines: [zd0:u16][container over zd[1:]]
# ---------------------------------------------------------------------------


def _exblock_parts(kind: str, v, n, emax: int):
    """(exception-block segs, block width, residual bytes [B, L] u8,
    residual lengths) of a container other than vb1e2."""
    if kind == "vbbe21":
        p = vbbe21_parts_batch(v, n, emax)
        return (p["exsegs"], 4 + 4 + 4 * emax + 4 + 2 * emax + 16, p["data"],
                p["data_len"])
    p = _ex_parts(v, n, emax)
    if kind == "vbe21":
        nex = p["nex"]
        segs = [
            (u32le_bytes(nex), _four(nex.shape[0], nex.device)),
            (_u32_grid_bytes(p["ex_pos"]), 4 * nex),
            (_u16_grid_bytes(p["ex_val"]), 2 * nex),
        ]
        width = 4 + 6 * emax
    elif kind in ("vbsbe21", "vbsse21"):
        segs, width = _svb_exblock_parts(p, emax, kind == "vbsse21")
    else:
        raise KeyError(kind)
    return segs, width, p["data"], p["data_len"]


def _encoder_segs(kind: str, v, n, emax: int):
    """(segs, width) of the container payload, so that callers prepend
    their own header segments and pay for one concatenation in all."""
    if kind == "vb1e2":
        return _vb1e2_segs(v, n, emax)
    segs, width, data, data_len = _exblock_parts(kind, v, n, emax)
    return segs + [(data, data_len)], width + v.shape[1]


def press_vb_zd_batch(sig, n, kind: str, emax: int = None):
    """Batched <kind>_zd encode of [B, L] int16 (first n valid) ->
    (stream [B, M] u8, len [B]).  The zd0 header joins the container's
    own segments, so the stream packs in one concatenation.  Rows with
    more than emax exceptions give invalid streams (the nex field at
    byte 2 is exact either way)."""
    B, L = sig.shape
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    segs, width = _encoder_segs(kind, rest, n - 1, emax or L)
    two = torch.full((B,), 2, dtype=torch.int64, device=sig.device)
    return rowwise_concat([(u16le_bytes(zd0), two)] + segs, 2 + width)


def parse_exblock_batch(kind: str, stream, base_off, n, L: int,
                        emax: int = None):
    """Parse the exception block of a container other than vb1e2 at
    base_off -> {ex_grid, ex_mask, nex, end_off}."""
    if kind == "vbe21":
        return vbe21_parse_batch(stream, base_off, n, L, emax)
    if kind == "vbbe21":
        return vbbe21_parse_batch(stream, base_off, n, L, emax)
    if kind in ("vbsbe21", "vbsse21"):
        return vbs_parse_batch(stream, base_off, n, L, kind == "vbsse21",
                               emax)
    raise KeyError(kind)


def depress_vb_zd_batch(stream, n, kind: str, L: int, emax: int = None):
    """Batched <kind>_zd decode -> [B, L] int16 (zero past n)."""
    B = stream.shape[0]
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    zd0 = read_u16le(stream, zero)
    base = zero + 2
    if kind == "vb1e2":
        vals = vb1e2_decode_batch(stream, base, n - 1, L, emax)
    else:
        parsed = parse_exblock_batch(kind, stream, base, n - 1, L, emax)
        data = rowwise_shift_left(stream, parsed["end_off"], L)
        vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    return _zd_merge(zd0, vals, n, L)


def press_svb_zd_batch(sig, n, variant: str = "1234"):
    """svb_zd ("1234") / svb0124_zd ("0124"): svb32 of the zigzag-delta
    -> (stream [B, L/4 + 4L] u8, len [B] int32)."""
    return svb32_encode_batch(zigdelta(sig), n, variant)


def depress_svb_zd_batch(stream, n, L: int, variant: str = "1234"):
    """Inverse of press_svb_zd_batch -> [B, L] int16 (zero past n)."""
    live = torch.arange(L, device=stream.device)[None, :] < n.to(
        torch.int64)[:, None]
    v = svb32_decode_batch(stream, n, L, variant)
    return torch.where(live, unzigdelta(torch.where(live, v, 0)), 0).to(
        torch.int16)


# ---------------------------------------------------------------------------
# raw containers: the samples themselves as uint16, no zd0 header
# ---------------------------------------------------------------------------


def as_i16(v):
    """uint16-valued ints -> int16 (wrap)."""
    v = v.to(torch.int64) & 0xFFFF
    return (v - ((v & 0x8000) << 1)).to(torch.int16)


def vb_parts(sig, n, kind: str, emax: int):
    """[<kind> block] over the raw samples as uint16: (segs, width,
    residual bytes [B, L] u8, residual lengths)."""
    return _exblock_parts(kind, sig.to(torch.int64) & 0xFFFF,
                          n.to(torch.int64), emax)


def vb_parse(stream, n, kind: str, L: int, emax: int, base):
    """Parse the raw <kind> block at base -> {parsed, off (where the
    residual bytes start), count}."""
    n = n.to(torch.int64)
    parsed = parse_exblock_batch(kind, stream, base, n, L, emax)
    return {"parsed": parsed, "off": parsed["end_off"],
            "count": (n - parsed["nex"]).clamp(0, L)}


def vb_fill(p, data, n, L: int):
    """A parsed raw block and its residual bytes -> [B, L] int16."""
    return as_i16(vbbe21_fill_batch(p["parsed"], data, n.to(torch.int64),
                                    L))


def press_vb_batch(sig, n, kind: str, emax: int = None):
    """Batched <kind> (vb1e2, vbe21, vbbe21, vbsbe21, vbsse21) over the
    raw samples of [B, L] int16 (first n valid) -> (stream [B, M] u8,
    len [B]).  Rows with more than emax exceptions give invalid streams
    (the nex field at byte 0 is exact either way)."""
    return rowwise_concat(*_encoder_segs(kind, sig.to(torch.int64) & 0xFFFF,
                                         n.to(torch.int64),
                                         emax or sig.shape[1]))


def depress_vb_batch(stream, n, kind: str, L: int, emax: int = None):
    """Inverse of press_vb_batch -> [B, L] int16 (zero past n)."""
    zero = torch.zeros((stream.shape[0],), dtype=torch.int64,
                       device=stream.device)
    if kind == "vb1e2":
        return as_i16(vb1e2_decode_batch(stream, zero, n, L, emax))
    p = vb_parse(stream, n, kind, L, emax, zero)
    return vb_fill(p, rowwise_shift_left(stream, p["off"], L), n, L)


def press_svb_batch(sig, n, variant: str = "1234"):
    """svb ("1234") / svb0124 ("0124"): svb32 of the samples as uint16
    -> (stream [B, L/4 + 4L] u8, len [B] int32)."""
    return svb32_encode_batch(sig.to(torch.int64) & 0xFFFF, n, variant)


def depress_svb_batch(stream, n, L: int, variant: str = "1234"):
    """Inverse of press_svb_batch -> [B, L] int16 (zero past n)."""
    return as_i16(svb32_decode_batch(stream, n, L, variant))
