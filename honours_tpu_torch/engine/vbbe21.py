"""Batched vbbe21 exception container (press/press.c:2780-2888 framing).

Values above 255 are exceptions: their positions (delta-coded) and
values minus 256 are bit-packed with the uint_press minbits framing, and
the remaining low bytes form the residual data stream that the entropy
stage codes.  Streams are byte-exact with the reference's vbbe21.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import (
    monotone_place,
    pack_fields_msb,
    read_u16le,
    read_u32le,
    u16le_bytes,
    u32le_bytes,
    unpack_fields_msb,
)
from honours_tpu_torch.engine.permute import (
    M32,
    compaction_shifts,
    i32_to_u32,
    monotone_compact,
    monotone_expand,
    u32_to_i32,
)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values -> their int32 reading, held in int64."""
    return u32_to_i32(x).to(torch.int64)


def bitlen(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2(x+1)) elementwise for uint32 x (uint_get_minbits,
    press/press.c:461)."""
    x = x.to(torch.int64) & M32
    b = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for k in range(32):
        b = b + (x >= (1 << k)).to(torch.int64)
    return b


def _uint_pack(values, count, nbytes_cap: int):
    """uint_press framing: [minbits:1B][MSB-first packed fields].

    values [B, E] uint32 (positions past count ignored), count [B].
    Returns (buf [B, 1 + nbytes_cap] u8, len [B])."""
    B, E = values.shape
    pos = torch.arange(E, device=values.device)[None, :]
    valid = pos < count[:, None]
    v = torch.where(valid, values, 0)
    b = bitlen(v.max(dim=1).values)[:, None]
    packed = pack_fields_msb(v, b, pos * b, valid, (nbytes_cap + 3) // 4)
    buf = torch.cat([b.to(torch.uint8), packed[:, :nbytes_cap]], dim=1)
    nbits = count * b[:, 0]
    return buf, 1 + (nbits + 7) // 8


def vbbe21_parts_batch(v, n, emax: int = None):
    """Split [B, L] uint16-valued ints (first n valid) into vbbe21 parts.

    Returns dict(exsegs, data, data_len, nex): the exception-block
    concat segments, the residual bytes [B, L] u8 (first data_len
    valid), and the exception counts.  `emax` caps the exception
    buffers; rows with nex > emax give invalid streams (callers check
    nex)."""
    B, L = v.shape
    emax = emax or L
    dev = v.device
    v = v.to(torch.int64)
    n = n.to(torch.int64)
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < n[:, None]
    ex = (v > 255) & valid
    nex = ex.sum(dim=1)

    if L <= (1 << 16):
        # position (16 bits) and value - 256 (16 bits) ride one compaction
        comb = torch.where(ex, pos | ((v - 256) << 16), 0)
        comb_full, _ = monotone_compact(u32_to_i32(comb), ex)
        cf = i32_to_u32(comb_full[:, :emax])
        ex_pos, ex_val = cf & 0xFFFF, (cf >> 16) & 0xFFFF
    else:
        ex_pos, _ = monotone_compact(
            pos.expand(B, L).to(torch.int32), ex)
        ex_val, _ = monotone_compact(
            torch.where(ex, v - 256, 0).to(torch.int32), ex)
        ex_pos = ex_pos[:, :emax].to(torch.int64)
        ex_val = ex_val[:, :emax].to(torch.int64)
    # delta_increasing: out[0] = pos[0], out[i] = pos[i] - pos[i-1] - 1
    prev = torch.nn.functional.pad(ex_pos[:, :-1], (1, 0), value=-1)
    pos_delta = (ex_pos - prev - 1) & M32

    pos_buf, pos_len = _uint_pack(pos_delta, nex, 4 * emax)
    val_buf, val_len = _uint_pack(ex_val, nex, 2 * emax)

    plain = valid & ~ex
    data, _ = monotone_compact(
        torch.where(plain, v & 0xFF, 0).to(torch.uint8), plain)

    many = nex > 1
    one = nex == 1
    four = torch.full((B,), 4, dtype=torch.int64, device=dev)
    raw1 = torch.cat([u32le_bytes(ex_pos[:, 0]), u16le_bytes(ex_val[:, 0])],
                     dim=1)
    exsegs = [
        (u32le_bytes(nex), four),
        (u32le_bytes(pos_len), torch.where(many, 4, 0)),
        (pos_buf, torch.where(many, pos_len, 0)),
        (u32le_bytes(val_len), torch.where(many, 4, 0)),
        (val_buf, torch.where(many, val_len, 0)),
        (raw1, torch.where(one, 6, 0)),
    ]
    return {"exsegs": exsegs, "data": data, "data_len": n - nex, "nex": nex}


def vbbe21_parse_batch(stream, base_off, n, L: int, emax: int = None):
    """Parse the vbbe21 exception block at `base_off` of each row.

    Returns dict(ex_grid, ex_mask, nex, end_off): the exception values
    placed on the [B, L] grid, the block end offset (where the entropy
    body starts), and the exception counts.  Rows with nex > emax decode
    incorrectly; callers that cap must check nex."""
    B, M = stream.shape
    emax = emax or L
    dev = stream.device
    base_off = base_off.to(torch.int64)
    nex = wrap_i32(read_u32le(stream, base_off))
    many = nex > 1
    one = nex == 1
    off = base_off + 4

    def byte_at(o):
        return stream.gather(1, o.clamp(0, M - 1)[:, None])[:, 0].to(
            torch.int64)

    pos_len = wrap_i32(read_u32le(stream, off))
    pos_b_off = off + 4
    pos_delta = unpack_fields_msb(stream, pos_b_off + 1, byte_at(pos_b_off),
                                  nex, emax)
    ex_pos_many = torch.cumsum(pos_delta + 1, dim=1) - 1

    off_after_pos = torch.where(many, off + 4 + pos_len, off)
    val_len = wrap_i32(read_u32le(stream, off_after_pos))
    val_b_off = off_after_pos + 4
    ex_val_many = unpack_fields_msb(stream, val_b_off + 1,
                                    byte_at(val_b_off), nex, emax)

    # nex == 1 raw framing
    pos1 = wrap_i32(read_u32le(stream, off))
    val1 = read_u16le(stream, off + 4)

    ex_pos = torch.where(many[:, None], ex_pos_many, pos1[:, None])
    ex_val = torch.where(many[:, None], ex_val_many, val1[:, None])
    end_off = torch.where(many, off_after_pos + 4 + val_len,
                          torch.where(one, off + 6, off))

    eidx = torch.arange(emax, device=dev)[None, :]
    ex_valid = eidx < nex[:, None]
    tgt = torch.where(ex_valid, ex_pos.clamp(0, L - 1), 0)
    ex_grid, ex_mask = monotone_place(
        (ex_val + 256).to(torch.int32), ex_valid, tgt.to(torch.int32), L)
    return {"ex_grid": ex_grid, "ex_mask": ex_mask, "nex": nex,
            "end_off": end_off}


def vbbe21_fill_batch(parsed, data, n, L: int):
    """Merge entropy-decoded residual bytes `data` [B, >=L] u8 (first
    n - nex valid) with a parsed exception block -> values [B, L] int32."""
    ex_grid, ex_mask = parsed["ex_grid"], parsed["ex_mask"]
    idx = torch.arange(L, device=data.device)[None, :]
    valid = idx < n.to(torch.int64)[:, None]
    # data bytes go to the non-exception positions, in order: the
    # expansion shift of each is the number of exceptions before it
    shift, cnt = compaction_shifts((~ex_mask) & valid)
    validc = idx < cnt[:, None]
    data_grid, _ = monotone_expand(
        data[:, :L].contiguous(), torch.where(validc, shift, 0), validc, L)
    v = torch.where(ex_mask, ex_grid, data_grid.to(torch.int32))
    return torch.where(valid, v, 0)
