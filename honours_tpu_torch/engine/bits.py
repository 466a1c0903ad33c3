"""Batched byte and bit-field building blocks.

Two bit orders exist in the formats:
- MSB-first (the uintx bitpack framing): stream bit p lives in byte p>>3
  at in-byte position 7-(p&7);
- LSB-first (rice streams): stream bit p lives in byte p>>3 at position
  p&7.
uint32 quantities are held in int64.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.permute import (
    M32,
    forward_fill,
    i32_to_u32,
    monotone_compact,
    monotone_expand,
    rowwise_concat,
    rowwise_shift_left,
    seg_or_scan,
    u32_to_i32,
)

__all__ = [
    "monotone_place", "pack_fields_msb", "pack_fields_lsb",
    "unpack_fields_msb",
    "rowwise_concat", "u32le_bytes", "u16le_bytes", "read_u32le",
    "read_u16le", "read_u32be", "bytes_at",
]


def _le_bytes(x, nbytes: int):
    x = torch.as_tensor(x).to(torch.int64)[:, None] & M32
    shifts = torch.arange(0, 8 * nbytes, 8, device=x.device)[None, :]
    return ((x >> shifts) & 0xFF).to(torch.uint8)


def u32le_bytes(x):
    """[B] int -> [B, 4] u8 little-endian (uint32 wrap)."""
    return _le_bytes(x, 4)


def u16le_bytes(x):
    """[B] int -> [B, 2] u8 little-endian."""
    return _le_bytes(x, 2)


def _read_le(stream, off, nbytes: int, big: bool = False):
    M = stream.shape[1]
    idx = off.to(torch.int64)[:, None] + torch.arange(
        nbytes, device=stream.device)[None, :]
    b = torch.gather(stream, 1, idx.clamp(0, M - 1)).to(torch.int64)
    shifts = torch.arange(0, 8 * nbytes, 8, device=stream.device)[None, :]
    return (b << (shifts.flip(1) if big else shifts)).sum(dim=1)


def bytes_at(stream, p):
    """stream [B, M] u8, p [B, ...] byte offsets of each row -> the bytes
    there as int64, 0 outside the row (a cut stream reads as zeros)."""
    B, M = stream.shape
    q = p.to(torch.int64).reshape(B, -1)
    ok = (q >= 0) & (q < M)
    if M == 0:
        return torch.zeros_like(q).reshape(p.shape)
    got = stream.gather(1, torch.where(ok, q, 0)).to(torch.int64)
    return torch.where(ok, got, 0).reshape(p.shape)


def read_u32le(stream, off):
    """stream [B, M] u8, off [B] -> [B] uint32 value (int64); reads past
    either end of the row are clamped to it."""
    return _read_le(stream, off, 4)


def read_u16le(stream, off):
    return _read_le(stream, off, 2)


def read_u32be(stream, off):
    """As read_u32le, big-endian."""
    return _read_le(stream, off, 4, big=True)


def _words_to_bytes(words, shifts):
    B, W = words.shape
    shifts = torch.tensor(shifts, device=words.device)
    return ((words[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(
        B, 4 * W)


def _words_to_bytes_be(words):
    """[B, W] uint32 (int64) -> [B, 4W] u8, big-endian per word."""
    return _words_to_bytes(words, [24, 16, 8, 0])


def _words_to_bytes_le(words):
    """[B, W] uint32 (int64) -> [B, 4W] u8, little-endian per word."""
    return _words_to_bytes(words, [0, 8, 16, 24])


def monotone_place(values, keep, targets, width: int):
    """Relocate kept elements to strictly-increasing target columns:
    compact (pack kept left), then expand (rank r -> target[r]).
    values/targets int32 [B, N].  Returns (out [B, width], covered)."""
    B, N = values.shape
    vc, count = monotone_compact(values, keep)
    tc, _ = monotone_compact(torch.where(keep, targets, 0).to(torch.int32),
                             keep)
    if N > width:  # targets < width bound the kept count by width
        vc, tc = vc[:, :width], tc[:, :width]
        N = width
    rank = torch.arange(N, device=values.device)[None, :]
    valid = rank < count[:, None]
    shift = torch.where(valid, tc - rank, 0)
    return monotone_expand(vc, shift, valid, width)


def _place_words(w0, w1, word, valid, n_words: int):
    """OR each field's two word parts (w0 into its start word, w1 into
    the next) over every field of the row -> words [B, n_words] uint32
    (int64): a segmented OR scan, then the last field of each start word
    places the ORs."""
    w0 = torch.where(valid, w0, 0)
    w1 = torch.where(valid, w1, 0)
    seg = torch.where(valid, word, n_words + 7)
    or0 = seg_or_scan(w0, seg)
    or1 = seg_or_scan(w1, seg)
    nxt = torch.nn.functional.pad(seg[:, 1:], (0, 1), value=-1)
    last = valid & (seg != nxt)
    seg32 = seg.to(torch.int32)
    placed0, _ = monotone_place(u32_to_i32(or0), last, seg32, n_words + 1)
    placed1, _ = monotone_place(u32_to_i32(or1), last, seg32 + 1, n_words + 1)
    return (i32_to_u32(placed0) | i32_to_u32(placed1))[:, :n_words]


def pack_fields_msb(values, bit_len, bit_off, valid, n_words: int):
    """Build an MSB-first bit stream of fields.

    values [B, N] uint32 (int64), bit_len [B, N] or [B, 1], bit_off
    [B, N] non-decreasing start bits, valid [B, N].  Field words are
    OR-combined per target word with a segmented scan, then placed.
    Returns bytes [B, 4 * n_words] u8."""
    B, N = values.shape
    v = values.to(torch.int64) & M32
    blen = torch.as_tensor(bit_len).to(torch.int64).expand(B, N)
    word = bit_off.to(torch.int64) >> 5
    inbit = bit_off.to(torch.int64) & 31
    sh = 32 - inbit - blen
    w0 = torch.where(sh >= 0, (v << sh.clamp(0, 31)) & M32,
                     v >> (-sh).clamp(0, 31))
    w1 = torch.where(sh >= 0, 0, (v << (32 + sh).clamp(0, 31)) & M32)
    return _words_to_bytes_be(_place_words(w0, w1, word, valid, n_words))


def pack_fields_lsb(values, bit_off, valid, n_words: int):
    """Build an LSB-first bit stream of fields (rice order): bit j of
    values[i] is stream bit bit_off[i] + j, bytes little-endian per
    32-bit word.  values [B, N] uint32 (int64), each 0 above its
    field's width, bit_off [B, N] non-decreasing, valid [B, N].  Same
    segmented-OR scheme as pack_fields_msb.  Returns bytes
    [B, 4 * n_words] u8."""
    v = values.to(torch.int64) & M32
    word = bit_off.to(torch.int64) >> 5
    s = bit_off.to(torch.int64) & 31
    w0 = (v << s) & M32
    w1 = torch.where(s == 0, 0, v >> ((32 - s) & 31))
    return _words_to_bytes_le(_place_words(w0, w1, word, valid, n_words))


def unpack_fields_msb(stream, base_byte, mb, count, N: int, mb_cap: int = 24):
    """Read `count` MSB-first fields of per-row width mb (<= mb_cap)
    starting at byte base_byte of each row.  Each field's 4-byte window
    is placed on the first field that starts in it and forward-filled
    over the fields that share its start byte.

    stream [B, M] u8; base_byte/mb/count [B].  Returns [B, N] uint32
    (int64)."""
    B, M = stream.shape
    dev = stream.device
    W = min(M, (N * mb_cap + 7) // 8 + 4)
    a = rowwise_shift_left(stream, base_byte, W + 3).to(torch.int64)
    win = (a[:, :W] << 24) | (a[:, 1:W + 1] << 16) | (a[:, 2:W + 2] << 8) \
        | a[:, 3:W + 3]
    # widths beyond 32 come only from garbage rows; clamping keeps every
    # shift below defined for them
    mb = torch.as_tensor(mb).to(torch.int64).reshape(B, 1).clamp(0, 32)
    count = torch.as_tensor(count).to(torch.int64)
    mb_safe = mb.clamp(min=1)
    nbyte = torch.arange(W, device=dev)[None, :]
    first_i = (8 * nbyte + mb_safe - 1) // mb_safe
    is_start = ((first_i * mb_safe) >> 3) == nbyte
    is_start = is_start & (first_i < count[:, None]) & (mb > 0)

    wc, cnt = monotone_compact(u32_to_i32(win), is_start)
    tc, _ = monotone_compact(torch.where(is_start, first_i, 0).to(torch.int32),
                             is_start)
    rank = torch.arange(W, device=dev)[None, :]
    validc = rank < cnt[:, None]
    placed, covered = monotone_expand(
        wc, torch.where(validc, tc - rank, 0), validc, max(N, W))
    field_win = i32_to_u32(forward_fill(placed, covered)[:, :N])

    idx = torch.arange(N, device=dev)[None, :]
    r = (idx * mb) & 7
    out = torch.where(
        mb == 0, 0,
        (field_win >> (32 - r - mb).clamp(min=0)) & ((1 << mb) - 1))
    return torch.where(idx < count[:, None], out, 0)
