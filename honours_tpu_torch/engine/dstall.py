"""Batched dstall_srans2: the stall-aware srans2 codec.

The counterpart of honours_tpu/engine/dstall.py.  Per batch: one
segmentation (kernel A), the stall and nonstall regions moved out as
monotone data movements (kernel 1), three batched srans2 encodes (stall
branch, nonstall branch, whole read) and a per-row min-pick, as the
reference's dstall (press/press.c:8003-8019) encodes both ways and keeps
the smaller.  Decode runs both branch decodes and puts the stall back in
place with a monotone expansion.

Stream (honours_tpu/codecs/dstall.py):
  [0][plain_len:u32][srans2 blob]                             no split
  [1][start:u16][length:u16][stall_len:u32][stall srans2 blob]
     [ns_len:u32][nonstall srans2 blob]                       split
The split is the segmenter's first stall with stall_margin samples (20)
trimmed from each end, kept when it is at least stall_threshold samples
(140) before the trim and its start and length fit in uint16; both are
read from utils/config.py, so HTPU_STALL_MARGIN and HTPU_STALL_THRESHOLD
move the split as they move the JAX package's.  Streams equal the host
codec's (DstallSrans2Codec) for every read of n >= 1 whose stall starts
before sample 65536 (ROADMAP.md, watch list).
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
from honours_tpu_torch.engine.permute import (
    monotone_compact,
    monotone_expand,
    rowwise_shift_left,
    rowwise_shift_right,
)
from honours_tpu_torch.engine.pipeline import (
    depress_srans2_batch,
    press_srans2_batch,
)
from honours_tpu_torch.segment import find_stall_batch
from honours_tpu_torch.utils.config import get_config


def _split_batch(sig, n):
    """(ok [B] bool, start [B], length [B] int64) of the split of each
    row, start and length 0 where there is none.  Threshold and margin
    are get_config()'s stall_threshold and stall_margin."""
    cfg = get_config()
    ex, start, length = find_stall_batch(sig, n)
    ok = ex & (length >= cfg.stall_threshold)
    start = start.to(torch.int64) + cfg.stall_margin
    length = length.to(torch.int64) - 2 * cfg.stall_margin
    ok = ok & (length > 0) & (start <= 0xFFFF) & (length <= 0xFFFF)
    return ok, torch.where(ok, start, 0), torch.where(ok, length, 0)


def branch_signals(sig, n, start, length):
    """(stall_sig, n_stall, ns_sig, n_ns): read[start:start + length]
    moved to column 0, and the read without it, each a Python slice of
    the read (clipped at n); a row with no split (length 0) gives an
    empty stall branch and its whole read."""
    L = sig.shape[1]
    pos = torch.arange(L, device=sig.device)[None, :]
    n = n.to(torch.int64)
    a = torch.minimum(start, n)
    e = torch.minimum(start + length, n)
    n_stall = e - a
    stall = rowwise_shift_left(sig.to(torch.int32), a, L)
    stall = torch.where(pos < n_stall[:, None], stall, 0).to(torch.int16)
    keep = (pos < n[:, None]) & ~((pos >= a[:, None]) & (pos < e[:, None]))
    ns, _ = monotone_compact(sig.to(torch.int32), keep)
    return stall, n_stall, ns.to(torch.int16), n - n_stall


def _assemble_split(use, start, length, st_s, sl_s, st_n, sl_n, st_p, sl_p,
                    total: int, len_bytes: int = 4):
    """Rows of [use][start:u16][length:u16][sl_s][stall blob] (the four
    fields and the stall blob only where use; sl_s a u32, or a u16 for
    len_bytes 2) then [tail_len:u32][tail], the tail the nonstall blob
    where use and the plain blob elsewhere -> (stream [B, total] u8, len
    [B]).  Bytes past `total` are dropped: callers give a bound on every
    emitted length."""
    B = use.shape[0]
    dev = use.device
    tail_w = max(st_n.shape[1], st_p.shape[1])
    st_n = torch.nn.functional.pad(st_n, (0, tail_w - st_n.shape[1]))
    st_p = torch.nn.functional.pad(st_p, (0, tail_w - st_p.shape[1]))
    tail_len = torch.where(use, sl_n, sl_p)
    field = u16le_bytes if len_bytes == 2 else u32le_bytes
    hdr = torch.cat([u16le_bytes(start), u16le_bytes(length), field(sl_s)],
                    dim=1)
    one = torch.ones((B,), dtype=torch.int64, device=dev)
    return rowwise_concat([
        (use.to(torch.uint8)[:, None], one),
        (hdr, torch.where(use, 4 + len_bytes, 0)),
        (st_s, torch.where(use, sl_s, 0)),
        (u32le_bytes(tail_len), 4 * one),
        (torch.where(use[:, None], st_n, st_p), tail_len),
    ], total)


def press_dstall_batch(sig, n, tabs, emax: int = None):
    """Batched dstall_srans2 encode of [B, L] int16 (first n valid) ->
    (stream [B, M] u8, len [B]); `tabs` from
    pipeline.canned_o1_device_tables.  Rows with more than emax
    exceptions in a branch give invalid streams (each branch's nex field
    is exact either way)."""
    ok, start, length = _split_batch(sig, n)
    stall_sig, n_stall, ns_sig, n_ns = branch_signals(sig, n, start, length)
    n_stall, n_ns = n_stall.clamp(min=1), n_ns.clamp(min=1)
    st_s, sl_s = press_srans2_batch(stall_sig, n_stall, tabs, emax)
    st_n, sl_n = press_srans2_batch(ns_sig, n_ns, tabs, emax)
    st_p, sl_p = press_srans2_batch(sig, n, tabs, emax)
    use = ok & (1 + 8 + sl_s + 4 + sl_n < 1 + 4 + sl_p)
    # the min-pick keeps every row's emitted length <= 5 + sl_p, and the
    # three encodes share one width
    return _assemble_split(use, start, length, st_s, sl_s, st_n, sl_n,
                           st_p, sl_p, 13 + st_s.shape[1] + 8)


def _split_fields(stream, len_bytes: int = 4):
    """(use, start, length, stall_len, ns_off) of each row's header, its
    stall_len field a u32 (or a u16 for len_bytes 2); the fields are 0
    and ns_off 5 where the flag byte is 0."""
    zero = torch.zeros((stream.shape[0],), dtype=torch.int64,
                       device=stream.device)
    use = stream[:, 0] > 0
    start = torch.where(use, read_u16le(stream, zero + 1), 0)
    length = torch.where(use, read_u16le(stream, zero + 3), 0)
    read = read_u16le if len_bytes == 2 else read_u32le
    stall_len = torch.where(use, read(stream, zero + 5), 0)
    return (use, start, length, stall_len,
            torch.where(use, 9 + len_bytes + stall_len, 5))


def _interleave(d_stall, d_ns, n, start, length, L: int):
    """The decoded read of a split row: the nonstall samples with the
    stall's put back at [start, start + length) -> [B, L] int32."""
    pos = torch.arange(L, device=d_ns.device)[None, :]
    n_ns = (n.to(torch.int64) - length).clamp(min=1)
    ns_valid = pos < n_ns[:, None]
    shift = torch.where(ns_valid & (pos >= start[:, None]), length[:, None],
                        0)
    ns_grid, _ = monotone_expand(d_ns.to(torch.int32), shift, ns_valid, L)
    stall_grid = rowwise_shift_right(d_stall.to(torch.int32), start, L)
    in_stall = (pos >= start[:, None]) & (pos < (start + length)[:, None])
    return torch.where(in_stall, stall_grid, ns_grid)


def depress_dstall_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched dstall_srans2 decode -> [B, L] int16 (zero past n)."""
    M = stream.shape[1]
    n = n.to(torch.int64)
    use, start, length, _, ns_off = _split_fields(stream)
    d_stall = depress_srans2_batch(
        rowwise_shift_left(stream, torch.full_like(n, 9), M),
        length.clamp(min=1), tabs, L, emax=emax)
    d_ns = depress_srans2_batch(rowwise_shift_left(stream, ns_off, M),
                                (n - length).clamp(min=1), tabs, L,
                                emax=emax)
    out = _interleave(d_stall, d_ns, n, start, length, L)
    pos = torch.arange(L, device=stream.device)[None, :]
    return torch.where(pos < n[:, None], out, 0).to(torch.int16)
