"""Kernel 1: monotone row permutations (csrc/permute.cu), each beside its
plain PyTorch version.

Replaces honours_tpu/engine/permute_pallas.py `_walk` (compact_walk,
expand_walk, compaction_shifts_walk).  The wrappers route by device:
CPU tensors take the plain version, CUDA tensors launch the kernel.
Payloads are uint8 or int32 (uint32 words travel as int32 bit patterns);
masks are bool.  The kernels cut each row into tiles of TILE elements
(one block each; an expansion block takes up to eight short rows) and
chain the tiles of a row through a zeroed scratch of one status word per
tile plus a ticket counter, allocated here when a row has more than one
tile.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import (
    check,
    is_cpu,
    kernel,
    sm_count,
    stream_ptr,
)

PAYLOADS = (torch.uint8, torch.int32)
#: elements per tile (one block) of every kernel 1 entry and per thread
#: (permute.cu's TILE and EPT)
TILE = 4096
EPT = 16

_COMPACT = {
    torch.uint8: kernel("monotone_compact_u8", "permute.cu",
                        "htt_compact_u8", "ppppllpp"),
    torch.int32: kernel("monotone_compact_i32", "permute.cu",
                        "htt_compact_i32", "ppppllpp"),
}
_SHIFTS = kernel("compaction_shifts", "permute.cu", "htt_compaction_shifts",
                 "pppllpp")
_EXPAND = {
    torch.uint8: kernel("monotone_expand_u8", "permute.cu", "htt_expand_u8",
                        "ppppplllllpp"),
    torch.int32: kernel("monotone_expand_i32", "permute.cu",
                        "htt_expand_i32", "ppppplllllpp"),
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ranks(keep):
    k = keep.to(torch.int64)
    return torch.cumsum(k, dim=1) - k, k.sum(dim=1).to(torch.int32)


def compact_plain(values, keep):
    """Pack kept elements of each row left, in order; zero the rest.
    Returns (out [B, N], count [B] int32)."""
    rank, count = _ranks(keep)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    out = torch.zeros_like(values)
    out[rows, rank[rows, cols]] = values[rows, cols]
    return out, count


def compaction_shifts_plain(keep):
    """Holes before each kept element, packed left (the expansion shifts
    that invert the compaction).  Returns (shifts [B, N] int32, count)."""
    rank, count = _ranks(keep)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    r = rank[rows, cols]
    out = torch.zeros(keep.shape, dtype=torch.int32, device=keep.device)
    out[rows, r] = (cols - r).to(torch.int32)
    return out, count


def expand_plain(values, shift, valid, width: int):
    """out[j + shift[j]] = values[j] for valid j; targets outside
    [0, width) are dropped.  Returns (out [B, width], covered bool)."""
    B, N = values.shape
    t = torch.arange(N, device=values.device)[None, :] + shift.to(torch.int64)
    sel = valid & (t >= 0) & (t < width)
    rows, cols = torch.nonzero(sel, as_tuple=True)
    tgt = t[rows, cols]
    out = torch.zeros((B, width), dtype=values.dtype, device=values.device)
    covered = torch.zeros((B, width), dtype=torch.bool, device=values.device)
    out[rows, tgt] = values[rows, cols]
    covered[rows, tgt] = True
    return out, covered


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _status(B: int, tiles: int, device):
    """Zeroed tile states of a launch of B rows of `tiles` tiles, then its
    ticket counter; None when each row is one tile (no tile waits on
    another)."""
    if B * tiles >= 1 << 31:
        raise ValueError(f"{B} rows of {tiles} tiles: more than 2^31 tiles")
    if tiles == 1:
        return None
    return torch.zeros((B * tiles + 1,), dtype=torch.int64, device=device)


def compact_tiles(N: int) -> int:
    """Tiles of a compaction row: TILE elements each."""
    return max(1, -(-N // TILE))


def expand_tiles(N: int, width: int, rows: int, sms: int) -> tuple[int, int]:
    """(input elements per tile, tiles) of an expansion row: one tile per
    TILE elements of input, and where `rows` rows give fewer blocks than
    the card has SMs, up to one per TILE columns of output, so that a few
    rows spreading their elements over a wide output still spread their
    writes over the card.  Tiles are whole per-thread groups."""
    want = min(-(-width // TILE), -(-sms // max(rows, 1)))
    tiles = max(1, -(-N // TILE), want)
    per = -(-max(N, 1) // tiles)
    per = -(-per // EPT) * EPT
    return per, max(1, -(-N // per))


def expand_rows_per_block(per: int, tiles: int) -> int:
    """Rows an expansion block takes: 1 when a row has several tiles, else
    as many (1, 2, 4 or 8) as fit in one block with whole warps of EPT
    elements a thread each."""
    if tiles > 1:
        return 1
    warps = max(1, -(-per // (32 * EPT)))
    rpb = 1
    while rpb < 8 and 2 * rpb * warps * 32 * EPT <= TILE:
        rpb *= 2
    return rpb


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rows(t, name, dtypes):
    check(t, name, dtypes)
    if t.dim() != 2 or t.shape[1] >= 1 << 31:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not [B, N < 2^31]")


def compact(values, keep):
    """monotone compaction -> (out [B, N], count [B] int32)."""
    if is_cpu(values, keep):
        return compact_plain(values, keep)
    _check_rows(values, "values", PAYLOADS)
    B, N = values.shape
    check(keep, "keep", (torch.bool,), (B, N))
    out = torch.empty_like(values)
    count = torch.empty((B,), dtype=torch.int32, device=values.device)
    if B:
        status = _status(B, compact_tiles(N), values.device)
        _COMPACT[values.dtype](values.data_ptr(), keep.data_ptr(),
                               out.data_ptr(), count.data_ptr(), B, N,
                               _ptr(status), stream_ptr(values.device))
    return out, count


def compaction_shifts(keep):
    """holes-before-each-kept-element, packed left -> (shifts, count)."""
    if is_cpu(keep):
        return compaction_shifts_plain(keep)
    _check_rows(keep, "keep", (torch.bool,))
    B, N = keep.shape
    out = torch.empty((B, N), dtype=torch.int32, device=keep.device)
    count = torch.empty((B,), dtype=torch.int32, device=keep.device)
    if B:
        status = _status(B, compact_tiles(N), keep.device)
        _SHIFTS(keep.data_ptr(), out.data_ptr(), count.data_ptr(), B, N,
                _ptr(status), stream_ptr(keep.device))
    return out, count


def expand(values, shift, valid, width: int):
    """monotone expansion -> (out [B, width], covered [B, width] bool)."""
    if is_cpu(values, shift, valid):
        return expand_plain(values, shift, valid, width)
    _check_rows(values, "values", PAYLOADS)
    B, N = values.shape
    check(shift, "shift", (torch.int32,), (B, N))
    check(valid, "valid", (torch.bool,), (B, N))
    if not 0 <= width < 1 << 31:
        raise ValueError(f"width {width} is not in [0, 2^31)")
    out = torch.empty((B, width), dtype=values.dtype, device=values.device)
    covered = torch.empty((B, width), dtype=torch.bool, device=values.device)
    if B and width:
        per, tiles = expand_tiles(N, width, B, sm_count(values.device))
        status = _status(B, tiles, values.device)
        _EXPAND[values.dtype](values.data_ptr(), shift.data_ptr(),
                              valid.data_ptr(), out.data_ptr(),
                              covered.data_ptr(), B, N, width, per,
                              expand_rows_per_block(per, tiles),
                              _ptr(status), stream_ptr(values.device))
    return out, covered
