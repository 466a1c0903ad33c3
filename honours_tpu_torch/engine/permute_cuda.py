"""Kernel 1: monotone row permutations (csrc/permute.cu), each beside its
plain PyTorch version.

Replaces honours_tpu/engine/permute_pallas.py `_walk` (compact_walk,
expand_walk, compaction_shifts_walk).  The wrappers route by device:
CPU tensors take the plain version, CUDA tensors launch the kernel.
Payloads are uint8 or int32 (uint32 words travel as int32 bit patterns);
masks are bool.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr

PAYLOADS = (torch.uint8, torch.int32)

_COMPACT = {
    torch.uint8: kernel("monotone_compact_u8", "permute.cu",
                        "htt_compact_u8", "ppppllp"),
    torch.int32: kernel("monotone_compact_i32", "permute.cu",
                        "htt_compact_i32", "ppppllp"),
}
_SHIFTS = kernel("compaction_shifts", "permute.cu", "htt_compaction_shifts",
                 "pppllp")
_EXPAND = {
    torch.uint8: kernel("monotone_expand_u8", "permute.cu", "htt_expand_u8",
                        "ppppplllp"),
    torch.int32: kernel("monotone_expand_i32", "permute.cu",
                        "htt_expand_i32", "ppppplllp"),
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


def compact(values, keep):
    """monotone compaction -> (out [B, N], count [B] int32)."""
    if is_cpu(values, keep):
        return compact_plain(values, keep)
    B, N = values.shape
    check(values, "values", PAYLOADS)
    check(keep, "keep", (torch.bool,), (B, N))
    out = torch.empty_like(values)
    count = torch.empty((B,), dtype=torch.int32, device=values.device)
    if B:
        _COMPACT[values.dtype](values.data_ptr(), keep.data_ptr(),
                               out.data_ptr(), count.data_ptr(), B, N,
                               stream_ptr(values.device))
    return out, count


def compaction_shifts(keep):
    """holes-before-each-kept-element, packed left -> (shifts, count)."""
    if is_cpu(keep):
        return compaction_shifts_plain(keep)
    B, N = keep.shape
    check(keep, "keep", (torch.bool,))
    out = torch.empty((B, N), dtype=torch.int32, device=keep.device)
    count = torch.empty((B,), dtype=torch.int32, device=keep.device)
    if B:
        _SHIFTS(keep.data_ptr(), out.data_ptr(), count.data_ptr(), B, N,
                stream_ptr(keep.device))
    return out, count


def expand(values, shift, valid, width: int):
    """monotone expansion -> (out [B, width], covered [B, width] bool)."""
    if is_cpu(values, shift, valid):
        return expand_plain(values, shift, valid, width)
    B, N = values.shape
    check(values, "values", PAYLOADS)
    check(shift, "shift", (torch.int32,), (B, N))
    check(valid, "valid", (torch.bool,), (B, N))
    out = torch.empty((B, width), dtype=values.dtype, device=values.device)
    covered = torch.empty((B, width), dtype=torch.bool, device=values.device)
    if B:
        _EXPAND[values.dtype](values.data_ptr(), shift.data_ptr(),
                              valid.data_ptr(), out.data_ptr(),
                              covered.data_ptr(), B, N, width,
                              stream_ptr(values.device))
    return out, covered
