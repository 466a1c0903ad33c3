"""Row-wise data movement for the batched engines.

Every move in the codec engines is a monotone permutation of each row
(offsets produced by a running count), so they all reduce to kernel 1
(permute_cuda.py): a compaction (kept elements packed left) or an
expansion (element j lands at j + shift[j], shift non-decreasing).

  monotone_compact(values, keep)          — pack kept elements left
  compaction_shifts(keep)                 — holes before each kept one
  monotone_expand(values, shift, valid)   — element j lands at j + shift[j]
  rowwise_shift_left(buf, shift, width)   — whole-row shift by a row scalar
  rowwise_shift_right(buf, shift, width)  — the same, to the right
  rowwise_concat(segments, total)         — ragged row concatenation
  forward_fill / seg_or_scan              — run fills and segmented ORs

Payloads are uint8 or int32; uint32 words travel as int32 bit patterns
(u32_to_i32 / i32_to_u32).
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine import permute_cuda

M32 = 0xFFFFFFFF


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    x = x.to(torch.int64) & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> uint32 values held in int64."""
    return x.to(torch.int64) & M32


def _nbits(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def monotone_compact(values, keep):
    """Pack kept elements to the left of each row, preserving order.

    values [B, N] uint8/int32, keep [B, N] bool.  Returns (out [B, N],
    count [B] int32): out[b, :count[b]] are the kept values, the rest 0.
    """
    return permute_cuda.compact(values.contiguous(), keep.contiguous())


def compaction_shifts(keep):
    """Expansion shifts of the kept elements: out[i] = (position of the
    i-th kept element) - i, packed left.  Feeding (shifts, count) to
    monotone_expand inverts the compaction."""
    return permute_cuda.compaction_shifts(keep.contiguous())


def monotone_expand(values, shift, valid, width: int):
    """Element j of each row lands at column j + shift[j] (targets
    strictly increasing over valid elements).  Returns (out [B, width],
    covered [B, width] bool)."""
    if width < values.shape[1]:
        raise ValueError("width must be >= N")
    return permute_cuda.expand(
        values.contiguous(), shift.to(torch.int32).contiguous(),
        valid.contiguous(), width,
    )


def forward_fill(values, alive):
    """Replace dead positions with the nearest alive value to their left;
    positions before the first alive value keep their own value."""
    B, N = values.shape
    cols = torch.arange(N, device=values.device).expand(B, N)
    src = torch.cummax(torch.where(alive, cols, -1), dim=1).values
    filled = torch.gather(values, 1, src.clamp(min=0))
    return torch.where(src >= 0, filled, values)


def seg_or_scan(values, seg_id):
    """Inclusive OR-scan within runs of equal seg_id (non-decreasing):
    the last element of each run holds the OR of the whole run."""
    B, N = values.shape
    a = values
    for k in range(_nbits(N)):
        bit = 1 << k
        src_a = torch.nn.functional.pad(a[:, :-bit], (bit, 0))
        src_t = torch.nn.functional.pad(seg_id[:, :-bit], (bit, 0), value=-1)
        a = torch.where(src_t == seg_id, a | src_a, a)
    return a


def rowwise_shift_left(buf, shift, width: int):
    """Shift each row left by its own amount (zero fill); out width
    `width`.  A whole-row left shift is the compaction of the row suffix
    [shift, M)."""
    B, M = buf.shape
    cols = torch.arange(M, device=buf.device)[None, :]
    out, _ = monotone_compact(buf, cols >= shift.to(torch.int64)[:, None])
    if width > M:
        out = torch.nn.functional.pad(out, (0, width - M))
    return out[:, :width]


def rowwise_shift_right(buf, shift, width: int):
    """Shift each row right by its own amount (zero fill); out width
    `width`, elements shifted past it dropped.  A whole-row right shift
    is an expansion with a constant shift per row (elements that would
    land past `width` invalid), as honours_tpu's Pallas route computes
    it.  Callers keep 0 <= shift <= width."""
    B, M = buf.shape
    if width > M:
        buf = torch.nn.functional.pad(buf, (0, width - M))
    buf = buf[:, :width]
    cols = torch.arange(width, device=buf.device)[None, :]
    shift = shift.to(torch.int64)[:, None]
    valid = cols < width - shift
    sh = torch.where(valid, shift, 0).expand(B, width)
    out, _ = monotone_expand(buf, sh, valid, width)
    return out


def rowwise_concat(segments, total_cols: int):
    """Concatenate variable-length row segments.

    segments: list of (buf [B, Mi] u8, len [B]) — dense prefixes — or
    (buf [B, Mi], keep [B, Mi] bool) — sparse segments whose kept bytes
    may sit anywhere (an entropy coder's candidate plane).  Returns
    (out [B, total_cols] u8, total_len [B] int64).  Concatenation is one
    compaction of the side-by-side stack."""
    B = segments[0][0].shape[0]
    dev = segments[0][0].device
    bufs, keeps = [], []
    total_len = torch.zeros((B,), dtype=torch.int64, device=dev)
    for buf, sel in segments:
        sel = torch.as_tensor(sel, device=dev)
        if sel.dim() == 2:
            keep = sel
            total_len = total_len + keep.sum(dim=1)
        else:
            ln = sel.to(torch.int64).expand(B)
            cols = torch.arange(buf.shape[1], device=dev)[None, :]
            keep = cols < ln[:, None]
            total_len = total_len + ln
        bufs.append(torch.where(keep, buf, 0).to(torch.uint8))
        keeps.append(keep)
    out, _ = monotone_compact(torch.cat(bufs, dim=1), torch.cat(keeps, dim=1))
    W = out.shape[1]
    if W < total_cols:
        out = torch.nn.functional.pad(out, (0, total_cols - W))
    return out[:, :total_cols], total_len
