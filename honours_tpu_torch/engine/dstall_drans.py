"""Batched dstall_drans: the stall-aware codec with drans branches.

The counterpart of honours_tpu/engine/dstall_drans.py, in the stream
layout of dstall_srans2 (engine/dstall.py) with drans blobs.  drans fits
one table per encode group, so a size-based pick would make membership
depend on sizes that depend on the fits.  The encode cuts the knot as
the host codec (honours_tpu/codecs/dstall_drans.py) does: one
segmentation, a trial of the plain branch over all rows and of the two
split branches over the rows with a split, a per-row pick frozen from
the trial sizes, a re-encode of the split branches where membership
changed and of the plain branch over the rows that stay plain.  Two host
syncs a batch (is any row split; the pick).  Decode derives every group
from the flag bytes: three member-masked drans decodes (plain, stall,
nonstall), then the split rows' stalls are put back in place.

Streams equal the host codec's (dstall_drans_press_reads over the same
batch) for every read of n >= 1 whose stall starts before sample 65536
(ROADMAP.md, watch list).
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import read_u32le
from honours_tpu_torch.engine.drans import (
    depress_drans_batch,
    press_drans_batch,
)
from honours_tpu_torch.engine.dstall import (
    _assemble_split,
    _branch_signals,
    _interleave,
    _split_batch,
    _split_fields,
)
from honours_tpu_torch.engine.permute import rowwise_shift_left


def _bound(L: int, width: int) -> int:
    """A bound on every emitted length of a batch whose drans streams
    are `width` wide: unlike dstall_srans2's exact min-pick, the pick
    here is frozen from the trial sizes and the final encodes may
    drift, so bound affinely (honours_tpu/engine/dstall_drans.py
    _assemble): a drans stream over `len` values emits at most 2 * len
    body bytes plus the width formula's fixed part, and the two split
    branches' contents sum to n."""
    over = max(width - 2 * (L - 1), 0)
    return 13 + 2 * (L - 1) + 2 * over + 1024


def press_dstall_drans_batch(sig, n, tabs, emax: int = None):
    """Batched dstall_drans encode of [B, L] int16 (first n valid) ->
    (stream [B, M] u8, len [B]); `tabs` from
    pipeline.canned_o1_device_tables.  Rows with more than emax
    exceptions in a branch give invalid streams and stay out of the
    branch's fit and G; raises RuntimeError where any other row would
    emit more than the assembly's bound."""
    B, L = sig.shape
    emax = emax or L
    ok, start, length = _split_batch(sig, n)
    st_p, sl_p = press_drans_batch(sig, n, tabs, emax)
    okh = ok.cpu()
    use = torch.zeros_like(ok)
    if okh.any():
        stall_sig, n_stall, ns_sig, n_ns = _branch_signals(sig, n, start,
                                                           length)
        st_s, sl_s = press_drans_batch(stall_sig, n_stall, tabs, emax,
                                       member=ok)
        st_n, sl_n = press_drans_batch(ns_sig, n_ns, tabs, emax, member=ok)
        use = ok & (13 + sl_s + sl_n < 5 + sl_p)
        useh = use.cpu()
        if useh.any() and (useh != okh).any():
            st_s, sl_s = press_drans_batch(stall_sig, n_stall, tabs, emax,
                                           member=use)
            st_n, sl_n = press_drans_batch(ns_sig, n_ns, tabs, emax,
                                           member=use)
        if useh.any():
            st_p, sl_p = press_drans_batch(sig, n, tabs, emax, member=~use)
    else:
        st_s = st_n = torch.zeros((B, 16), dtype=torch.uint8,
                                  device=sig.device)
        sl_s = sl_n = torch.zeros_like(sl_p)
    total = _bound(L, max(st_n.shape[1], st_p.shape[1]))
    stream, slen = _assemble_split(
        use, torch.where(use, start, 0), torch.where(use, length, 0), st_s,
        sl_s, st_n, sl_n, st_p, sl_p, total)
    # each drans blob carries its exact exception count at byte 4
    four = torch.full((B,), 4, dtype=torch.int64, device=sig.device)
    capped = torch.where(
        use, (read_u32le(st_s, four) <= emax) & (read_u32le(st_n, four) <= emax),
        read_u32le(st_p, four) <= emax)
    if bool((capped & (slen > total)).any()):
        raise RuntimeError(
            f"dstall_drans: a row emits more than the assembly's bound of "
            f"{total} bytes")
    return stream, slen


def depress_dstall_drans_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched dstall_drans decode -> [B, L] int16 (zero past n).  Must
    receive the encoder's batch grouping; raises ValueError when a
    branch blob's G header disagrees with its group."""
    M = stream.shape[1]
    emax = emax or L
    n = n.to(torch.int64)
    use, start, length, _, ns_off = _split_fields(stream)
    d_plain = depress_drans_batch(
        rowwise_shift_left(stream, torch.full_like(n, 5), M), n, tabs, L,
        emax=emax, member=~use)
    d_stall = depress_drans_batch(
        rowwise_shift_left(stream, torch.full_like(n, 9), M),
        length.clamp(min=1), tabs, L, emax=emax, member=use)
    d_ns = depress_drans_batch(rowwise_shift_left(stream, ns_off, M),
                               (n - length).clamp(min=1), tabs, L,
                               emax=emax, member=use)
    split = _interleave(d_stall, d_ns, n, start, length, L)
    out = torch.where(use[:, None], split, d_plain.to(torch.int32))
    pos = torch.arange(L, device=stream.device)[None, :]
    return torch.where(pos < n[:, None], out, 0).to(torch.int16)
