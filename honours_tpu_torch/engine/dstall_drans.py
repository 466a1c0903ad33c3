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

With a process group (`group`, shard/mesh.py) the batch is the rows of
all its ranks: each drans encode and decode reduces its fit over the
group, and the host decisions (is any row split, did the pick leave
some row split, did it change the membership, is some row past the
bound) are taken over the group, so that every rank runs the same
encodes, and so issues the same collectives, a rank with no split row
too.  The per-row pick stays each rank's own.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import read_u32le
from honours_tpu_torch.engine.drans import (
    cat_rows,
    depress_drans_batch,
    press_drans_batch,
    row_slices,
)
from honours_tpu_torch.engine.dstall import (
    _assemble_split,
    _interleave,
    _split_batch,
    _split_fields,
    branch_signals,
)
from honours_tpu_torch.engine.permute import rowwise_shift_left
from honours_tpu_torch.shard.mesh import all_reduce, any_across


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


def _by_rows(fn, parts, *tensors):
    """fn over the row slices `parts` of `tensors`, its outputs side by
    side."""
    return cat_rows([fn(*(t[s] for t in tensors)) for s in parts])


def press_dstall_drans_batch(sig, n, tabs, emax: int = None, group=None,
                             rows: int = None):
    """Batched dstall_drans encode of [B, L] int16 (first n valid) ->
    (stream [B, M] u8, len [B]); `tabs` from
    pipeline.canned_o1_device_tables.  Rows with more than emax
    exceptions in a branch give invalid streams and stay out of the
    branch's fit and G; raises RuntimeError where any other row would
    emit more than the assembly's bound (on every rank of `group`, a
    process group whose ranks' rows form the batch).  `rows` codes the
    batch in slices of that many rows: the segmentation, the branch
    signals and the assembly run a slice at a time, each drans encode
    in its two passes over the slices (engine/drans.py), and every
    decision is taken over all of them."""
    B, L = sig.shape
    emax = emax or L
    parts = row_slices(B, rows)
    ok, start, length = _by_rows(_split_batch, parts, sig, n)
    st_p, sl_p = press_drans_batch(sig, n, tabs, emax, group=group,
                                   rows=rows)
    use = torch.zeros_like(ok)
    if any_across([ok.any()], group)[0]:
        stall_sig, n_stall, ns_sig, n_ns = _by_rows(
            branch_signals, parts, sig, n, start, length)
        n_stall, n_ns = n_stall.clamp(min=1), n_ns.clamp(min=1)
        st_s, sl_s = press_drans_batch(stall_sig, n_stall, tabs, emax,
                                       member=ok, group=group, rows=rows)
        st_n, sl_n = press_drans_batch(ns_sig, n_ns, tabs, emax, member=ok,
                                       group=group, rows=rows)
        use = ok & (13 + sl_s + sl_n < 5 + sl_p)
        any_use, changed = any_across([use.any(), (use != ok).any()], group)
        if any_use and changed:
            st_s, sl_s = press_drans_batch(stall_sig, n_stall, tabs, emax,
                                           member=use, group=group,
                                           rows=rows)
            st_n, sl_n = press_drans_batch(ns_sig, n_ns, tabs, emax,
                                           member=use, group=group,
                                           rows=rows)
        if any_use:
            st_p, sl_p = press_drans_batch(sig, n, tabs, emax, member=~use,
                                           group=group, rows=rows)
    else:
        st_s = st_n = torch.zeros((B, 16), dtype=torch.uint8,
                                  device=sig.device)
        sl_s = sl_n = torch.zeros_like(sl_p)
    total = _bound(L, max(st_n.shape[1], st_p.shape[1]))
    stream, slen = _by_rows(
        lambda *a: _assemble_split(*a, total), parts, use,
        torch.where(use, start, 0), torch.where(use, length, 0), st_s, sl_s,
        st_n, sl_n, st_p, sl_p)
    # each drans blob carries its exact exception count at byte 4
    four = torch.full((B,), 4, dtype=torch.int64, device=sig.device)
    capped = torch.where(
        use, (read_u32le(st_s, four) <= emax) & (read_u32le(st_n, four) <= emax),
        read_u32le(st_p, four) <= emax)
    # the verdict, and the bound with its negation: equal on every rank
    # (the widths depend on L and emax only) when both come back as sent
    verdict = torch.tensor([0, total, -total], device=sig.device)
    verdict[0] = (capped & (slen > total)).any()
    over, most, least = all_reduce(verdict, group, "max").tolist()
    if (most, -least) != (total, total):
        raise RuntimeError(f"dstall_drans: the assembly's bound differs "
                           f"across the group ({-least} .. {most})")
    if over:
        raise RuntimeError(
            f"dstall_drans: a row emits more than the assembly's bound of "
            f"{total} bytes")
    return stream, slen


def depress_dstall_drans_batch(stream, n, tabs, L: int, emax: int = None,
                               group=None, rows: int = None):
    """Batched dstall_drans decode -> [B, L] int16 (zero past n).  Must
    receive the encoder's batch grouping (with `group`, the rows of all
    its ranks); raises ValueError when a branch blob's G header
    disagrees with its group.  `rows` decodes in slices of that many
    rows, each member-masked drans decode in its two passes."""
    M = stream.shape[1]
    emax = emax or L
    n = n.to(torch.int64)
    parts = row_slices(stream.shape[0], rows)
    use, start, length, _, ns_off = _split_fields(stream)

    def shifted(by):
        return _by_rows(lambda st, k: rowwise_shift_left(st, k, M), parts,
                        stream, by)

    d_plain = depress_drans_batch(shifted(torch.full_like(n, 5)), n, tabs, L,
                                  emax=emax, member=~use, group=group,
                                  rows=rows)
    d_stall = depress_drans_batch(shifted(torch.full_like(n, 9)),
                                  length.clamp(min=1), tabs, L, emax=emax,
                                  member=use, group=group, rows=rows)
    d_ns = depress_drans_batch(shifted(ns_off), (n - length).clamp(min=1),
                               tabs, L, emax=emax, member=use, group=group,
                               rows=rows)

    def merge(d_stall, d_ns, d_plain, n, start, length, use):
        split = _interleave(d_stall, d_ns, n, start, length, L)
        out = torch.where(use[:, None], split, d_plain.to(torch.int32))
        pos = torch.arange(L, device=stream.device)[None, :]
        return torch.where(pos < n[:, None], out, 0).to(torch.int16)

    return _by_rows(merge, parts, d_stall, d_ns, d_plain, n, start, length,
                    use)
