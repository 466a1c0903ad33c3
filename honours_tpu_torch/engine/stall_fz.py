"""Batched stall-fz codecs: rccm_svbbe21_zd ("stall-fz"), dstall_fz_1500
and dstall_fz (the reference's best ratio), over the rccm codecs.

The counterparts of honours_tpu/codecs/stall.py's host codecs.  Stream
(press/press.c:7748-8030):
  [0][ns_len:u32][rccm_vbbe21_zd of the read]                  no split
  [1][start:u16][length:u16][stall_len:u16][stall blob]
     [ns_len:u32][nonstall blob]                               split
the stall blob rccm_vbbe21_submin of read[start:start + length], the
nonstall blob rccm_vbbe21_zd of the read without it (both as Python
slices of the read, so they clip at its end).  The split is the
segmenter's first stall (kernel A, segment.find_stall_batch) with its
start and length truncated to uint16, as native.find_stall returns them
(so a stall that starts past sample 65,535 splits at the truncated
start, as the host codec does), kept when that length is at least the
threshold (get_config().stall_threshold, 140; dstall_threshold, 1500, for
dstall_fz_1500), then stall_margin (20) samples trimmed from each end.
dstall_fz codes each split read both ways and keeps the split stream
only when it is shorter (ties to the no-split stream).

Where the host codec raises struct.error (a start or length outside
uint16 after the trim, a stall blob past 65,535 bytes) these raise
ValueError.  The branches of a batch (stall, nonstall and, for
dstall_fz, the whole read of each split row) share one coder launch.
The branch signals, the stream's assembly and its header reads are
engine/dstall.py's, with the stall_len field a u16 here.
Streams equal the host codec's for every read of n >= 1, and its press
bytes for n = 0.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.dstall import (
    _assemble_split,
    _interleave,
    _split_fields,
    branch_signals,
)
from honours_tpu_torch.engine.rc import (
    assemble,
    decode_groups,
    encode_groups,
    submin_fill,
    submin_parse,
    submin_parts,
    vb_zd_fill,
    vb_zd_parse,
    vb_zd_parts,
)
from honours_tpu_torch.segment import find_stall_batch
from honours_tpu_torch.utils.config import get_config

def threshold_of(kind: str) -> int:
    """The split threshold of rccm_svbbe21_zd and dstall_fz ("stall",
    "pick") or dstall_fz_1500 ("dstall")."""
    cfg = get_config()
    return cfg.dstall_threshold if kind == "dstall" else cfg.stall_threshold


def coder_rows(kind: str) -> tuple:
    """(byte model, coder rows a bucket row) of press_stall_fz_batch's
    one coder launch: the nonstall and the stall branch, and for
    dstall_fz ("pick") the whole read too."""
    return "cm", 3 if kind == "pick" else 2


def split_batch(sig, n, threshold: int):
    """(ok [B] bool, start [B], length [B] int64): each row's split as
    codecs/stall.py _stall_press takes it, 0 where there is none.
    ValueError where a split's start or length leaves uint16."""
    cfg = get_config()
    ex, start, length = find_stall_batch(sig, n)
    start = start.to(torch.int64) & 0xFFFF  # native.find_stall's uint16
    length = length.to(torch.int64) & 0xFFFF
    ok = ex & (length >= threshold)
    start = start + cfg.stall_margin
    length = length - 2 * cfg.stall_margin
    bad = ok & ((start < 0) | (start > 0xFFFF) | (length < 0)
                | (length > 0xFFFF))
    if bool(bad.any()):
        rows = torch.nonzero(bad).flatten().tolist()
        raise ValueError(f"stall split of rows {rows[:8]} leaves uint16 "
                         "(start or length after the margin trim)")
    return ok, torch.where(ok, start, 0), torch.where(ok, length, 0)


def _scatter_rows(x, rows, B: int):
    """Rows of x placed at `rows` of a [B, ...] zero tensor."""
    out = torch.zeros((B,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_copy(0, rows, x)


def _pad_to(x, w: int):
    return F.pad(x, (0, w - x.shape[1]))


def press_stall_fz_batch(sig, n, kind: str, emax: int = None):
    """Batched rccm_svbbe21_zd / dstall_fz_1500 / dstall_fz ("stall",
    "dstall", "pick") encode of [B, L] int16 (first n valid) -> (stream
    [B, M] u8, len [B]).  Rows with more than emax exceptions in a
    branch give invalid streams (each branch blob's nex field, at its
    byte 2, is exact either way)."""
    B, L = sig.shape
    emax = emax or L
    n = n.to(torch.int64)
    ok, start, length = split_batch(sig, n, threshold_of(kind))
    stall_sig, n_stall, ns_sig, n_ns = branch_signals(sig, n, start, length)
    rows = torch.nonzero(ok).flatten()
    parts = [vb_zd_parts(ns_sig, n_ns, "vbbe21", emax)]
    if rows.numel():
        parts.append(submin_parts(stall_sig[rows], n_stall[rows], emax))
        if kind == "pick":
            parts.append(vb_zd_parts(sig[rows], n[rows], "vbbe21", emax))
    coded = encode_groups([(p[2], p[3]) for p in parts], "cm")
    (st_n, sl_n), *split = [assemble(p, c) for p, c in zip(parts, coded)]
    st_s = torch.zeros((B, 0), dtype=torch.uint8, device=sig.device)
    sl_s = torch.zeros_like(n)
    st_p, sl_p = st_n, sl_n  # each row's stream tail if it does not split
    use = ok
    if split:
        if bool((split[0][1] > 0xFFFF).any()):
            raise ValueError("stall blob past 65,535 bytes (its u16 length "
                             "field)")
        st_s, sl_s = (_scatter_rows(t, rows, B) for t in split[0])
    if len(split) == 2:  # dstall_fz: the whole read, where it is shorter
        st_w, sl_w = split[1]
        w = max(st_w.shape[1], st_n.shape[1])
        st_n = _pad_to(st_n, w)
        st_p = st_n.index_copy(0, rows, _pad_to(st_w, w))
        sl_p = sl_n.index_copy(0, rows, sl_w)
        use = ok & (1 + 6 + sl_s + 4 + sl_n < 1 + 4 + sl_p)
    return _assemble_split(use, start, length, st_s, sl_s, st_n, sl_n,
                           st_p, sl_p, 11 + st_s.shape[1] + max(
                               st_n.shape[1], st_p.shape[1]), len_bytes=2)


def depress_stall_fz_batch(stream, n, L: int, emax: int = None):
    """Batched decode of the three stall-fz codecs -> [B, L] int16 (zero
    past n)."""
    B, M = stream.shape
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    use, start, length, _, ns_base = _split_fields(stream, len_bytes=2)
    n_ns = (n - length).clamp(min=0)
    rows = torch.nonzero(use).flatten()
    pn = vb_zd_parse(stream, n_ns, "vbbe21", L, emax, ns_base)
    groups = [(stream, pn["off"], pn["count"])]
    if rows.numel():
        ps = submin_parse(stream[rows], length[rows], L, emax,
                          zero[rows] + 7)
        groups.append((stream[rows], ps["off"], ps["count"]))
    d_n, *d_s = decode_groups(groups, L, "cm")
    d_ns = vb_zd_fill(pn, d_n, n_ns, L)
    d_stall = torch.zeros_like(d_ns)
    if d_s:
        d_stall = _scatter_rows(submin_fill(ps, d_s[0], length[rows], L),
                                rows, B)
    out = _interleave(d_stall, d_ns, n, start, length, L)
    pos = torch.arange(L, device=stream.device)[None, :]
    return torch.where(pos < n[:, None], out, 0).to(torch.int16)


def stall_fz_overflowed(blob: bytes, emax: int) -> bool:
    """A stall-fz stream has a branch blob whose exception count (at its
    byte 2) exceeds emax; a split stream too short to hold its nonstall
    blob's count counts as overflowed."""
    if len(blob) < 11:
        return False
    if not blob[0]:
        return struct.unpack_from("<I", blob, 7)[0] > emax
    (stall_len,) = struct.unpack_from("<H", blob, 5)
    ns = 11 + stall_len
    if len(blob) < ns + 6:
        return True
    return (struct.unpack_from("<I", blob, 9)[0] > emax
            or struct.unpack_from("<I", blob, ns + 2)[0] > emax)
