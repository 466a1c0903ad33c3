"""Kernel A: the stall segmenter (csrc/segment.cu), beside its plain
version.

No TPU kernel stands behind it: it replaces the lax.scan of
honours_tpu/segment/__init__.py find_stall_batch and holds the C oracle
honours_tpu/native/segment.c bit for bit.  The wrapper routes by
device: CPU tensors take the plain version, CUDA tensors launch the
kernel: a block of THREADS a read, the read in tiles of TILE samples, a
chunk of CHUNK samples a thread; the two float32 sums are composed
chunk by chunk (GROUP chunks at a time where they can) from parity
tables over binades (the lower one that of GUESS x the exact sum before
the chunk); over an in-band bit mask, a scan of the chunks' maps of the
run machine's 7 control states gives each chunk's state at its start,
and each chunk records the attempt ends that can emit (csrc/segment.cu
states both invariants).
"""

from __future__ import annotations

import numpy as np
import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.segment import (
    CLAMP_MAX,
    CLAMP_MIN,
    CORRECTOR,
    ERROR,
    SEG_DIST,
    STALL_LEN,
    STD_SCALE,
    WINDOW,
)

_FIND = kernel("find_stall", "segment.cu", "htt_find_stall", "pplllpppp")

#: threads a block (a read), samples a chunk (a thread's share of a tile),
#: samples a tile, chunks a group step of the sums, and the factor whose
#: binade is the lowest tabulated: csrc/segment.cu's THREADS, CHUNK, TILE,
#: GROUP and GUESS
THREADS = 256
CHUNK = 256
TILE = THREADS * CHUNK
GROUP = 8
GUESS = 15 / 16


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _thresholds(a: np.ndarray):
    """(top, bot) of one read's clamped float32 samples: the two sums
    serial in sample order and every operation rounded to float32, as
    the C does (np.add.accumulate is sequential; torch.sum, cumsum and
    np.sum are not)."""
    nf = np.float32(a.size)
    mean = np.add.accumulate(a, dtype=np.float32)[-1] / nf
    d = a - mean
    var = np.add.accumulate(d * d, dtype=np.float32)[-1] / nf
    sd = np.sqrt(np.float32(var))
    scale = np.float32(STD_SCALE)
    return np.float32(mean + sd * scale), np.float32(mean - sd * scale)


def _first_segment(inband) -> tuple[int, int, int]:
    """native/segment.c's run state machine over one read's in-band
    flags -> (number of segments, first start, first end)."""
    inseg = False
    err = run_err = count = 0
    w = CORRECTOR
    seg_start = nsegs = first_x = first_y = last_y = 0
    for i, inb in enumerate(inband):
        if inb:
            if not inseg:
                seg_start, inseg = i, True
            count += 1
            w += 1
            run_err = 0
            if count >= WINDOW and count >= w and count % w == 0:
                err -= 1
        elif not inseg:
            continue
        elif err < ERROR:
            count += 1
            err += 1
            run_err += 1
            if count >= WINDOW and count >= w and count % w == 0:
                err -= 1
        else:
            if count >= WINDOW or (nsegs == 0
                                   and count >= WINDOW * STALL_LEN):
                seg_end = i - run_err
                if nsegs and seg_start - last_y < SEG_DIST:
                    last_y = seg_end  # merge into the previous segment
                    if nsegs == 1:
                        first_y = seg_end
                else:
                    nsegs += 1
                    last_y = seg_end
                    if nsegs == 1:
                        first_x, first_y = seg_start, seg_end
            inseg = False
            count = err = run_err = 0
    return nsegs, first_x, first_y


def find_stall_plain(sig, n):
    """(exists [B] bool, start [B] int32, length [B] int32) of the first
    stall segment of each row's first n samples (n clamped to [0, L]).
    The clamp runs in torch; the sums and the state machine run a read
    at a time on the host."""
    B, L = sig.shape
    a = sig.to(torch.float32).clamp(CLAMP_MIN, CLAMP_MAX).cpu().numpy()
    nn = n.to(torch.int64).clamp(0, L).cpu().tolist()
    out = np.zeros((3, B), np.int64)
    for b, m in enumerate(nn):
        if m == 0:
            continue
        row = a[b, :m]
        top, bot = _thresholds(row)
        nsegs, x, y = _first_segment(((row < top) & (row > bot)).tolist())
        if nsegs:
            out[:, b] = (1, x, y - x + 1)
    out = torch.from_numpy(out).to(sig.device)
    return out[0].bool(), out[1].to(torch.int32), out[2].to(torch.int32)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------


def find_stall(sig, n):
    """First stall segment per row -> (exists, start, length)."""
    if is_cpu(sig, n):
        return find_stall_plain(sig, n)
    check(sig, "sig", (torch.int16,))
    if sig.dim() != 2:
        raise ValueError(f"sig: shape {tuple(sig.shape)} is not [B, L]")
    B, L = sig.shape
    check(n, "n", (torch.int32,), (B,))
    dev = sig.device
    exists = torch.empty((B,), dtype=torch.bool, device=dev)
    start = torch.empty((B,), dtype=torch.int32, device=dev)
    length = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        vec = int(sig.data_ptr() % 16 == 0 and L % 8 == 0)
        _FIND(sig.data_ptr(), n.data_ptr(), B, L, vec, exists.data_ptr(),
              start.data_ptr(), length.data_ptr(), stream_ptr(dev))
    return exists, start, length
