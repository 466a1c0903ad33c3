"""Batched flat_uint_submin: the optimal step-aligned flat-region
partition (the plain version of kernel K, csrc/flats.cu) and the
codec's assembly and parse.

The counterpart of honours_tpu/codecs/flats.py.  Candidate boundaries
are 0, step, 2 step, ... and n (step: utils/config.py flats_step,
HTPU_FLATS_STEP); the partition minimises the stream's bytes, a 3-byte
header a segment plus its packed (x - min) fields, the smallest i
winning a tie, as partition_flats does.  Stream (byte for byte the host
codec's, for every read):
  [nseg:u32][svb32 of the segment lengths]
  per segment: [min:u16][b:1B][MSB-first packed (x - min), b bits each]
an empty read is [0:u32].  The fields are packed and unpacked by kernels
I and J (engine/bitpack_cuda.py), one row a segment.  The parse walks
the segment headers in order (a segment's bytes follow from its b) with
kernel M (engine/hdrwalk_cuda.py), one launch a bucket.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.bitpack import minbits
from honours_tpu_torch.engine.bitpack_cuda import pack_msb, unpack_msb
from honours_tpu_torch.engine.bits import read_u32le, u32le_bytes
from honours_tpu_torch.engine.hdrwalk_cuda import FLATS, hdrwalk
from honours_tpu_torch.engine.permute import monotone_compact, rowwise_shift_left
from honours_tpu_torch.engine.svb32 import (
    _nbytes_and_codes,
    svb32_decode_batch,
    svb32_encode_batch,
)
from honours_tpu_torch.engine.vb_batch import as_i16

SEG_HDR_BYTES = 3  # min u16 + minbits u8


def chunks(L: int, step: int) -> int:
    """Candidate chunks of an L-wide row: ceil(L / step)."""
    return -(-L // step)


def chunk_minmax(u, n, step: int):
    """Each chunk's (min, max) of [B, L] uint16-valued ints (first n
    valid) -> two [B, ceil(L / step)] int64; a chunk with no valid
    sample gives (0xFFFF, 0)."""
    B, L = u.shape
    m = chunks(L, step)
    g = F.pad(u.to(torch.int64), (0, m * step - L)).reshape(B, m, step)
    live = (torch.arange(m * step, device=u.device)[None, :]
            < n.to(torch.int64)[:, None]).reshape(B, m, step)
    return (torch.where(live, g, 0xFFFF).amin(dim=2),
            torch.where(live, g, 0).amax(dim=2))


def flats_partition_plain(sig, n, step: int):
    """Kernel K's plain version.  sig [B, L] int16 (the samples as
    uint16, first n valid, n clamped to [0, L]) -> cut [B, ceil(L / step)
    + 1] u8: 1 at each chosen boundary index (0 .. m, boundary k at
    min(k step, n)), partition_flats' cuts.  The DP runs a step j at a
    time over every row: the range of chunks i..j-1 for every i < j,
    each cost, and the first minimum."""
    B, L = sig.shape
    dev = sig.device
    n = n.to(torch.int64).clamp(0, L)
    m = chunks(L, step)
    mr = (n + step - 1) // step
    cmin, cmax = chunk_minmax(sig.to(torch.int64) & 0xFFFF, n, step)
    smin, smax = cmin.clone(), cmax.clone()
    best = torch.zeros((B, m + 1), dtype=torch.int64, device=dev)
    prev = torch.zeros((B, m + 1), dtype=torch.int64, device=dev)
    at = torch.arange(m, device=dev) * step
    for j in range(1, int(mr.max()) + 1 if B else 1):
        smin[:, :j] = torch.minimum(smin[:, :j], cmin[:, j - 1: j])
        smax[:, :j] = torch.maximum(smax[:, :j], cmax[:, j - 1: j])
        bj = torch.clamp(n, max=j * step)[:, None]
        cost = best[:, :j] + SEG_HDR_BYTES + (
            (bj - at[:j]) * minbits(smax[:, :j] - smin[:, :j]) + 7) // 8
        best[:, j], prev[:, j] = cost.min(dim=1)  # the first minimum
    cut = torch.zeros((B, m + 1), dtype=torch.uint8, device=dev)
    rows = torch.arange(B, device=dev)
    k = mr
    cut[rows, k] = 1
    for _ in range(int(mr.max()) if B else 0):
        k = prev.gather(1, k[:, None])[:, 0]
        cut[rows, k] = 1
        if not bool(k.any()):
            break
    return cut


def _step(step):
    if step is None:
        from honours_tpu_torch.utils.config import get_config

        step = get_config().flats_step
    if step < 1:
        raise ValueError(f"flats step {step} must be at least 1")
    return int(step)


def press_flats_batch(sig, n, step: int = None):
    """flat_uint_submin of [B, L] int16 (first n valid) -> (stream [B, W]
    u8, len [B] int64)."""
    from honours_tpu_torch.engine.flats_cuda import flats_partition

    step = _step(step)
    B, L = sig.shape
    dev = sig.device
    n = n.to(torch.int64).clamp(0, L)
    m = chunks(L, step)
    u = sig.to(torch.int64) & 0xFFFF
    cut = flats_partition(sig.contiguous(), n.to(torch.int32), step).bool()
    pos = torch.minimum(torch.arange(m + 1, device=dev)[None, :] * step,
                        n[:, None])
    bpos = monotone_compact(pos.to(torch.int32), cut)[0].to(torch.int64)
    nseg = (cut.sum(dim=1) - 1).clamp(min=0)
    seg_ok = torch.arange(m, device=dev)[None, :] < nseg[:, None]
    starts = bpos[:, :m]
    lens = torch.where(seg_ok, bpos[:, 1:] - starts, 0)
    # chunk c lies in the segment of the cuts at boundary indices 1..c
    soc = (torch.cumsum(cut[:, :m].to(torch.int64), dim=1) - 1).clamp(min=0)
    cmin, cmax = chunk_minmax(u, n, step)
    smin = torch.full((B, m), 0xFFFF, dtype=torch.int64, device=dev)
    smin = smin.scatter_reduce(1, soc, cmin, "amin")
    smax = torch.zeros((B, m), dtype=torch.int64, device=dev)
    smax = smax.scatter_reduce(1, soc, cmax, "amax")
    smin = torch.where(seg_ok, smin, 0)
    bits = torch.where(seg_ok, minbits((smax - smin).clamp(min=0)), 0)
    size = torch.where(seg_ok, SEG_HDR_BYTES + (lens * bits + 7) // 8, 0)
    m4 = -(-m // 4) * 4
    svb, svb_len = svb32_encode_batch(F.pad(lens, (0, m4 - m)), nseg)
    svb_len = svb_len.to(torch.int64)
    seg_off = 4 + svb_len[:, None] + torch.cumsum(size, dim=1) - size
    W = 4 + svb.shape[1] + SEG_HDR_BYTES * m + 2 * L
    # column W takes the headers of absent segments, and is dropped
    stream = torch.zeros((B, W + 1), dtype=torch.uint8, device=dev)
    stream[:, :4] = u32le_bytes(nseg)
    stream[:, 4: 4 + svb.shape[1]] = svb
    for k, byte in enumerate((smin & 0xFF, smin >> 8, bits)):
        stream.scatter_(1, torch.where(seg_ok, seg_off + k, W),
                        byte.to(torch.uint8))
    col = torch.arange(L, device=dev)[None, :]
    seg = soc.gather(1, (col // step).expand(B, L))
    vals = torch.where(col < n[:, None], (u - smin.gather(1, seg)) & 0xFFFF,
                       0)
    rows = torch.arange(B, device=dev)[:, None]
    pack_msb(vals.to(torch.int32).reshape(-1), (rows * L + starts).reshape(-1),
             lens.reshape(-1), bits.reshape(-1), stream.reshape(-1),
             (rows * (W + 1) + seg_off + SEG_HDR_BYTES).reshape(-1))
    return stream[:, :W], 4 + svb_len + size.sum(dim=1)


def walk_args(stream, n):
    """(first, nseg, lens) of flats streams [B, M] u8 of reads of n
    samples: the byte of each row's first segment header (after [nseg:
    u32] and the svb32 of the lengths), its segment count (at most n)
    and its segment lengths [B, S] int64, S the largest count, zeros
    past a row's own: what kernel M walks."""
    B, M = stream.shape
    dev = stream.device
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    nseg = torch.minimum(read_u32le(stream, zero), n.to(torch.int64))
    S = int(nseg.max()) if B else 0
    if S == 0:
        return zero + 4, nseg, torch.zeros((B, 0), dtype=torch.int64,
                                            device=dev)
    S4 = -(-S // 4) * 4
    lens = svb32_decode_batch(
        rowwise_shift_left(stream, zero + 4, S4 // 4 + 4 * S4), nseg, S4)
    seg_ok = torch.arange(S, device=dev)[None, :] < nseg[:, None]
    lens = torch.where(seg_ok, lens[:, :S].to(torch.int64), 0)
    nb = _nbytes_and_codes(lens, "1234")[0]
    used = (nseg + 3) // 4 + torch.where(seg_ok, nb, 0).sum(dim=1)
    return 4 + used, nseg, lens


def depress_flats_batch(stream, n, L: int):
    """Inverse of press_flats_batch (streams from either package) -> [B,
    L] int16, zero past n."""
    B, M = stream.shape
    dev = stream.device
    n = n.to(torch.int64).clamp(0, L)
    first, nseg, lens = walk_args(stream, n)
    S = lens.shape[1]
    if S == 0:
        return torch.zeros((B, L), dtype=torch.int16, device=dev)
    seg_ok = torch.arange(S, device=dev)[None, :] < nseg[:, None]
    # the walk (kernel M): a segment's header is where the one before it
    # ends
    hdr = hdrwalk(stream.contiguous(), first, nseg, lens, FLATS)

    def byte(k):
        return stream.gather(1, (hdr + k).clamp(0, M - 1)).to(torch.int64)

    mins, bits = byte(0) | (byte(1) << 8), byte(2)
    doff = hdr + SEG_HDR_BYTES
    starts = torch.cumsum(lens, dim=1) - lens
    count = torch.where(seg_ok, torch.minimum(lens, L - starts), 0).clamp(
        min=0)
    rows = torch.arange(B, device=dev)[:, None]
    out = torch.zeros(B * L, dtype=torch.int32, device=dev)
    unpack_msb(stream.contiguous().reshape(-1), (rows * M + doff).reshape(-1),
               (M - doff).reshape(-1), count.reshape(-1), bits.reshape(-1),
               out, (rows * L + starts).reshape(-1))
    col = torch.arange(L, device=dev)[None, :].expand(B, L).contiguous()
    seg = torch.searchsorted(torch.cumsum(lens, dim=1), col, right=True)
    v = out.reshape(B, L).to(torch.int64) + mins.gather(1, seg.clamp(max=S - 1))
    return torch.where(col < n[:, None], as_i16(v), 0).to(torch.int16)
