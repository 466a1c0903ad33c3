"""rccdf's per-read static-CDF rANS body, batched: the per-row table fit,
the table header's bytes, and the plain versions of kernels F
(rccdf_encode) and G (rccdf_decode), whose wrappers are rccdf_cuda.py.

The counterpart of honours_tpu/kernels/rans.py rans_encode / rans_decode
(the coder of honours_tpu/codecs/rc.py's rccdf_vb*_zd, which runs on the
host only).  A body of n bytes is

  [bitmap:32B][f - 1 of each present symbol, 12 bits MSB-first]
  [16 final states:u32 LE][16 lane lengths:u32 LE][lane 0 bytes]...

(kernels/rans.py rccdf_header): the table is normalize_freqs of the
read's byte histogram, lane i codes bytes i, i + 16, ... walking backward
and its bytes are stored reversed, so that the decode reads each lane
forward.  Byte for byte the host coder's for every row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.bits import pack_fields_msb, unpack_fields_msb
from honours_tpu_torch.engine.permute import rowwise_concat
from honours_tpu_torch.kernels.rans import (
    BITMAP_BYTES,
    K_DEFAULT as K,
    M,
    PROB_BITS,
    RANS_L,
)

#: bytes of the body before its lanes: K states and K lane lengths
BODY_HEAD = 8 * K
#: renormalisation bound of a symbol of frequency f: f << RENORM_SHIFT
RENORM_SHIFT = 23 - PROB_BITS + 8
#: device bytes a row keeps beside its slots while its body is coded:
#: the fitted table (freqs and cum, int32) and its histogram (int64)
STATE_BYTES = 2 * 4 * 256 + 8 * 256


def body_width(N: int) -> int:
    """Columns that hold a body (lanes and their head) of up to N bytes:
    each coded byte emits at most 2."""
    return BODY_HEAD + 2 * N


# ---------------------------------------------------------------------------
# the table: fit, header bytes, parse
# ---------------------------------------------------------------------------


def byte_histogram(data, dlen):
    """[B, N] u8 (first dlen valid) -> counts [B, 256] int64."""
    B, N = data.shape
    valid = torch.arange(N, device=data.device)[None, :] < dlen.to(
        torch.int64)[:, None]
    return torch.zeros((B, 256), dtype=torch.int64,
                       device=data.device).scatter_add_(
        1, data.to(torch.int64), valid.to(torch.int64))


def fit_freqs_batch(counts):
    """normalize_freqs (kernels/rans.py) of each row of counts [B, 256]
    -> freqs [B, 256] int64, summing to M (all 0 for an empty row).

    The host's loop visits the symbols cyclically in order = argsort(-f,
    stable) and steps a symbol where counts > 0 and f + step >= 1.  A
    symbol is visited once a cycle, so which symbols a cycle may step is
    fixed at its start, and each cycle steps the first |diff| of them:
    one pass a cycle, at most one for diff > 0 (diff < P), at most 255
    for diff < 0."""
    counts = counts.to(torch.int64)
    total = counts.sum(dim=1, keepdim=True)
    f = counts * M // total.clamp(min=1)
    f = torch.where((counts > 0) & (f == 0), 1, f)
    diff = torch.where(total[:, 0] > 0, M - f.sum(dim=1), 0)
    order = torch.argsort(-f, dim=1, stable=True)
    fo, co = f.gather(1, order), counts.gather(1, order)
    while bool((diff != 0).any()):
        step = torch.sign(diff)[:, None]
        ok = (co > 0) & (fo + step >= 1) & (diff != 0)[:, None]
        rank = torch.cumsum(ok.to(torch.int64), dim=1) - 1
        adj = ok & (rank < diff.abs()[:, None])
        fo = fo + torch.where(adj, step, 0)
        diff = diff - step[:, 0] * adj.sum(dim=1)
    return torch.zeros_like(fo).scatter_(1, order, fo)


def header_segments(freqs):
    """The table header of freqs [B, 256] as rowwise_concat segments:
    the presence bitmap (32 bytes) and the 12-bit fields (ceil(12 P / 8)
    bytes)."""
    B = freqs.shape[0]
    dev = freqs.device
    present = freqs > 0
    bit = torch.arange(8, device=dev)
    bitmap = (present.reshape(B, BITMAP_BYTES, 8).to(torch.int64)
              << bit).sum(dim=2).to(torch.uint8)
    # the present symbols first, in symbol order: the fields' order
    first = torch.argsort((~present).to(torch.int8), dim=1, stable=True)
    P = present.sum(dim=1)
    col = torch.arange(256, device=dev)[None, :]
    live = col < P[:, None]
    fields = pack_fields_msb(torch.where(live, freqs.gather(1, first) - 1, 0),
                             torch.full((B, 1), PROB_BITS, device=dev),
                             PROB_BITS * col.expand(B, 256), live,
                             256 * PROB_BITS // 32)
    return [(bitmap, torch.full((B,), BITMAP_BYTES, device=dev)),
            (fields, (PROB_BITS * P + 7) // 8)]


def parse_header_batch(stream, off):
    """The table header at byte off of each row -> (freqs [B, 256]
    int64, the header's length [B]); bytes past the row read as 0."""
    B, Mw = stream.shape
    dev = stream.device
    off = off.to(torch.int64)
    idx = off[:, None] + torch.arange(BITMAP_BYTES, device=dev)[None, :]
    bm = torch.where(idx < Mw, stream.gather(1, idx.clamp(0, Mw - 1)), 0)
    bit = torch.arange(8, device=dev)
    present = ((bm.to(torch.int64)[:, :, None] >> bit) & 1).reshape(
        B, 256).bool()
    P = present.sum(dim=1)
    padded = F.pad(stream, (0, 4 + 256 * PROB_BITS // 8))
    vals = unpack_fields_msb(padded, off + BITMAP_BYTES,
                             torch.full_like(P, PROB_BITS), P, 256, PROB_BITS)
    rank = torch.cumsum(present.to(torch.int64), dim=1) - 1
    freqs = torch.where(present, vals.gather(1, rank.clamp(min=0)) + 1, 0)
    return freqs, BITMAP_BYTES + (PROB_BITS * P + 7) // 8


def cum_of(freqs):
    """Exclusive prefix sums of freqs [B, 256] (each symbol's low end)."""
    return torch.cumsum(freqs, dim=1) - freqs


# ---------------------------------------------------------------------------
# kernel F's and G's plain versions
# ---------------------------------------------------------------------------


def _u32le_cols(x):
    """[B, K] uint32 values (int64) -> [B, 4K] u8 little-endian."""
    sh = torch.arange(0, 32, 8, device=x.device)
    return ((x[:, :, None] >> sh) & 0xFF).to(torch.uint8).reshape(
        x.shape[0], 4 * x.shape[1])


def rccdf_encode_plain(data, dlen, freqs, cum):
    """data [B, N] u8 (first dlen valid), freqs and cum [B, 256] int32
    (a normalized table and its low ends; freqs >= 1 for every byte a
    row codes) -> (body [B, body_width(N)] u8 past the header, len [B]
    int64): [16 states][16 lane lengths][lanes, each reversed], zeros
    past len.  The host's lane-parallel walk (rans_encode_static), its
    uint64 states held in int64 (they stay below 2^31)."""
    B, N = data.shape
    dev = data.device
    n = dlen.to(torch.int64).clamp(0, N)
    nsteps = -(-int(n.max()) // K) if B else 0
    d = F.pad(data.to(torch.int64), (0, max(nsteps * K - N, 0)))
    d = d[:, : nsteps * K]
    f_of = freqs.to(torch.int64).gather(1, d).reshape(B, nsteps, K)
    c_of = cum.to(torch.int64).gather(1, d).reshape(B, nsteps, K)
    lanes = torch.arange(K, device=dev)[None, :]
    x = torch.full((B, K), RANS_L, dtype=torch.int64, device=dev)
    lane_n = torch.zeros((B, K), dtype=torch.int64, device=dev)
    cap = max(2 * nsteps, 1)
    buf = torch.zeros((B, K, cap), dtype=torch.uint8, device=dev)
    for t in range(nsteps - 1, -1, -1):
        active = t * K + lanes < n[:, None]
        f, c = f_of[:, t], c_of[:, t]
        ub = f << RENORM_SHIFT
        for _ in range(2):  # emit low bytes while x is too big for f
            over = active & (x >= ub)
            # a lane that emits nothing writes past its length, where a
            # later byte or the reversal's mask covers it
            buf.scatter_(2, lane_n[:, :, None],
                         (x & 0xFF).to(torch.uint8)[:, :, None])
            lane_n = lane_n + over.to(torch.int64)
            x = torch.where(over, x >> 8, x)
        fs = f.clamp(min=1)
        x = torch.where(active, ((x // fs) << PROB_BITS) + x % fs + c, x)
    j = torch.arange(cap, device=dev)[None, None, :]
    rev = buf.gather(2, (lane_n[:, :, None] - 1 - j).clamp(min=0))
    keep = j < lane_n[:, :, None]
    head = torch.cat([_u32le_cols(x), _u32le_cols(lane_n)], dim=1)
    return rowwise_concat(
        [(head, torch.full((B,), BODY_HEAD, device=dev)),
         (rev.reshape(B, K * cap), keep.reshape(B, K * cap))],
        body_width(N))


def _bytes_at(stream, pos):
    """stream[b, pos] as int64, 0 outside the row."""
    Mw = stream.shape[1]
    inside = (pos >= 0) & (pos < Mw)
    return torch.where(inside, stream.gather(1, pos.clamp(0, Mw - 1)),
                       0).to(torch.int64)


def slot_symbols(freqs):
    """The slot -> symbol table of freqs [B, 256] (each in [0, M]) ->
    [B, M] int64: the symbol whose range [cum, cum + f) holds the slot,
    255 for a slot past the table's sum."""
    hi = torch.cumsum(freqs.to(torch.int64), dim=1)
    slots = torch.arange(M, device=freqs.device).expand(freqs.shape[0], M)
    return torch.searchsorted(hi, slots.contiguous(), right=True).clamp(
        max=255)


def rccdf_decode_plain(stream, off, count, freqs, N: int):
    """stream [B, Mw] u8, off [B] (the body's first byte: its states),
    count [B] (bytes to decode, clamped to [0, N]), freqs [B, 256] int32
    (each in [0, M]) -> [B, N] u8, zeros past count.  The host's forward
    walk (rans_decode_static): each lane reads its own bytes, which start
    after the lane lengths before it.  Bytes outside the row read as 0;
    the states are int64 with its wrap (the host's uint64 states stay
    below 2^31 on any stream the encode wrote)."""
    B, Mw = stream.shape
    dev = stream.device
    cnt = count.to(torch.int64).clamp(0, N)
    off = off.to(torch.int64)
    word = 4 * torch.arange(K, device=dev)[None, :] + off[:, None]

    def u32(at):
        return sum(_bytes_at(stream, at + i) << (8 * i) for i in range(4))

    x, lens = u32(word), u32(word + 4 * K)
    start = off[:, None] + BODY_HEAD + torch.cumsum(lens, dim=1) - lens
    f = freqs.to(torch.int64)
    low = cum_of(f)
    lut = slot_symbols(f)
    nsteps = -(-int(cnt.max()) // K) if B else 0
    out = torch.zeros((B, max(nsteps * K, N)), dtype=torch.uint8,
                      device=dev)
    lanes = torch.arange(K, device=dev)[None, :]
    ptr = torch.zeros((B, K), dtype=torch.int64, device=dev)
    for t in range(nsteps):
        active = t * K + lanes < cnt[:, None]
        slot = x & (M - 1)
        sym = lut.gather(1, slot)
        out[:, t * K:(t + 1) * K] = torch.where(active, sym, 0).to(
            torch.uint8)
        x = torch.where(active, f.gather(1, sym) * (x >> PROB_BITS) + slot
                        - low.gather(1, sym), x)
        for _ in range(2):  # refill while x is below RANS_L
            under = active & (x < RANS_L)
            x = torch.where(under, (x << 8) | _bytes_at(stream, start + ptr),
                            x)
            ptr = ptr + under.to(torch.int64)
    return out[:, :N]


# ---------------------------------------------------------------------------
# the body of a batch: (header segments, body) and its decode
# ---------------------------------------------------------------------------


def encode_rccdf_batch(data, dlen):
    """[B, N] u8 (first dlen valid) -> (segments, width): the rccdf body
    of each row as rowwise_concat segments, header and kernel F's body,
    and the columns they may take."""
    from honours_tpu_torch.engine.rccdf_cuda import rccdf_encode

    B, N = data.shape
    dlen = dlen.to(torch.int64).clamp(0, N)
    freqs = fit_freqs_batch(byte_histogram(data, dlen))
    body, blen = rccdf_encode(data.contiguous(), dlen.to(torch.int32),
                              freqs.to(torch.int32),
                              cum_of(freqs).to(torch.int32))
    segs = header_segments(freqs) + [(body, blen)]
    return segs, BITMAP_BYTES + 256 * PROB_BITS // 8 + body.shape[1]


def decode_rccdf_batch(stream, off, count, N: int):
    """The rccdf body at byte off of each row -> [B, N] u8 (zeros past
    count): the header parsed here, the lanes decoded by kernel G."""
    from honours_tpu_torch.engine.rccdf_cuda import rccdf_decode

    freqs, hlen = parse_header_batch(stream, off)
    start = (off.to(torch.int64) + hlen).clamp(0, stream.shape[1])
    return rccdf_decode(stream.contiguous(), start.to(torch.int32),
                        count.to(torch.int64).clamp(0, N).to(torch.int32),
                        freqs.to(torch.int32), N)
