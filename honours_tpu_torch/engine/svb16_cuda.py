"""Kernels 5 and 6: svb16 encode and decode (csrc/svb16.cu), each beside
its plain PyTorch version.

Kernel 5, `svb16_encode`, replaces honours_tpu/engine/svb16_fused.py
svb16_encode_fused; kernel 6, `svb16_decode`, replaces
svb16_decode_fused.  The stream of a row of n samples (n clamped to
[0, L]) is ceil(n/8) key bytes (bit j%8 of byte j/8 set when sample j
takes two bytes, LSB first) followed by each sample's field: its low
byte, and its high byte when v >= 256.  v is the uint16 zigzag of the
sample deltas (zd) or the raw uint16 sample.  Encode output is
[B, L/8 + 2L] u8, zero past each row's length, beside the lengths
[B] int32; decode gives [B, L] int16, zero past n.  Stream bytes outside
a row read as 0.

Both kernels cut every row into tiles (ENCODE_TILE and DECODE_TILE
samples; `encode_tiles`, `decode_tiles`) and chain a row's tiles through a
zeroed scratch of one 64-bit state per tile plus a ticket counter
(`encode_scratch_words`, `decode_scratch_words`); rows of one tile take
none.  `encode_tile_ranges` states which tile writes each byte of an
encoded row, as the encode kernel does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

_ENCODE = kernel("svb16_encode", "svb16.cu", "htt_svb16_encode",
                 "ppllllpplpp")
_DECODE = kernel("svb16_decode", "svb16.cu", "htt_svb16_decode",
                 "pllpllplpp")

#: samples an encode tile takes (svb16.cu's ETILE = ET threads x EEPT)
ENCODE_TILE = 2048
#: samples a decode tile takes (svb16.cu's DTILE = DT threads x DEPT)
DECODE_TILE = 2048


def _scratch_words(B: int, tiles: int) -> int:
    if B * tiles >= 1 << 31:
        raise ValueError(f"{B} rows of {tiles} tiles: more than 2^31 tiles")
    return B * tiles + 1 if tiles > 1 else 0


def encode_tiles(L: int) -> int:
    """Tiles of an encode row of width L: one per ENCODE_TILE samples, and
    one for L = 0, which writes the row's length."""
    return max(1, -(-L // ENCODE_TILE))


def encode_scratch_words(B: int, L: int) -> int:
    """int64 words of an encode launch's look-back scratch: a state per
    tile and the ticket counter, or 0 when each row is one tile."""
    return _scratch_words(B, encode_tiles(L))


def decode_tiles(L: int) -> int:
    """Tiles of a decode row of width L (none for L = 0)."""
    return -(-L // DECODE_TILE)


def decode_scratch_words(B: int, L: int) -> int:
    """int64 words of a decode launch's look-back scratch: a state per
    tile and the ticket counter, or 0 when each row is one tile."""
    return _scratch_words(B, decode_tiles(L))


def stream_width(L: int) -> int:
    """Columns of an encoded bucket of width L (L % 8 == 0)."""
    return L // 8 + 2 * L


def encode_tile_ranges(n: int, L: int, counts) -> list:
    """The encode kernel's partition of a row of width L with n live
    samples: for each tile, the byte ranges [lo, hi) it writes, as
    (lo, hi, kind) with kind "key", "field" or "zero".  counts[t] is the
    number of two-byte fields among tile t's samples below n."""
    T = ENCODE_TILE
    n = min(max(n, 0), L)
    kl, W = -(-n // 8), stream_width(L)
    wt = T // 8 + 2 * T  # svb16.cu's EWT
    tiles, E = [], 0
    for t in range(encode_tiles(L)):
        t0, r = t * T, []
        if t0 < n:
            nt, c = min(n - t0, T), int(counts[t])
            r.append((t0 // 8, -(-(t0 + nt) // 8), "key"))
            r.append((kl + t0 + E, kl + t0 + nt + E + c, "field"))
            r.append((kl + 2 * n - (t0 + nt - E - c), kl + 2 * n - (t0 - E),
                      "zero"))
            E += c
        r.append((max(kl + 2 * n, t * wt), min(W, (t + 1) * wt), "zero"))
        tiles.append([x for x in r if x[0] < x[1]])
    return tiles


def _live(n, L: int):
    """(positions [1, L], valid [B, L], n clamped to [0, L] as int64)."""
    n = n.to(torch.int64).clamp(0, L)
    pos = torch.arange(L, device=n.device)[None, :]
    return pos, pos < n[:, None], n


def _byte_at(stream, idx):
    """stream[b, idx] with 0 for idx outside [0, M)."""
    M = stream.shape[1]
    s = F.pad(stream, (0, 1))
    idx = torch.where((idx >= 0) & (idx < M), idx, M)
    return torch.gather(s, 1, idx).to(torch.int64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def svb16_encode_plain(sig, n, zd: bool = True):
    B, L = sig.shape
    pos, valid, n = _live(n, L)
    v = zigdelta(sig) if zd else sig.to(torch.int32) & 0xFFFF
    v = torch.where(valid, v.to(torch.int64), 0)
    two = v >= 256
    e_inc = torch.cumsum(two.to(torch.int64), dim=1)
    kl = (n + 7) // 8
    out = torch.zeros((B, stream_width(L)), dtype=torch.uint8,
                      device=sig.device)
    bits = two.reshape(B, L // 8, 8).to(torch.int64)
    out[:, : L // 8] = (bits << torch.arange(8, device=sig.device)).sum(
        dim=2).to(torch.uint8)
    off = kl[:, None] + pos + e_inc - two.to(torch.int64)
    rows, cols = torch.nonzero(valid, as_tuple=True)
    out[rows, off[rows, cols]] = (v[rows, cols] & 0xFF).to(torch.uint8)
    rows, cols = torch.nonzero(two, as_tuple=True)
    out[rows, off[rows, cols] + 1] = (v[rows, cols] >> 8).to(torch.uint8)
    return out, (kl + n + e_inc[:, -1]).to(torch.int32)


def svb16_decode_plain(stream, n, L: int, zd: bool = True):
    pos, valid, n = _live(n, L)
    kb = _byte_at(stream, (pos >> 3).expand(valid.shape))
    two = valid & (((kb >> (pos & 7)) & 1) == 1)
    t64 = two.to(torch.int64)
    off = (n + 7)[:, None] // 8 + pos + torch.cumsum(t64, dim=1) - t64
    v = _byte_at(stream, off) | torch.where(two, _byte_at(stream, off + 1) << 8,
                                            0)
    v = torch.where(valid, v, 0)
    out = unzigdelta(v) if zd else (v - ((v & 0x8000) << 1)).to(torch.int16)
    return torch.where(valid, out, 0).to(torch.int16)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def svb16_encode(sig, n, zd: bool = True):
    """sig [B, L] int16 (L % 8 == 0), n [B] int32 -> (stream
    [B, L/8 + 2L] u8, length [B] int32)."""
    B, L = sig.shape
    if L % 8:
        raise ValueError(f"L = {L} is not a multiple of 8")
    if is_cpu(sig, n):
        return svb16_encode_plain(sig, n, zd)
    check(sig, "sig", (torch.int16,))
    check(n, "n", (torch.int32,), (B,))
    W = stream_width(L)
    dev = sig.device
    out = torch.empty((B, W), dtype=torch.uint8, device=dev)
    out_len = torch.empty((B,), dtype=torch.int32, device=dev)
    words = encode_scratch_words(B, L)
    if B:
        status = (torch.zeros((words,), dtype=torch.int64, device=dev)
                  if words else None)
        _ENCODE(sig.data_ptr(), n.data_ptr(), B, L, W, int(zd),
                out.data_ptr(), out_len.data_ptr(), encode_tiles(L),
                0 if status is None else status.data_ptr(), stream_ptr(dev))
    return out, out_len


def svb16_decode(stream, n, L: int, zd: bool = True):
    """stream [B, M] u8, n [B] int32 -> [B, L] int16 (zero past n)."""
    if is_cpu(stream, n):
        return svb16_decode_plain(stream, n, L, zd)
    B, M = stream.shape
    check(stream, "stream", (torch.uint8,))
    check(n, "n", (torch.int32,), (B,))
    dev = stream.device
    out = torch.empty((B, L), dtype=torch.int16, device=dev)
    words = decode_scratch_words(B, L)
    if B and L:
        status = (torch.zeros((words,), dtype=torch.int64, device=dev)
                  if words else None)
        _DECODE(stream.data_ptr(), B, M, n.data_ptr(), L, int(zd),
                out.data_ptr(), decode_tiles(L),
                0 if status is None else status.data_ptr(), stream_ptr(dev))
    return out
