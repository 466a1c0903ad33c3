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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

_ENCODE = kernel("svb16_encode", "svb16.cu", "htt_svb16_encode", "ppllllppp")
_DECODE = kernel("svb16_decode", "svb16.cu", "htt_svb16_decode", "pllpllpp")


def stream_width(L: int) -> int:
    """Columns of an encoded bucket of width L (L % 8 == 0)."""
    return L // 8 + 2 * L


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
    out = torch.empty((B, W), dtype=torch.uint8, device=sig.device)
    out_len = torch.empty((B,), dtype=torch.int32, device=sig.device)
    if B:
        _ENCODE(sig.data_ptr(), n.data_ptr(), B, L, W, int(zd),
                out.data_ptr(), out_len.data_ptr(), stream_ptr(sig.device))
    return out, out_len


def svb16_decode(stream, n, L: int, zd: bool = True):
    """stream [B, M] u8, n [B] int32 -> [B, L] int16 (zero past n)."""
    if is_cpu(stream, n):
        return svb16_decode_plain(stream, n, L, zd)
    B, M = stream.shape
    check(stream, "stream", (torch.uint8,))
    check(n, "n", (torch.int32,), (B,))
    out = torch.empty((B, L), dtype=torch.int16, device=stream.device)
    if B:
        _DECODE(stream.data_ptr(), B, M, n.data_ptr(), L, int(zd),
                out.data_ptr(), stream_ptr(stream.device))
    return out
