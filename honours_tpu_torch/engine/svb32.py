"""Batched classic Stream-VByte (32-bit, variants "1234" and "0124").

Each value's 1-4 (or 0/1/2/4) little-endian bytes sit at fixed
candidate columns [4j .. 4j+3]; the key bytes and the candidate grid are
packed left by one monotone compaction (kernel 1, engine/permute.py),
and decode expands the data bytes back onto the grid.  2-bit length
codes pack 4 to a byte, LSB first, into the key section.  uint32 values
are held in int64.

Streams equal honours_tpu's engine and its host svb32 / svb0124
encoders byte for byte.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.permute import (
    M32,
    compaction_shifts,
    monotone_compact,
    monotone_expand,
    rowwise_shift_left,
)


def _nbytes_and_codes(v, variant: str):
    """Per-value byte count and 2-bit key code."""
    if variant == "1234":
        nb = 1 + (v >= 1 << 8).to(torch.int64) + (v >= 1 << 16).to(
            torch.int64) + (v >= 1 << 24).to(torch.int64)
        return nb, nb - 1
    # 0124: lengths {0, 1, 2, 4}, codes {0, 1, 2, 3}
    code = (v >= 1).to(torch.int64) + (v >= 1 << 8).to(torch.int64) + (
        v >= 1 << 16).to(torch.int64)
    return code + (code == 3).to(torch.int64), code


def _keys_from_codes(codes, N: int):
    """[B, N] 2-bit codes -> [B, N/4] key bytes, LSB-first pairs."""
    B = codes.shape[0]
    w = 1 << (2 * torch.arange(4, device=codes.device))
    return (codes.reshape(B, N // 4, 4) * w).sum(dim=2).to(torch.uint8)


def _interleave4(parts):
    """4x [B, N] -> [B, 4N] with parts[k] at columns 4j+k."""
    B, N = parts[0].shape
    return torch.stack(parts, dim=2).reshape(B, 4 * N)


def _encode_operands(values, n, variant: str):
    """The one compaction of an encode: (payload, keep) [B, N/4 + 4N],
    the key bytes followed by the four interleaved byte planes."""
    B, N = values.shape
    assert N % 4 == 0, N
    dev = values.device
    n = n.to(torch.int64)
    valid = torch.arange(N, device=dev)[None, :] < n[:, None]
    v = torch.where(valid, values.to(torch.int64) & M32, 0)
    nb, codes = _nbytes_and_codes(v, variant)
    keys = _keys_from_codes(torch.where(valid, codes, 0), N)
    data = _interleave4([((v >> (8 * k)) & 0xFF).to(torch.uint8)
                         for k in range(4)])
    keep = _interleave4([valid & (nb > k) for k in range(4)])
    kkeep = torch.arange(N // 4, device=dev)[None, :] < ((n + 3) // 4)[:, None]
    return (torch.cat([torch.where(kkeep, keys, 0), data], dim=1),
            torch.cat([kkeep, keep], dim=1))


def svb32_encode_batch(values, n, variant: str = "1234"):
    """Encode [B, N] uint32 values (int64 or int32 bit patterns; first
    n valid) -> (stream [B, N/4 + 4N] u8, len [B] int32).  N must be a
    multiple of 4 (key bytes pack 4 codes)."""
    return monotone_compact(*_encode_operands(values, n, variant))


def _decode_operands(stream, n, N: int, variant: str):
    """The expansion of a decode: (data bytes [B, 4N] u8, shift, validc),
    contiguous as the kernel takes them, that put each value's bytes at
    its candidate columns, and the valid mask [B, N]."""
    B, M = stream.shape
    assert N % 4 == 0, N
    dev = stream.device
    n = n.to(torch.int64)
    pos = torch.arange(N, device=dev)[None, :]
    valid = pos < n[:, None]
    if M < N // 4:  # a row narrower than the key section reads zeros
        stream = torch.nn.functional.pad(stream, (0, N // 4 - M))
    keys = stream[:, : N // 4].to(torch.int64).repeat_interleave(4, dim=1)
    codes = torch.where(valid, (keys >> (2 * (pos & 3))) & 3, 0)
    nb = codes + 1 if variant == "1234" else codes + (codes == 3).to(
        torch.int64)
    nb = torch.where(valid, nb, 0)
    data = rowwise_shift_left(stream, (n + 3) // 4, 4 * N)
    shift, cnt = compaction_shifts(
        _interleave4([valid & (nb > k) for k in range(4)]))
    validc = torch.arange(4 * N, device=dev)[None, :] < cnt[:, None]
    return data.contiguous(), shift, validc, valid


def svb32_decode_batch(stream, n, N: int, variant: str = "1234"):
    """Decode [B, M] u8 (stream at column 0, first n values) -> [B, N]
    uint32 (int64), zero past n."""
    data, shift, validc, valid = _decode_operands(stream, n, N, variant)
    g = monotone_expand(data, shift, validc, 4 * N)[0].to(torch.int64)
    v = g[:, 0::4] | (g[:, 1::4] << 8) | (g[:, 2::4] << 16) | (
        g[:, 3::4] << 24)
    return torch.where(valid, v, 0)
