"""Kernels F and G: rccdf's static-CDF rANS encode and decode
(csrc/rccdf.cu), beside their plain versions (engine/rccdf.py).

No TPU kernel stands behind them: honours_tpu runs this coder on the
host only (honours_tpu/kernels/rans.py rans_encode_static and
rans_decode_static, numpy loops).  The wrappers route by device: CPU
tensors take the plain versions, CUDA tensors launch the kernels: the
encode a block of 160 threads a row, the decode a block of 256 threads a
row (lanes 0-15 of warp 0 walking with 32-bit states, one slot lookup a
step and their stream bytes staged in shared memory and registers).
Both kernels write every byte of their outputs, so the wrappers allocate
them with torch.empty.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.rccdf import (
    body_width,
    rccdf_decode_plain,
    rccdf_encode_plain,
)
from honours_tpu_torch.kernels.rans import K_DEFAULT as K

_ENCODE = kernel("rccdf_encode", "rccdf.cu", "htt_rccdf_encode",
                 "pllpppplpplp")
_DECODE = kernel("rccdf_decode", "rccdf.cu", "htt_rccdf_decode",
                 "pllpplppp")


def _rows(t, name: str):
    check(t, name, (torch.uint8,))
    if t.dim() != 2:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not [B, N]")
    return t.shape


def rccdf_encode(data, dlen, freqs, cum):
    """data [B, N] u8, dlen [B] int32 (bytes a row codes, clamped to
    [0, N]), freqs and cum [B, 256] int32 (each row's normalized table
    and its low ends; freqs >= 1 for every byte the row codes) -> (body
    [B, 128 + 2N] u8, len [B] int64): [16 states][16 lane lengths][lanes,
    each reversed] as rans_encode_static writes them, zeros past len."""
    if is_cpu(data, dlen, freqs, cum):
        return rccdf_encode_plain(data, dlen, freqs, cum)
    B, N = _rows(data, "data")
    check(dlen, "dlen", (torch.int32,), (B,))
    check(freqs, "freqs", (torch.int32,), (B, 256))
    check(cum, "cum", (torch.int32,), (B, 256))
    dev = data.device
    W = body_width(N)
    # a lane's run of emitted bytes (2 a lane step at most) in 4-byte
    # words: 16 cap bytes of scratch a row
    cap = max(4, -(-2 * -(-N // K) // 4) * 4)
    # the kernel writes every byte of out, zeros past len included
    out = torch.empty((B, W), dtype=torch.uint8, device=dev)
    blen = torch.empty((B,), dtype=torch.int64, device=dev)
    scratch = torch.empty((B, K, cap), dtype=torch.uint8, device=dev)
    _ENCODE(data.data_ptr(), B, N, dlen.data_ptr(), freqs.data_ptr(),
            cum.data_ptr(), out.data_ptr(), W, blen.data_ptr(),
            scratch.data_ptr(), cap, stream_ptr(dev))
    return out, blen


def rccdf_decode(stream, off, count, freqs, N: int):
    """stream [B, M] u8, off [B] int32 (where each row's body starts: its
    states), count [B] int32 (bytes to decode, clamped to [0, N]), freqs
    [B, 256] int32 (each in [0, 4096]) -> [B, N] u8, zeros past count, as
    rans_decode_static decodes them; bytes outside the row read as 0."""
    if is_cpu(stream, off, count, freqs):
        return rccdf_decode_plain(stream, off, count, freqs, N)
    B, M = _rows(stream, "stream")
    check(off, "off", (torch.int32,), (B,))
    check(count, "count", (torch.int32,), (B,))
    check(freqs, "freqs", (torch.int32,), (B, 256))
    if N < 0:
        raise ValueError(f"N {N} is negative")
    # the kernel writes every byte of out, zeros past count included
    out = torch.empty((B, N), dtype=torch.uint8, device=stream.device)
    _DECODE(stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(), N,
            freqs.data_ptr(), out.data_ptr(), stream_ptr(stream.device))
    return out
