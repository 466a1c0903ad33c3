"""Batched svb16 (the VBZ container's stream VByte) encode and decode.

One kernel per direction (engine/svb16_cuda.py, kernels 5 and 6) does
the whole codec: zigzag-delta (zd) or raw uint16, key bitmap, 1/2-byte
fields, and the inverse.  Streams equal honours_tpu's engine and host
codec (svb12_zd / svb12) byte for byte.  Any bucket width L with
L % 8 == 0 is taken.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.svb16_cuda import svb16_decode, svb16_encode


def svb16_encode_batch(sig, n, zd: bool = True):
    """Encode [B, L] int16 with lengths n -> (stream [B, L//8 + 2L] u8,
    out_len [B] int32); bytes past a row's length are 0."""
    return svb16_encode(sig.contiguous(), n.to(torch.int32).contiguous(), zd)


def svb16_decode_batch(stream, n, L: int, zd: bool = True):
    """Decode [B, M] u8 with lengths n -> [B, L] int16 (zero past n)."""
    return svb16_decode(stream.contiguous(), n.to(torch.int32).contiguous(),
                        L, zd)


def _interleave2(a, b):
    """[B, L] x2 -> [B, 2L] with a at even, b at odd columns."""
    B, L = a.shape
    return torch.stack([a, b], dim=2).reshape(B, 2 * L)
