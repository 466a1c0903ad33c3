"""Batched zigzag-delta transform over the last axis, in uint16 wrap
space (press/trans.c zigdelta_16_u16 / unzigdelta_u16_16 semantics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def zigdelta(x: torch.Tensor) -> torch.Tensor:
    """int16 [..., L] -> uint16-valued int32 zigzag of successive deltas
    (the element before the first is 0)."""
    u = x.to(torch.int32) & 0xFFFF
    prev = F.pad(u[..., :-1], (1, 0))
    d = (u - prev) & 0xFFFF
    sign = (0x10000 - (d >> 15)) & 0xFFFF  # 0 or 0xFFFF
    return ((d + d) & 0xFFFF) ^ sign


def unzigdelta(z: torch.Tensor) -> torch.Tensor:
    """Inverse of zigdelta: uint16-valued integers in, int16 out."""
    z = z.to(torch.int64) & 0xFFFF
    d = ((z >> 1) ^ ((0x10000 - (z & 1)) & 0xFFFF)) & 0xFFFF
    s = torch.cumsum(d, dim=-1) & 0xFFFF
    return (s - ((s & 0x8000) << 1)).to(torch.int16)
