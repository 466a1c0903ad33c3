"""Batched zigzag-delta transform over the last axis, in uint16 wrap
space (press/trans.c zigdelta_16_u16 / unzigdelta_u16_16 semantics), the
elementwise zigzag16 / unzigzag16, and the batched quantisation shift
find_qts (honours_tpu/transforms/core.py's,
a row at a time)."""

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


def zigzag16(u: torch.Tensor) -> torch.Tensor:
    """uint16-valued ints -> (u + u) ^ (u >> 15, arithmetic) as uint16
    values, int64 (press/trans.c:75-78)."""
    u = u.to(torch.int64) & 0xFFFF
    return ((u + u) & 0xFFFF) ^ (0xFFFF * (u >> 15))


def unzigzag16(z: torch.Tensor) -> torch.Tensor:
    """Inverse of zigzag16: (z >> 1) ^ -(z & 1) as uint16 values, int64
    (press/trans.c:80-83)."""
    z = z.to(torch.int64) & 0xFFFF
    return (z >> 1) ^ (0xFFFF * (z & 1))


def unzigdelta(z: torch.Tensor) -> torch.Tensor:
    """Inverse of zigdelta: uint16-valued integers in, int16 out."""
    z = z.to(torch.int64) & 0xFFFF
    d = ((z >> 1) ^ ((0x10000 - (z & 1)) & 0xFFFF)) & 0xFFFF
    s = torch.cumsum(d, dim=-1) & 0xFFFF
    return (s - ((s & 0x8000) << 1)).to(torch.int16)


def find_qts(sig: torch.Tensor, n: torch.Tensor,
             max_q: int = 5) -> torch.Tensor:
    """Per row of [B, L] int16 sig (first n valid), the largest
    q <= max_q such that every valid sample has q trailing zero bits
    (press/ex_zd.c:358-381) -> [B] int64; empty rows give max_q as the
    host does.  The OR over the row is read one mask of low bits at a
    time."""
    L = sig.shape[1]
    u = sig.to(torch.int32) & 0xFFFF
    valid = torch.arange(L, device=sig.device)[None, :] < n.to(
        torch.int64)[:, None]
    u = torch.where(valid, u, 0)
    q = torch.zeros((sig.shape[0],), dtype=torch.int64, device=sig.device)
    for k in range(1, max_q + 1):
        q = q + ((u & ((1 << k) - 1)) == 0).all(dim=1).to(torch.int64)
    return q
