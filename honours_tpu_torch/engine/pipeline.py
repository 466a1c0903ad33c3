"""The zigzag-delta split shared by the vbbe21_zd pipelines, and the
canned order-1 tables on a device."""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
from honours_tpu_torch.tables.o1 import canned_o1_freqs
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta


def _zd_parts(sig, n):
    """zigzag-delta, then split the first value from the rest (vbbe21
    codes zd[1:]).  Returns (zd0 [B], rest [B, L])."""
    zd = zigdelta(sig)
    rest = torch.nn.functional.pad(zd[:, 1:], (0, 1))
    return zd[:, 0], rest


def _zd_merge(zd0, vals, n, L: int):
    """Reassemble [zd0, vals[:n-1]] and invert the zigzag-delta ->
    [B, L] int16 (zero past n)."""
    pos = torch.arange(L, device=vals.device)[None, :]
    live = pos < n.to(torch.int64)[:, None]
    zd = torch.cat([zd0[:, None].to(torch.int64),
                    vals[:, : L - 1].to(torch.int64)], dim=1)
    out = unzigdelta(torch.where(live, zd, 0))
    return torch.where(live, out, 0).to(torch.int16)


def canned_o1_device_tables(device) -> dict:
    return make_o1_tables(canned_o1_freqs(), device)
