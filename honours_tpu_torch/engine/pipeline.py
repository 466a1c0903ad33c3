"""The zigzag-delta split shared by the vbbe21_zd pipelines, the canned
order-1 tables on a device, and the srans3_vbbe21_zd pipeline.

srans3 stream: [zd0:u16][vbbe21 exception block][v4 body], byte-exact
with honours_tpu's engine and host codec per row (no batch-shared
state, so any grouping gives the same bytes).
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import read_u16le, rowwise_concat, u16le_bytes
from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
from honours_tpu_torch.engine.entropy_o1n import (
    canned_o1n_device_tables,
    rans_o1n_decode_batch,
    rans_o1n_encode_batch,
)
from honours_tpu_torch.engine.vbbe21 import (
    vbbe21_fill_batch,
    vbbe21_parse_batch,
    vbbe21_parts_batch,
)
from honours_tpu_torch.kernels.rans import K_SHARED
from honours_tpu_torch.tables.o1 import canned_o1_freqs
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

__all__ = [
    "canned_o1_device_tables", "canned_o1n_device_tables",
    "press_srans3_batch", "depress_srans3_batch",
]


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


def press_srans3_batch(sig, n, tabs, emax: int = None):
    """Batched srans3_vbbe21_zd encode of sig [B, L] int16 (first n[b]
    valid) -> (stream [B, W] u8, len [B] int64).

    `tabs` from canned_o1n_device_tables.  Rows with more than emax
    exceptions give invalid streams (the runner re-encodes them)."""
    B, L = sig.shape
    emax = emax or L
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    parts = vbbe21_parts_batch(rest, n - 1, emax)
    segs_body, planew = rans_o1n_encode_batch(parts["data"],
                                              parts["data_len"], tabs)
    two = torch.full((B,), 2, device=sig.device)
    segs = [(u16le_bytes(zd0), two)] + parts["exsegs"] + segs_body
    total = (2 + 4 + (4 + 4 * emax + 1) + (4 + 2 * emax + 1) + 6
             + (4 + 4 * K_SHARED + planew))
    return rowwise_concat(segs, total)


def depress_srans3_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched srans3_vbbe21_zd decode -> [B, L] int16 (zero past n)."""
    B = stream.shape[0]
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    zd0 = read_u16le(stream, zero)
    parsed = vbbe21_parse_batch(stream, zero + 2, n - 1, L, emax)
    data = rans_o1n_decode_batch(stream, parsed["end_off"],
                                 n - 1 - parsed["nex"], tabs, L)
    vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    return _zd_merge(zd0, vals, n, L)
