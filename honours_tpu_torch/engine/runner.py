"""Bucketed execution of whole read sets through the drans engine.

Reads are grouped into power-of-two padded buckets (io/batching.py),
each bucket runs the batched engine on the device, and per-read streams
come back in original order, byte-identical to honours_tpu's engine and
host codec for drans_vbbe21_zd.

Two kinds of rows leave the bucket's group and run alone, as one-row
batches with emax = L (the grouping of a single-read host press, so the
bytes are the host codec's):
- encode rows with more exceptions than the bucket's cap emax = L/16
  (the vbbe21 count in the stream header is exact even when the capped
  buffers overflowed, so such rows are found from their own bytes);
- decode rows whose G header is <= 1 (streams written per read) and the
  capped-overflow rows.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from honours_tpu_torch.device import resolve_device
from honours_tpu_torch.engine.drans import (
    depress_drans_batch,
    press_drans_batch,
)
from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
from honours_tpu_torch.io.batching import bucket_reads, restore_order

ENGINE_CODECS = ("drans_vbbe21_zd",)


def _check_codec(codec_name: str) -> None:
    if codec_name not in ENGINE_CODECS:
        raise NotImplementedError(
            f"{codec_name} is not ported yet: this port runs "
            f"{', '.join(ENGINE_CODECS)}; see ROADMAP.md, 'Modules to port'")


def _emax(L: int) -> int:
    return max(64, L // 16)


def _nex_overflowed(blob: bytes, emax: int) -> bool:
    """[G:u16][zd0:u16][nex:u32]... : the exact exception count."""
    if len(blob) < 8:
        return False
    (nex,) = struct.unpack_from("<I", blob, 4)
    return nex > emax


def _per_read(blob: bytes) -> bool:
    """Streams with G <= 1 were pressed alone and decode alone."""
    return len(blob) >= 2 and struct.unpack_from("<H", blob, 0)[0] <= 1


def _press_one(sig: np.ndarray, L: int, tabs, dev) -> bytes:
    s = torch.zeros((1, L), dtype=torch.int16, device=dev)
    s[0, : sig.size] = torch.from_numpy(sig).to(dev)
    n = torch.tensor([sig.size], device=dev)
    st, sl = press_drans_batch(s, n, tabs, L)
    return st[0, : int(sl[0])].cpu().numpy().tobytes()


def _depress_one(blob: bytes, nin: int, L: int, tabs, dev) -> np.ndarray:
    W = -(-len(blob) // 128) * 128
    buf = np.zeros((1, W), np.uint8)
    buf[0, : len(blob)] = np.frombuffer(blob, np.uint8)
    n = torch.tensor([nin], device=dev)
    out = depress_drans_batch(torch.from_numpy(buf).to(dev), n, tabs, L,
                              emax=L)
    return out[0, :nin].cpu().numpy()


def press_signals(signals, codec_name: str = "drans_vbbe21_zd",
                  max_b: int = 256, device="cuda"):
    """Compress int16 reads -> list[bytes] in original order."""
    _check_codec(codec_name)
    dev = resolve_device(device)
    tabs = canned_o1_device_tables(dev)
    buckets = bucket_reads(signals, max_b=max_b)
    outs = []
    for b in buckets:
        emax = _emax(b.L)
        st, sl = press_drans_batch(torch.from_numpy(b.sig).to(dev),
                                   torch.from_numpy(b.n).to(dev), tabs, emax)
        st, sl = st.cpu().numpy(), sl.cpu().numpy()
        rows = []
        for i in range(len(b.indices)):
            blob = st[i, : sl[i]].tobytes()
            if _nex_overflowed(blob, emax):
                blob = _press_one(b.sig[i, : b.n[i]], b.L, tabs, dev)
            rows.append(blob)
        outs.append(rows)
    return restore_order(buckets, outs)


def depress_signals(streams, lengths, codec_name: str = "drans_vbbe21_zd",
                    max_b: int = 256, device="cuda"):
    """Decode per-read streams (from either package) -> int16 arrays in
    original order.  The bucketing must match the encoder's max_b."""
    _check_codec(codec_name)
    dev = resolve_device(device)
    tabs = canned_o1_device_tables(dev)
    buckets = bucket_reads([np.zeros(int(m), np.int16) for m in lengths],
                           max_b=max_b)
    outs = []
    for b in buckets:
        emax = _emax(b.L)
        rows = [streams[i] for i in b.indices]
        alone = {j for j, blob in enumerate(rows)
                 if _nex_overflowed(blob, emax) or _per_read(blob)}
        dec = [None] * len(rows)
        if len(alone) < len(rows):
            # rows decoded alone stay zero here: a zero row parses as an
            # empty stream, so the group keeps the encoder's membership
            W = -(-max(len(r) for r in rows) // 128) * 128
            buf = np.zeros((len(rows), W), np.uint8)
            for j, blob in enumerate(rows):
                if j not in alone:
                    buf[j, : len(blob)] = np.frombuffer(blob, np.uint8)
            out = depress_drans_batch(torch.from_numpy(buf).to(dev),
                                      torch.from_numpy(b.n).to(dev), tabs,
                                      b.L, emax=emax).cpu().numpy()
            for j in range(len(rows)):
                if j not in alone:
                    dec[j] = out[j, : b.n[j]]
        for j in alone:
            dec[j] = _depress_one(rows[j], int(b.n[j]), b.L, tabs, dev)
        outs.append(dec)
    return restore_order(buckets, outs)
