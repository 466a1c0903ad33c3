"""Bucketed execution of whole read sets through the batched engines.

Reads are grouped into power-of-two padded buckets (io/batching.py),
each bucket runs the batched engine of the codec on the device, and
per-read streams come back in original order, byte-identical to
honours_tpu's engine and host codec.  Codecs and their engines:
  drans_vbbe21_zd   engine/drans.py     (batch-shared table fit)
  srans3_vbbe21_zd  engine/pipeline.py  (nibble order-1 rANS)
  svb12_zd, svb12   engine/svb16.py     (VBZ container, with/without zd)

Two kinds of rows leave the bucket's group and run alone, as one-row
batches with emax = L (the grouping of a single-read host press, so the
bytes are the host codec's):
- encode and decode rows with more exceptions than the bucket's cap
  emax = L/16 (the vbbe21 count in the stream header is exact even when
  the capped buffers overflowed, so such rows are found from their own
  bytes); svb streams have no exception cap;
- drans decode rows whose G header is <= 1 (streams written per read).
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
from honours_tpu_torch.engine.pipeline import (
    canned_o1_device_tables,
    canned_o1n_device_tables,
    depress_srans3_batch,
    press_srans3_batch,
)
from honours_tpu_torch.engine.svb16 import (
    svb16_decode_batch,
    svb16_encode_batch,
)
from honours_tpu_torch.io.batching import bucket_reads, restore_order

#: codec name -> engine kind (as honours_tpu/engine/runner.py names them)
ENGINE_CODECS = {
    "drans_vbbe21_zd": "drans",
    "srans3_vbbe21_zd": "srans3",
    "svb12_zd": "svb16_zd",
    "svb12": "svb16",
}

#: byte offset of the vbbe21 exception count in each capped kind's
#: stream: [G:u16][zd0:u16][nex:u32]... and [zd0:u16][nex:u32]...
_NEX_AT = {"drans": 4, "srans3": 2}


def _kind(codec_name: str) -> str:
    if codec_name not in ENGINE_CODECS:
        raise NotImplementedError(
            f"{codec_name} is not ported yet: this port runs "
            f"{', '.join(ENGINE_CODECS)}; see ROADMAP.md, 'Modules to port'")
    return ENGINE_CODECS[codec_name]


def batch_engine(codec_name: str, dev):
    """(press(sig, n, emax) -> (stream, len), depress(buf, n, L, emax) ->
    [B, L] int16): the batched engine of a codec on device `dev`."""
    kind = _kind(codec_name)
    if kind == "drans":
        tabs = canned_o1_device_tables(dev)
        return (lambda sig, n, emax: press_drans_batch(sig, n, tabs, emax),
                lambda buf, n, L, emax: depress_drans_batch(buf, n, tabs, L,
                                                            emax=emax))
    if kind == "srans3":
        tabs = canned_o1n_device_tables(dev)
        return (lambda sig, n, emax: press_srans3_batch(sig, n, tabs, emax),
                lambda buf, n, L, emax: depress_srans3_batch(buf, n, tabs, L,
                                                             emax=emax))
    zd = kind == "svb16_zd"
    return (lambda sig, n, emax: svb16_encode_batch(sig, n, zd),
            lambda buf, n, L, emax: svb16_decode_batch(buf, n, L, zd))


def _emax(L: int) -> int:
    return max(64, L // 16)


def _nex_overflowed(blob: bytes, kind: str, emax: int) -> bool:
    """The exact exception count in the stream header exceeds emax."""
    at = _NEX_AT.get(kind)
    if at is None or len(blob) < at + 4:
        return False
    (nex,) = struct.unpack_from("<I", blob, at)
    return nex > emax


def _per_read(blob: bytes, kind: str) -> bool:
    """drans streams with G <= 1 were pressed alone and decode alone."""
    return (kind == "drans" and len(blob) >= 2
            and struct.unpack_from("<H", blob, 0)[0] <= 1)


def _press_one(press, sig: np.ndarray, L: int, dev) -> bytes:
    s = torch.zeros((1, L), dtype=torch.int16, device=dev)
    s[0, : sig.size] = torch.from_numpy(sig).to(dev)
    n = torch.tensor([sig.size], dtype=torch.int32, device=dev)
    st, sl = press(s, n, L)
    return st[0, : int(sl[0])].cpu().numpy().tobytes()


def _depress_one(depress, blob: bytes, nin: int, L: int, dev) -> np.ndarray:
    W = max(128, -(-len(blob) // 128) * 128)
    buf = np.zeros((1, W), np.uint8)
    buf[0, : len(blob)] = np.frombuffer(blob, np.uint8)
    n = torch.tensor([nin], dtype=torch.int32, device=dev)
    out = depress(torch.from_numpy(buf).to(dev), n, L, L)
    return out[0, :nin].cpu().numpy()


def press_signals(signals, codec_name: str = "drans_vbbe21_zd",
                  max_b: int = 256, device="cuda"):
    """Compress int16 reads -> list[bytes] in original order."""
    kind = _kind(codec_name)
    dev = resolve_device(device)
    press, _ = batch_engine(codec_name, dev)
    buckets = bucket_reads(signals, max_b=max_b)
    outs = []
    for b in buckets:
        emax = _emax(b.L)
        st, sl = press(torch.from_numpy(b.sig).to(dev),
                       torch.from_numpy(b.n).to(dev), emax)
        st, sl = st.cpu().numpy(), sl.cpu().numpy()
        rows = []
        for i in range(len(b.indices)):
            blob = st[i, : sl[i]].tobytes()
            if _nex_overflowed(blob, kind, emax):
                blob = _press_one(press, b.sig[i, : b.n[i]], b.L, dev)
            rows.append(blob)
        outs.append(rows)
    return restore_order(buckets, outs)


def depress_signals(streams, lengths, codec_name: str = "drans_vbbe21_zd",
                    max_b: int = 256, device="cuda"):
    """Decode per-read streams (from either package) -> int16 arrays in
    original order.  The bucketing must match the encoder's max_b."""
    kind = _kind(codec_name)
    dev = resolve_device(device)
    _, depress = batch_engine(codec_name, dev)
    buckets = bucket_reads([np.zeros(int(m), np.int16) for m in lengths],
                           max_b=max_b)
    outs = []
    for b in buckets:
        emax = _emax(b.L)
        rows = [streams[i] for i in b.indices]
        alone = {j for j, blob in enumerate(rows)
                 if _nex_overflowed(blob, kind, emax) or _per_read(blob, kind)}
        dec = [None] * len(rows)
        if len(alone) < len(rows):
            # rows decoded alone stay zero here: a zero row parses as an
            # empty stream, so the group keeps the encoder's membership
            W = max(128, -(-max(len(r) for r in rows) // 128) * 128)
            buf = np.zeros((len(rows), W), np.uint8)
            for j, blob in enumerate(rows):
                if j not in alone:
                    buf[j, : len(blob)] = np.frombuffer(blob, np.uint8)
            out = depress(torch.from_numpy(buf).to(dev),
                          torch.from_numpy(b.n).to(dev), b.L, emax)
            out = out.cpu().numpy()
            for j in range(len(rows)):
                if j not in alone:
                    dec[j] = out[j, : b.n[j]]
        for j in alone:
            dec[j] = _depress_one(depress, rows[j], int(b.n[j]), b.L, dev)
        outs.append(dec)
    return restore_order(buckets, outs)
