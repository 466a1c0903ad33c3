"""The zigzag-delta split shared by the vbbe21_zd pipelines, the canned
tables on a device, and the srans family's and shuffman's pipelines.

Each stream is [zd0:u16][vbbe21 exception block][entropy body] (for
shuffman, the exception block of any of four containers):
  srans_vbbe21_zd     v2 body, canned order-0 table (engine/entropy.py)
  srans2_vbbe21_zd    v3 body, canned order-1 table (engine/entropy_o1.py)
  srans3_vbbe21_zd    v4 body, canned nibble tables (engine/entropy_o1n.py)
  shuffman_<vb>_zd    [dataBytes:u32 BE][LSB-first bits], canned NA12878
                      Huffman table (engine/entropy.py encode, kernel C
                      decode, engine/huffdec_cuda.py), over any container
                      but vb1e2 (engine/vb_batch.py's exception blocks)
Byte-exact with honours_tpu's engines and host codecs per row (no
batch-shared state, so any grouping gives the same bytes); for shuffman,
with the host codec where honours_tpu's engine cuts a row's bits
(engine/entropy.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from honours_tpu_torch.engine.bits import (
    read_u16le,
    read_u32be,
    rowwise_concat,
    u16le_bytes,
)
from honours_tpu_torch.engine.entropy import (
    make_tables,
    rans_decode_batch,
    rans_encode_batch,
    shuff_encode_batch,
)
from honours_tpu_torch.engine.entropy_o1 import (
    make_o1_tables,
    rans_o1_decode_batch,
    rans_o1_encode_batch,
)
from honours_tpu_torch.engine.entropy_o1n import (
    canned_o1n_device_tables,
    rans_o1n_decode_batch,
    rans_o1n_encode_batch,
)
from honours_tpu_torch.engine.huffdec_cuda import decode_tables, huffman_decode
from honours_tpu_torch.engine.vbbe21 import (
    vbbe21_fill_batch,
    vbbe21_parse_batch,
    vbbe21_parts_batch,
)
from honours_tpu_torch.kernels.rans import K_SHARED
from honours_tpu_torch.tables.huffman import na12878_table
from honours_tpu_torch.tables.na12878_freq import canned_freqs
from honours_tpu_torch.tables.o1 import canned_o1_freqs
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

__all__ = [
    "canned_rans_tables", "canned_o1_device_tables",
    "canned_o1n_device_tables", "press_srans_batch", "depress_srans_batch",
    "press_srans2_batch", "depress_srans2_batch", "press_srans3_batch",
    "depress_srans3_batch", "canned_huffman_tables", "press_shuff_batch",
    "depress_shuff_batch", "pad_batch",
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


def pad_batch(signals, L: int = None, *, device):
    """Pack int16 reads into ([B, L] int16, lengths [B] int32) on
    `device`, L (default the longest read) rounded up to a multiple of
    8; zero past each read's length."""
    L = L or max(s.size for s in signals)
    L = -(-L // 8) * 8
    sig = np.zeros((len(signals), L), dtype=np.int16)
    n = np.zeros(len(signals), dtype=np.int32)
    for i, s in enumerate(signals):
        sig[i, : s.size] = s
        n[i] = s.size
    return torch.from_numpy(sig).to(device), torch.from_numpy(n).to(device)


def canned_rans_tables(device) -> dict:
    return make_tables(canned_freqs(), device)


def canned_o1_device_tables(device) -> dict:
    return make_o1_tables(canned_o1_freqs(), device)


def canned_huffman_tables(device) -> dict:
    """The canned NA12878 Huffman table on a device, built once a device:
    lengths and codes [256] int64 (the encode), and kernel C's decode
    tables (engine/huffdec_cuda.py decode_tables)."""
    return _huffman_tables(str(torch.device(device)))


@functools.cache
def _huffman_tables(device: str) -> dict:
    t = na12878_table()
    return {"lengths": torch.as_tensor(t.lengths, dtype=torch.int64,
                                       device=device),
            "codes": torch.as_tensor(t.codes.astype("int64"), device=device),
            **decode_tables(t, device)}


def _press_zd_vbbe21(sig, n, emax, encode_body, hdr: int):
    """[zd0:u16][vbbe21 exception block][entropy body] of sig [B, L]
    int16 (first n[b] valid) -> (stream [B, W] u8, len [B] int64).

    encode_body(data, dlen) gives the body's concat segments and plane
    width; `hdr` is the body's bytes before its plane (states, S).  Rows
    with more than emax exceptions give invalid streams (the runner
    re-encodes them)."""
    B, L = sig.shape
    emax = emax or L
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    parts = vbbe21_parts_batch(rest, n - 1, emax)
    segs_body, planew = encode_body(parts["data"], parts["data_len"])
    two = torch.full((B,), 2, device=sig.device)
    segs = [(u16le_bytes(zd0), two)] + parts["exsegs"] + segs_body
    total = (2 + 4 + (4 + 4 * emax + 1) + (4 + 2 * emax + 1) + 6
             + hdr + planew)
    return rowwise_concat(segs, total)


def _depress_zd_vbbe21(stream, n, L: int, emax, decode_body):
    """Inverse of _press_zd_vbbe21 -> [B, L] int16 (zero past n).
    decode_body(stream, body_off, dlen, N) gives the residual bytes."""
    B = stream.shape[0]
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    zd0 = read_u16le(stream, zero)
    parsed = vbbe21_parse_batch(stream, zero + 2, n - 1, L, emax)
    data = decode_body(stream, parsed["end_off"], n - 1 - parsed["nex"], L)
    vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    return _zd_merge(zd0, vals, n, L)


def press_srans_batch(sig, n, tabs, emax: int = None):
    """Batched srans_vbbe21_zd encode; `tabs` from canned_rans_tables."""
    return _press_zd_vbbe21(
        sig, n, emax, lambda d, dl: rans_encode_batch(d, dl, tabs),
        4 * K_SHARED)


def depress_srans_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched srans_vbbe21_zd decode -> [B, L] int16."""
    return _depress_zd_vbbe21(
        stream, n, L, emax,
        lambda st, off, dl, N: rans_decode_batch(st, off, dl, tabs, N))


def press_srans2_batch(sig, n, tabs, emax: int = None):
    """Batched srans2_vbbe21_zd encode; `tabs` from
    canned_o1_device_tables."""
    return _press_zd_vbbe21(
        sig, n, emax, lambda d, dl: rans_o1_encode_batch(d, dl, tabs),
        4 + 4 * K_SHARED)


def depress_srans2_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched srans2_vbbe21_zd decode -> [B, L] int16."""
    return _depress_zd_vbbe21(
        stream, n, L, emax,
        lambda st, off, dl, N: rans_o1_decode_batch(st, off, dl, tabs, N))


def press_srans3_batch(sig, n, tabs, emax: int = None):
    """Batched srans3_vbbe21_zd encode; `tabs` from
    canned_o1n_device_tables."""
    return _press_zd_vbbe21(
        sig, n, emax, lambda d, dl: rans_o1n_encode_batch(d, dl, tabs),
        4 + 4 * K_SHARED)


def depress_srans3_batch(stream, n, tabs, L: int, emax: int = None):
    """Batched srans3_vbbe21_zd decode -> [B, L] int16."""
    return _depress_zd_vbbe21(
        stream, n, L, emax,
        lambda st, off, dl, N: rans_o1n_decode_batch(st, off, dl, tabs, N))


def press_shuff_batch(sig, n, tabs, emax: int = None,
                      kind: str = "vbbe21"):
    """Batched shuffman_<kind>_zd encode, kind any vb container but vb1e2
    (codecs/huffman.py ShuffmanVbZd); `tabs` from canned_huffman_tables.
    Without emax, the exception buffers are uncapped, as in honours_tpu's
    engine.  As that engine, an empty read keeps its zd0 and its
    dataBytes is 0xFFFFFFFF."""
    from honours_tpu_torch.engine.vb_batch import _exblock_parts  # cycle

    B, L = sig.shape
    emax = emax or L
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    segs, width, data, data_len = _exblock_parts(kind, rest, n - 1, emax)
    blob, blen = shuff_encode_batch(data, data_len, tabs)
    two = torch.full((B,), 2, device=sig.device)
    return rowwise_concat([(u16le_bytes(zd0), two)] + segs + [(blob, blen)],
                          2 + width + blob.shape[1])


def depress_shuff_batch(stream, n, tabs, L: int, emax: int = None,
                        kind: str = "vbbe21"):
    """Batched shuffman_<kind>_zd decode -> [B, L] int16 (the contract of
    honours_tpu's host ShuffmanVbZd.depress).  Each row decodes its
    dataBytes symbols, at most n - 1 - nex (so an empty read's
    0xFFFFFFFF decodes none); ValueError if a row's walk stops short (a
    cut or corrupt stream)."""
    from honours_tpu_torch.engine.rc import vb_zd_fill, vb_zd_parse  # cycle

    zero = torch.zeros((stream.shape[0],), dtype=torch.int64,
                       device=stream.device)
    p = vb_zd_parse(stream, n, kind, L, emax, zero)
    cnt = torch.minimum(read_u32be(stream, p["off"]), p["count"])
    data, got = huffman_decode(
        stream, (p["off"] + 4).clamp(0, stream.shape[1]).to(torch.int32),
        cnt.to(torch.int32), L, tabs)
    if bool((got < cnt).any()):
        raise ValueError("shuffman stream corrupt: a row decoded fewer "
                         "symbols than its dataBytes")
    return vb_zd_fill(p, data, n, L)
