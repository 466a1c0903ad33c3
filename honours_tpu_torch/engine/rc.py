"""Batched range-coder codecs: rc (order-0), rcc (order-1) and rccm
(context mixing) over the vb exception containers, zd, svb and submin,
and rccdf (static-CDF rANS, engine/rccdf.py) over the vb containers.

The counterparts of honours_tpu/codecs/rc.py's host codecs, whose coder
is honours_tpu/native/rangecoder.c (here kernels D and E,
rangecoder_cuda.py), and, for rccdf, honours_tpu/kernels/rans.py's
per-read rANS (here kernels F and G, rccdf_cuda.py).  Wire formats
(byte for byte the host codec's for every read of n >= 1, and its press
bytes for n = 0):
  <coder>_<vb>_zd    [zd0:u16][<vb> exception block][coder(1-byte data)]
                     (no zd0 for n = 0, as zigdelta of an empty read)
  <coder>_<vb>       [<vb> exception block][coder(1-byte data)], over the
                     raw samples as uint16
  rc_zd              [rc0(the zigzag-deltas as u16 LE bytes)]
  rccm_svb_zd / rccm_svb12_zd
                     [svb_len:u32][rccm(the svb_zd / svb12_zd stream)]
  rccm_vbbe21_submin [min:u16][vbbe21 exception block][rccm(data)] over
                     the samples minus their minimum (uint16)
The exception blocks and their parsers (the raw kinds' vb_parts,
vb_parse and vb_fill among them) are engine/vb_batch.py's; every
codec here runs the rows of a batch through one coder launch, and the
stall codecs (engine/stall_fz.py) put the rows of several branches in
one launch too (encode_groups, decode_groups), so that a bucket's chain
is its longest row's.

Rows with more than emax exceptions give invalid streams (their nex
field, at byte 2 of the _zd and submin kinds and byte 0 of the raw
kinds, is exact either way); the runner presses them alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch.engine.bits import (
    read_u16le,
    read_u32le,
    rowwise_concat,
    u16le_bytes,
    u32le_bytes,
)
from honours_tpu_torch.engine.pipeline import _zd_merge, _zd_parts
from honours_tpu_torch.engine.rangecoder_cuda import rc_decode, rc_encode
from honours_tpu_torch.engine.rccdf import (
    decode_rccdf_batch,
    encode_rccdf_batch,
)
from honours_tpu_torch.engine.svb16 import (
    _interleave2,
    svb16_decode_batch,
    svb16_encode_batch,
)
from honours_tpu_torch.engine.vb_batch import (
    _exblock_parts,
    as_i16,
    depress_svb_zd_batch,
    parse_exblock_batch,
    press_svb_zd_batch,
    vb_fill,
    vb_parse,
    vb_parts,
)
from honours_tpu_torch.engine.vbbe21 import vbbe21_fill_batch
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta

#: coder name -> byte model of rangecoder.py ("cdf": rccdf's per-read
#: static table, engine/rccdf.py)
MODEL = {"rc": "o0", "rcc": "o1", "rccm": "cm", "rccdf": "cdf"}


def coder_rows(kind: str) -> tuple:
    """(byte model, coder rows a bucket row) of a runner kind of this
    module ("rc_vb_zd:<coder>:<vb>", "rc_vb:<coder>:<vb>", "rc_zd",
    "rccm_svb:<inner>", "rc_submin"): one coder row each."""
    family, _, sub = kind.partition(":")
    if family in ("rc_vb_zd", "rc_vb"):
        return MODEL[sub.partition(":")[0]], 1
    return ("o0" if family == "rc_zd" else "cm"), 1


def _zeros(B: int, dev):
    return torch.zeros((B,), dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# one coder launch over the rows of several groups
# ---------------------------------------------------------------------------


def encode_groups(groups, model: str):
    """groups: [(data [b_i, N_i] u8, count [b_i])] -> [(blob [b_i, W] u8,
    blob_len [b_i])], every row coded by one rc_encode launch."""
    N = max(d.shape[1] for d, _ in groups)
    data = torch.cat([F.pad(d, (0, N - d.shape[1])) for d, _ in groups])
    cnt = torch.cat([c.to(torch.int64) for _, c in groups]).clamp(min=0)
    out, length = rc_encode(data, cnt.to(torch.int32), model)
    sizes = [d.shape[0] for d, _ in groups]
    return list(zip(out.split(sizes), length.split(sizes)))


def decode_groups(groups, N: int, model: str):
    """groups: [(stream [b_i, M_i] u8, off [b_i], count [b_i])] -> [data
    [b_i, N] u8], every row decoded by one rc_decode launch."""
    M = max(s.shape[1] for s, _, _ in groups)
    stream = torch.cat([F.pad(s, (0, M - s.shape[1])) for s, _, _ in groups])
    off = torch.cat([o.to(torch.int64) for _, o, _ in groups]).clamp(0, M)
    cnt = torch.cat([c.to(torch.int64) for _, _, c in groups]).clamp(0, N)
    data = rc_decode(stream, off.to(torch.int32), cnt.to(torch.int32), N,
                     model)
    return list(data.split([s.shape[0] for s, _, _ in groups]))


def assemble(parts, coded):
    """A codec's stream from its head segments (parts[0], width
    parts[1]) and its coder blob -> (stream [B, M] u8, len [B])."""
    segs, width = parts[0], parts[1]
    blob, blob_len = coded
    return rowwise_concat(segs + [(blob, blob_len)], width + blob.shape[1])


# ---------------------------------------------------------------------------
# the codecs' parts before the coder: (head segments, head width, data
# [B, L] u8, data count [B])
# ---------------------------------------------------------------------------


def vb_zd_parts(sig, n, kind: str, emax: int):
    """[zd0:u16][<kind> block] over zd[1:] and its residual bytes."""
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    segs, width, data, data_len = _exblock_parts(kind, rest, n - 1, emax)
    hdr = (u16le_bytes(zd0), torch.where(n > 0, 2, 0))
    return [hdr] + segs, 2 + width, data, data_len.clamp(min=0)


def submin_parts(sig, n, emax: int):
    """[min:u16][vbbe21 block] over the samples minus their minimum."""
    L = sig.shape[1]
    n = n.to(torch.int64)
    u = sig.to(torch.int64) & 0xFFFF
    valid = torch.arange(L, device=sig.device)[None, :] < n[:, None]
    mn = torch.where(n > 0, torch.where(valid, u, 0xFFFF).min(dim=1).values,
                     0)
    v = torch.where(valid, (u - mn[:, None]) & 0xFFFF, 0)
    segs, width, data, data_len = _exblock_parts("vbbe21", v, n, emax)
    two = torch.full_like(n, 2)
    return [(u16le_bytes(mn), two)] + segs, 2 + width, data, data_len


# ---------------------------------------------------------------------------
# the codecs' parses before the coder: {off, count} of the coder stream
# and what the fill needs; fills after it
# ---------------------------------------------------------------------------


def vb_zd_parse(stream, n, kind: str, L: int, emax: int, base):
    n = n.to(torch.int64)
    parsed = parse_exblock_batch(kind, stream, base + 2, n - 1, L, emax)
    return {"zd0": read_u16le(stream, base), "parsed": parsed,
            "off": parsed["end_off"],
            "count": (n - 1 - parsed["nex"]).clamp(0, L)}


def vb_zd_fill(p, data, n, L: int):
    n = n.to(torch.int64)
    vals = vbbe21_fill_batch(p["parsed"], data, n - 1, L)
    return _zd_merge(p["zd0"], vals, n, L)


def submin_parse(stream, n, L: int, emax: int, base):
    p = vb_parse(stream, n, "vbbe21", L, emax, base + 2)
    p["min"] = read_u16le(stream, base)
    return p


def submin_fill(p, data, n, L: int):
    n = n.to(torch.int64)
    v = vbbe21_fill_batch(p["parsed"], data, n, L).to(torch.int64)
    live = torch.arange(L, device=data.device)[None, :] < n[:, None]
    return as_i16(torch.where(live, v + p["min"][:, None], 0))


# ---------------------------------------------------------------------------
# the batched codecs: press(sig [B, L] int16, n, emax) -> (stream [B, M]
# u8, len [B]); depress(stream, n, L, emax) -> [B, L] int16, zero past n
# ---------------------------------------------------------------------------


def press_rc_vb_zd_batch(sig, n, coder: str, kind: str, emax: int = None):
    """<coder>_<kind>_zd (rc.py RcVbZdCodec)."""
    parts = vb_zd_parts(sig, n, kind, emax or sig.shape[1])
    if coder == "rccdf":
        body, width = encode_rccdf_batch(parts[2], parts[3])
        return rowwise_concat(parts[0] + body, parts[1] + width)
    (coded,) = encode_groups([(parts[2], parts[3])], MODEL[coder])
    return assemble(parts, coded)


def depress_rc_vb_zd_batch(stream, n, coder: str, kind: str, L: int,
                           emax: int = None):
    p = vb_zd_parse(stream, n, kind, L, emax,
                    _zeros(stream.shape[0], stream.device))
    if coder == "rccdf":
        data = decode_rccdf_batch(stream, p["off"], p["count"], L)
    else:
        (data,) = decode_groups([(stream, p["off"], p["count"])], L,
                                MODEL[coder])
    return vb_zd_fill(p, data, n, L)


def press_rc_vb_batch(sig, n, coder: str, kind: str, emax: int = None):
    """<coder>_<kind> on raw uint16 (rc.py RcVbCodec)."""
    parts = vb_parts(sig, n, kind, emax or sig.shape[1])
    (coded,) = encode_groups([(parts[2], parts[3])], MODEL[coder])
    return assemble(parts, coded)


def depress_rc_vb_batch(stream, n, coder: str, kind: str, L: int,
                        emax: int = None):
    p = vb_parse(stream, n, kind, L, emax,
                 _zeros(stream.shape[0], stream.device))
    (data,) = decode_groups([(stream, p["off"], p["count"])], L,
                            MODEL[coder])
    return vb_fill(p, data, n, L)


def press_rc_submin_batch(sig, n, emax: int = None):
    """rccm_vbbe21_submin (rc.py RccmVbbe21SubminCodec)."""
    parts = submin_parts(sig, n, emax or sig.shape[1])
    (coded,) = encode_groups([(parts[2], parts[3])], "cm")
    return assemble(parts, coded)


def depress_rc_submin_batch(stream, n, L: int, emax: int = None):
    p = submin_parse(stream, n, L, emax,
                     _zeros(stream.shape[0], stream.device))
    (data,) = decode_groups([(stream, p["off"], p["count"])], L, "cm")
    return submin_fill(p, data, n, L)


def press_rc_zd_batch(sig, n):
    """rc_zd: rc0 over the zigzag-deltas' u16 LE bytes (rc.py
    RcZdCodec)."""
    zd = zigdelta(sig)
    raw = _interleave2((zd & 0xFF).to(torch.uint8),
                       (zd >> 8).to(torch.uint8))
    (coded,) = encode_groups([(raw, 2 * n.to(torch.int64))], "o0")
    return coded


def depress_rc_zd_batch(stream, n, L: int):
    B = stream.shape[0]
    n = n.to(torch.int64)
    (raw,) = decode_groups([(stream, _zeros(B, stream.device), 2 * n)],
                           2 * L, "o0")
    raw = raw.to(torch.int64)
    zd = raw[:, 0::2] | (raw[:, 1::2] << 8)
    live = torch.arange(L, device=stream.device)[None, :] < n[:, None]
    return torch.where(live, unzigdelta(torch.where(live, zd, 0)), 0).to(
        torch.int16)


def _svb_width(L: int) -> int:
    """Columns that hold an svb_zd or svb12_zd stream of L samples (svb32
    takes at most 4L + L/4 bytes, svb16 2L + L/8 + 1)."""
    return 4 * L + (L + 3) // 4 + 16


def press_rccm_svb_batch(sig, n, inner: str):
    """rccm_svb_zd (inner "svb32", the svb_zd stream) / rccm_svb12_zd
    (inner "svb16", the svb12_zd stream) (rc.py RccmSvbZdCodec)."""
    if inner == "svb32":
        svb, svb_len = press_svb_zd_batch(sig, n, "1234")
    else:
        svb, svb_len = svb16_encode_batch(sig, n, zd=True)
    svb_len = svb_len.to(torch.int64)
    (coded,) = encode_groups([(svb, svb_len)], "cm")
    four = torch.full_like(svb_len, 4)
    return assemble(([(u32le_bytes(svb_len), four)], 4), coded)


def depress_rccm_svb_batch(stream, n, L: int, inner: str):
    B = stream.shape[0]
    W = _svb_width(L)
    svb_len = read_u32le(stream, _zeros(B, stream.device))
    (svb,) = decode_groups([(stream, torch.full_like(svb_len, 4),
                             svb_len)], W, "cm")
    if inner == "svb32":
        return depress_svb_zd_batch(svb, n, L, "1234")
    return svb16_decode_batch(svb, n, L, zd=True)
