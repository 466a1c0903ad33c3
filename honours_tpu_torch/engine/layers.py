"""`none`, the four byte layers and their 26 compositions.

The counterparts of honours_tpu/codecs/raw.py (none: the samples' raw
<i2 bytes), codecs/generic.py (ByteLayerCodec: zlib, zstd, bzip2 and
fast_lzma2 over those bytes; OuterLayerCodec: <layer>_<inner>),
codecs/exzd.py:124-127 (zlib_ and zstd_hasgam_vbsse21_zdq) and
codecs/flac.py:174 (zstd_flac).  `none` is built and read on the device
(press_none_batch, depress_none_batch).  A layer runs on the host, a
read at a time, by design, as it does in the JAX package: zlib, zstd,
bzip2 and LZMA2 are the reference's vendored host libraries, kept as
comparison baselines, and no device kernel stands behind them.  The
inner codec runs on the device through the runner (its bucket, slices
and exception-cap fallback): the four raw layers compress none's bytes,
a composition its inner codec's stream.  Framing, as the host's:
  over uint and svb inners: layer([nin:u32 LE][inner stream]), and a
    depress whose count is not the read's raises ValueError;
  over vb*_zd, ex-zd and flac inners: layer(inner stream).
Levels: utils/config.py zlib_level (-1, Z_DEFAULT_COMPRESSION),
zstd_level (1), bzip2_level (9) and lzma2_preset (6), each with its
HTPU_* override; LZMA2 is a raw stream with one LZMA2 filter at that
preset; zstd's depress caps its output at max(16, 200 len) bytes.  The
zstd layer needs the `zstandard` package: where it does not import, the
13 zstd codecs raise ModuleNotFoundError naming it.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib

import torch
import torch.nn.functional as F

from honours_tpu_torch.utils.config import get_config

LAYERS = ("zlib", "zstd", "bzip2", "fast_lzma2")


def _zstd(name: str):
    try:
        import zstandard
    except ImportError as e:
        raise ModuleNotFoundError(
            f"{name}: the zstd layer needs the zstandard package: {e}",
            name="zstandard") from e
    return zstandard


def _lzma2_filters():
    return [{"id": lzma.FILTER_LZMA2, "preset": get_config().lzma2_preset}]


def layer_press(layer: str, data: bytes) -> bytes:
    """One layer's compression of `data` at the configured level."""
    cfg = get_config()
    if layer == "zlib":
        return zlib.compress(data, cfg.zlib_level)
    if layer == "zstd":
        return _zstd(layer).ZstdCompressor(level=cfg.zstd_level).compress(
            data)
    if layer == "bzip2":
        return bz2.compress(data, cfg.bzip2_level)
    return lzma.compress(data, format=lzma.FORMAT_RAW,
                         filters=_lzma2_filters())


def layer_depress(layer: str, data: bytes) -> bytes:
    """Inverse of layer_press."""
    if layer == "zlib":
        return zlib.decompress(data)
    if layer == "zstd":
        return _zstd(layer).ZstdDecompressor().decompress(
            data, max_output_size=max(16, len(data) * 200))
    if layer == "bzip2":
        return bz2.decompress(data)
    return lzma.decompress(data, format=lzma.FORMAT_RAW,
                           filters=_lzma2_filters())


def _compositions() -> dict:
    """codec name -> (layer, inner codec, with [nin:u32]), in
    codecs/generic.py's order (press/press.h:133-213, 356-424, 530-598),
    then ex-zd's and flac's."""
    out = {layer: (layer, "none", False) for layer in LAYERS}
    for layer in ("zlib", "zstd"):
        out[f"{layer}_uint_submin"] = (layer, "uint_submin", True)
    for layer in LAYERS:
        out[f"{layer}_uint_zd"] = (layer, "uint_zd", True)
    for layer in ("zlib", "zstd"):
        for inner in ("svb_zd", "svb0124_zd", "svb12_zd"):
            out[f"{layer}_{inner}"] = (layer, inner, True)
    for layer in ("bzip2", "fast_lzma2"):
        out[f"{layer}_svb12_zd"] = (layer, "svb12_zd", True)
    for inner in ("vb1e2_zd", "vbe21_zd", "vbbe21_zd", "vbsbe21_zd",
                  "vbsse21_zd"):
        out[f"zstd_{inner}"] = ("zstd", inner, False)
    for inner in ("vbe21_zd", "vbbe21_zd", "vbsbe21_zd", "vbsse21_zd"):
        out[f"zlib_{inner}"] = ("zlib", inner, False)
    for layer in ("zlib", "zstd"):
        out[f"{layer}_hasgam_vbsse21_zdq"] = (layer, "hasgam_vbsse21_zdq",
                                              False)
    out["zstd_flac"] = ("zstd", "flac", False)
    return out


#: the 30 layer codecs: name -> (layer, inner codec, with [nin:u32])
COMPOSED = _compositions()

#: the host codec's stream of an empty read, where the port's inner
#: engine writes another one (its vb_zd and ex-zd engines keep the JAX
#: engines' empty-read header; codecs/vb.py, codecs/exzd.py)
EMPTY_INNER = {
    **{k: bytes(4) for k in ("vb1e2_zd", "vbe21_zd", "vbbe21_zd",
                             "vbsbe21_zd", "vbsse21_zd")},
    "hasgam_vbsse21_zdq": bytes(14),
}


def wrap(name: str, inner: list, n) -> list:
    """The layer codec `name`'s streams from its inner codec's streams of
    reads of n samples."""
    layer, inner_name, with_nin = COMPOSED[name]
    out = []
    for blob, m in zip(inner, n):
        m = int(m)
        if m == 0:
            blob = EMPTY_INNER.get(inner_name, blob)
        if with_nin:
            blob = struct.pack("<I", m) + blob
        out.append(layer_press(layer, blob))
    return out


def unwrap(name: str, streams: list, n) -> list:
    """Inverse of wrap: the inner codec's streams; ValueError where an
    embedded count is not the read's."""
    layer, _, with_nin = COMPOSED[name]
    out = []
    for blob, m in zip(streams, n):
        inner = layer_depress(layer, blob)
        if with_nin:
            if len(inner) < 4:
                raise ValueError(f"{name}: stream of {len(inner)} bytes "
                                 "holds no sample count")
            (got,) = struct.unpack_from("<I", inner, 0)
            if got != int(m):
                raise ValueError(f"{name}: embedded count {got} != "
                                 f"expected {int(m)}")
            inner = inner[4:]
        out.append(inner)
    return out


def press_none_batch(sig, n):
    """none of [B, L] int16 (first n valid) -> (stream [B, 2L] u8, the
    samples' <i2 bytes; len [B] int64, 2 n)."""
    B, L = sig.shape
    n = n.to(torch.int64).clamp(0, L)
    col = torch.arange(L, device=sig.device)[None, :]
    s = torch.where(col < n[:, None], sig, 0).to(torch.int16).contiguous()
    return s.view(torch.uint8).reshape(B, 2 * L), 2 * n


def depress_none_batch(stream, n, L: int):
    """Inverse of press_none_batch -> [B, L] int16, zero past n."""
    B, M = stream.shape
    n = n.to(torch.int64).clamp(0, L)
    s = F.pad(stream, (0, max(0, 2 * L - M)))[:, : 2 * L].contiguous()
    x = s.view(torch.int16).reshape(B, L)
    col = torch.arange(L, device=stream.device)[None, :]
    return torch.where(col < n[:, None], x, 0)


def layer_engine(name: str, inner_engine, dev):
    """batch_engine's pair for a layer codec from its inner codec's pair:
    the inner engine on the device, the layer on the host a row at a
    time; like every capped engine's, its press leaves rows past the
    exception cap to the runner."""
    press, depress = inner_engine

    def layered_press(sig, n, emax):
        st, sl = press(sig, n, emax)
        st, sl = st.cpu().numpy(), sl.cpu().numpy()
        blobs = wrap(name, [st[i, : sl[i]].tobytes() for i in range(len(sl))],
                     n.cpu().numpy())
        return rows_tensor(blobs, dev)

    def layered_depress(buf, n, L, emax):
        # each layer's decompressor stops at its stream's end, so a row's
        # zero padding is left over
        blobs = unwrap(name, [row.tobytes() for row in buf.cpu().numpy()],
                       n.cpu().numpy())
        return depress(rows_tensor(blobs, dev)[0], n, L, emax)

    return layered_press, layered_depress


def rows_tensor(blobs: list, dev):
    """Byte strings -> (rows [B, W] u8 on dev, zero-padded to a multiple
    of 128 bytes; lengths [B] int64)."""
    W = max(128, -(-max((len(b) for b in blobs), default=0) // 128) * 128)
    buf = torch.zeros((len(blobs), W), dtype=torch.uint8)
    for i, b in enumerate(blobs):
        if b:
            buf[i, : len(b)] = torch.frombuffer(bytearray(b),
                                                dtype=torch.uint8)
    lens = torch.tensor([len(b) for b in blobs], dtype=torch.int64)
    return buf.to(dev), lens.to(dev)
