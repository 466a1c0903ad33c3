"""SLOW5/BLOW5 file reading and writing for the port.

The same reader and writer as honours_tpu's io/blow5.py, byte for byte,
with the port's runner in place of a per-read codec: signals compressed
with any ported codec are decoded together through
engine.runner.depress_signals (one call per file, so drans keeps the
encoder's grouping), and the writer embeds streams the runner already
pressed.

  fixed header:
    [magic  "BLOW5\\x01" : 6B]
    [version major/minor/patch : 3 x u8]
    [record compression : u8]    0=none 1=zlib 2=zstd
    [num read groups : u32 LE]
    [signal compression : u8]    0=none 1=svb-zd  (version >= 0.2.0)
    ... zero padding to byte offset 64 ...
    [ascii header size : u32 LE][ascii header]
  each record:
    [record size : u64 LE][record payload, record-compressed]
  record payload:
    [read_id_len : u16][read_id][read_group : u32]
    [digitisation, offset, range, sampling_rate : 4 x f64]
    [len_raw_signal : u64][raw signal bytes][auxiliary bytes]

Signal codecs: none (int16 LE), svb-zd ([count:u32][svb32 of the int32
zigzag-delta]) and SIGNAL_PRESS_HTPU, the extension that names a codec
in an "@htpu_signal_codec\\t<name>" header line; its signal blob is
[nin:u32][stream].  zstd record compression needs the `zstandard`
package, imported only for files that use it.
"""

from __future__ import annotations

import io as _pyio
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from honours_tpu_torch.kernels.svb import svb32_decode, svb32_encode

MAGIC = b"BLOW5\x01"
HDR_SIZE_OFFSET = 64

RECORD_PRESS_NONE = 0
RECORD_PRESS_ZLIB = 1
RECORD_PRESS_ZSTD = 2

SIGNAL_PRESS_NONE = 0
SIGNAL_PRESS_SVB_ZD = 1
SIGNAL_PRESS_HTPU = 0xF0

_CODEC_TAG = b"@htpu_signal_codec\t"


@dataclass
class Blow5Read:
    """One SLOW5 record's primary fields."""

    read_id: str
    read_group: int
    digitisation: float
    offset: float
    range: float
    sampling_rate: float
    signal: np.ndarray  # int16 (None when read with decode_signal=False)
    aux: bytes = b""  # raw trailing auxiliary bytes (opaque, preserved)
    signal_stream: bytes = None  # raw codec stream (decode_signal=False)
    signal_len: int = 0  # sample count for signal_stream


@dataclass
class Blow5File:
    version: tuple = (0, 2, 0)
    record_press: int = RECORD_PRESS_ZLIB
    signal_press: int = SIGNAL_PRESS_SVB_ZD
    num_read_groups: int = 1
    header: bytes = b""
    reads: list = field(default_factory=list)


def _zigzag_encode32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int32)
    return ((x << 1) ^ (x >> 31)).astype(np.uint32)


def _zigzag_decode32(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    return ((z >> 1) ^ (-(z & 1)).astype(np.uint32)).astype(np.int32)


def signal_svb_zd_encode(signal: np.ndarray) -> bytes:
    """slow5 svb-zd signal codec: [count u32][svb32 of int32 zigzag-delta]."""
    x = np.ascontiguousarray(signal, dtype=np.int16).astype(np.int32)
    prev = np.concatenate([[np.int32(0)], x[:-1]])
    diff = _zigzag_encode32(x - prev)
    return struct.pack("<I", x.size) + svb32_encode(diff)


def signal_svb_zd_decode(buf: bytes) -> np.ndarray:
    (count,) = struct.unpack_from("<I", buf, 0)
    diff, _used = svb32_decode(buf[4:], count)
    deltas = _zigzag_decode32(diff)
    return np.cumsum(deltas, dtype=np.int32).astype(np.int16)


def _decompress_record(payload: bytes, method: int) -> bytes:
    if method == RECORD_PRESS_NONE:
        return payload
    if method == RECORD_PRESS_ZLIB:
        return zlib.decompress(payload)
    if method == RECORD_PRESS_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(payload)
    raise ValueError(f"unknown record compression method {method}")


def _compress_record(payload: bytes, method: int) -> bytes:
    if method == RECORD_PRESS_NONE:
        return payload
    if method == RECORD_PRESS_ZLIB:
        return zlib.compress(payload, 6)
    if method == RECORD_PRESS_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=1).compress(payload)
    raise ValueError(f"unknown record compression method {method}")


def parse_record(payload: bytes, signal_press: int) -> Blow5Read:
    """One decompressed record.  An HTPU signal is left as its stream
    (read.signal_stream, read.signal_len) for the runner to decode."""
    off = 0
    (rid_len,) = struct.unpack_from("<H", payload, off)
    off += 2
    read_id = payload[off: off + rid_len].decode()
    off += rid_len
    read_group, digitisation, offset_, range_, sampling_rate, len_raw = (
        struct.unpack_from("<IddddQ", payload, off))
    off += 4 + 8 * 4 + 8
    signal, signal_stream, signal_len = None, None, 0
    if signal_press == SIGNAL_PRESS_NONE:
        nbytes = int(len_raw) * 2
        signal = np.frombuffer(payload[off: off + nbytes], dtype="<i2").copy()
    elif signal_press == SIGNAL_PRESS_SVB_ZD:
        nbytes = int(len_raw)
        signal = signal_svb_zd_decode(payload[off: off + nbytes])
    elif signal_press == SIGNAL_PRESS_HTPU:
        nbytes = int(len_raw)
        blob = payload[off: off + nbytes]
        (signal_len,) = struct.unpack_from("<I", blob, 0)
        signal_stream = blob[4:]
    else:
        raise ValueError(f"unhandled signal compression {signal_press}")
    off += nbytes
    return Blow5Read(
        read_id=read_id, read_group=read_group, digitisation=digitisation,
        offset=offset_, range=range_, sampling_rate=sampling_rate,
        signal=signal, aux=payload[off:], signal_stream=signal_stream,
        signal_len=int(signal_len))


def build_record(read: Blow5Read, signal_press: int,
                 pressed: bytes = None) -> bytes:
    """One record payload; an HTPU signal embeds `pressed`, the read's
    stream from the runner."""
    rid = read.read_id.encode()
    head = struct.pack("<H", len(rid)) + rid
    meta = struct.pack("<Idddd", read.read_group, read.digitisation,
                       read.offset, read.range, read.sampling_rate)
    if signal_press == SIGNAL_PRESS_NONE:
        sig = np.ascontiguousarray(read.signal, dtype="<i2").tobytes()
        length = read.signal.size
    elif signal_press == SIGNAL_PRESS_SVB_ZD:
        sig = signal_svb_zd_encode(read.signal)
        length = len(sig)
    elif signal_press == SIGNAL_PRESS_HTPU:
        if pressed is None:
            raise ValueError("an HTPU signal needs its pressed stream")
        sig = struct.pack("<I", np.asarray(read.signal).size) + pressed
        length = len(sig)
    else:
        raise ValueError(f"unhandled signal compression {signal_press}")
    return head + meta + struct.pack("<Q", length) + sig + read.aux


def htpu_codec_name(header: bytes):
    for line in header.split(b"\n"):
        if line.startswith(_CODEC_TAG):
            return line.split(b"\t", 1)[1].decode().strip()
    return None


def read_blow5(path: str, decode_signal: bool = True,
               device="cuda") -> Blow5File:
    """Parse a BLOW5 file.  Signals compressed with a ported codec are
    decoded on `device` by one engine.runner.depress_signals call over
    the whole file; decode_signal=False leaves them as streams
    (read.signal_stream / read.signal_len)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != MAGIC:
        raise ValueError("not a BLOW5 file (bad magic)")
    major, minor, patch = data[6], data[7], data[8]
    record_press = data[9]
    (num_rg,) = struct.unpack_from("<I", data, 10)
    signal_press = data[14] if (major, minor) >= (0, 2) else SIGNAL_PRESS_NONE
    (hdr_size,) = struct.unpack_from("<I", data, HDR_SIZE_OFFSET)
    off = HDR_SIZE_OFFSET + 4
    header = data[off: off + hdr_size]
    off += hdr_size

    out = Blow5File(version=(major, minor, patch), record_press=record_press,
                    signal_press=signal_press, num_read_groups=num_rg,
                    header=header)
    name = None
    if signal_press == SIGNAL_PRESS_HTPU:
        name = htpu_codec_name(header)
        if name is None:
            raise ValueError("htpu signal compression but no "
                             "@htpu_signal_codec")
    n = len(data)
    while off + 8 <= n:
        (rec_size,) = struct.unpack_from("<Q", data, off)
        off += 8
        payload = _decompress_record(data[off: off + rec_size], record_press)
        off += rec_size
        out.reads.append(parse_record(payload, signal_press))
    if name is not None and decode_signal and out.reads:
        from honours_tpu_torch.engine.runner import depress_signals

        sigs = depress_signals([r.signal_stream for r in out.reads],
                               [r.signal_len for r in out.reads], name,
                               device=device)
        for r, s in zip(out.reads, sigs):
            r.signal = np.asarray(s, dtype=np.int16)
            r.signal_stream = None
    return out


def write_blow5(path: str, f5: Blow5File, signal_codec: str = None,
                signal_streams: list = None) -> None:
    """Write a BLOW5 file.  With `signal_codec` (a ported codec's name,
    stored as the @htpu_signal_codec header line) the signals are
    `signal_streams`, one per read, as engine.runner.press_signals gave
    them; otherwise f5.signal_press codes f5's signals."""
    if signal_codec is not None:
        from honours_tpu_torch.engine.runner import engine_kind

        engine_kind(signal_codec)  # NotImplementedError if unknown
        if signal_streams is None or len(signal_streams) != len(f5.reads):
            raise ValueError("signal_codec needs one pressed stream per read")
        f5.signal_press = SIGNAL_PRESS_HTPU
        if htpu_codec_name(f5.header) != signal_codec:
            lines = [ln for ln in f5.header.split(b"\n")
                     if not ln.startswith(_CODEC_TAG)]
            lines.insert(1 if lines else 0,
                         _CODEC_TAG + signal_codec.encode())
            f5.header = b"\n".join(lines)
    buf = _pyio.BytesIO()
    buf.write(MAGIC)
    buf.write(bytes(f5.version))
    buf.write(bytes([f5.record_press]))
    buf.write(struct.pack("<I", f5.num_read_groups))
    buf.write(bytes([f5.signal_press]))
    buf.write(b"\x00" * (HDR_SIZE_OFFSET - buf.tell()))
    buf.write(struct.pack("<I", len(f5.header)))
    buf.write(f5.header)
    for i, read in enumerate(f5.reads):
        pressed = signal_streams[i] if signal_streams is not None else None
        payload = _compress_record(
            build_record(read, f5.signal_press, pressed), f5.record_press)
        buf.write(struct.pack("<Q", len(payload)))
        buf.write(payload)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
