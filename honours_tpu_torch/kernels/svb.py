"""Classical 32-bit Stream-VByte ("1234"), numpy, host: the integer
coder of the stock BLOW5 svb-zd signal codec (io/blow5.py).

Wire format [key section][data section]: 2-bit codes = nbytes-1, 4 codes
per key byte LSB-first, key section ceil(n/4) bytes, then each value's
low nbytes little-endian bytes (reference:
press/streamvbyte/src/streamvbyte_encode.c:36-60).  A copy of
honours_tpu's kernels/svb.py svb32 half.
"""

from __future__ import annotations

import numpy as np

__all__ = ["svb32_encode", "svb32_decode"]


def _pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    n = codes.size
    keylen = (n + 3) // 4
    p = np.zeros(keylen * 4, dtype=np.uint8)
    p[:n] = codes
    p = p.reshape(-1, 4)
    return (p[:, 0] | (p[:, 1] << 2) | (p[:, 2] << 4) | (p[:, 3] << 6)).astype(
        np.uint8
    )


def _unpack_codes_2bit(keys: np.ndarray, n: int) -> np.ndarray:
    codes = np.zeros(keys.size * 4, dtype=np.uint8)
    codes[0::4] = keys & 3
    codes[1::4] = (keys >> 2) & 3
    codes[2::4] = (keys >> 4) & 3
    codes[3::4] = (keys >> 6) & 3
    return codes[:n]


def _scatter_le_bytes(v: np.ndarray, nbytes: np.ndarray) -> np.ndarray:
    """Emit the low `nbytes[i]` little-endian bytes of each v[i]."""
    ends = np.cumsum(nbytes)
    offs = ends - nbytes
    data = np.zeros(int(ends[-1]) if ends.size else 0, dtype=np.uint8)
    for k in range(4):
        m = nbytes > k
        if not m.any():
            break
        data[offs[m] + k] = ((v[m] >> (8 * k)) & 0xFF).astype(np.uint8)
    return data


def svb32_encode(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.uint32)
    n = v.size
    if n == 0:
        return b""
    nbytes = np.ones(n, dtype=np.int64)
    nbytes[v >= (1 << 8)] = 2
    nbytes[v >= (1 << 16)] = 3
    nbytes[v >= (1 << 24)] = 4
    keys = _pack_codes_2bit((nbytes - 1).astype(np.uint8))
    return keys.tobytes() + _scatter_le_bytes(v, nbytes).tobytes()


def svb32_decode(buf, n: int) -> tuple:
    """Returns (values u32, bytes consumed)."""
    if n == 0:
        return np.zeros(0, dtype=np.uint32), 0
    buf = np.frombuffer(buf, dtype=np.uint8)
    keylen = (n + 3) // 4
    nbytes = _unpack_codes_2bit(buf[:keylen], n).astype(np.int64) + 1
    ends = np.cumsum(nbytes)
    offs = ends - nbytes
    total = int(ends[-1])
    data = buf[keylen : keylen + total]
    v = data[offs].astype(np.uint32)
    for k in range(1, 4):
        m = nbytes > k
        if not m.any():
            break
        v[m] |= data[offs[m] + k].astype(np.uint32) << (8 * k)
    return v, keylen + total
