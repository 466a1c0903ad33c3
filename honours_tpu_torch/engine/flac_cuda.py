"""Kernel N: the flac decode (csrc/flac.cu), beside its plain version
flac_decode_plain.

No TPU kernel stands behind it: honours_tpu decodes flac on the host
only (honours_tpu/codecs/flac.py FlacCodec.depress).  A flac block's
size does not follow from its header (its Rice codes end where the walk
of its blen - order codes ends), so a read's blocks are a walk; the
kernel splits each block's Rice codes across a block of threads (the
chunked decode of csrc/common.cuh).  The wrapper routes by device: CPU
tensors take the plain version, CUDA tensors launch the kernel, a block
of threads a read, every read of a bucket in one launch.
"""

from __future__ import annotations

import functools
import math

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.bits import bytes_at

_DECODE = kernel("flac_decode", "flac.cu", "htt_flac_decode", "pllplpp")

#: samples a block (the last block of a read is shorter)
BLOCK = 4096
#: the mode byte of a verbatim block
VERBATIM = 15
MAX_ORDER = 4
MAX_K = 30
#: bytes of the first window of a block's Rice bits in the plain
#: version: a block the press codes with a predictor is smaller than its
#: verbatim form, 1 + 2 blen bytes, so its Rice bits fit
WINDOW = 2 * BLOCK + 16


def _codes(byte, s, k, cnt, W: int):
    """Up to BLOCK Rice codes of each row from byte s [B] on, k [B] <=
    MAX_K, cnt [B] codes, its bits read from a window of W bytes (zeros
    past it) -> (z [B, BLOCK] int64, zeros past cnt; end [B], the bit
    after the last code, counted from bit 0 of byte s, or any bit past
    the window once the walk enters the zeros that follow the row's end;
    exact [B]: the walk stayed inside the window).  The code starts by
    pointer doubling: f(p) = next_zero(p) + 1 + k from bit 0, X the first
    2^j starts, F = f^2^j."""
    B = s.shape[0]
    dev = s.device
    T = 8 * W + 64
    i = torch.arange(W, device=dev)[None, :]
    byts = byte(s[:, None] + i)
    bits = ((byts[:, :, None] >> torch.arange(8, device=dev)) & 1).reshape(
        B, 8 * W)
    bits = torch.nn.functional.pad(bits, (0, 64))
    pos = torch.arange(T, device=dev).expand(B, T)
    nz = torch.where(bits == 0, pos, T).flip(1).cummin(dim=1).values.flip(1)
    clamp = 8 * W + 32  # inside the 64 zero bits past the window
    F = (nz + 1 + k[:, None]).clamp(max=clamp)
    steps = int(cnt.max()) if B else 0
    X = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    while X.shape[1] < steps + 1:
        X = torch.cat([X, F.gather(1, X)], dim=1)
        if X.shape[1] < steps + 1:
            F = F.gather(1, F)
    X = X[:, : steps + 1]
    end = X.gather(1, cnt[:, None])[:, 0]
    X = X[:, :steps]
    t = nz.gather(1, X)
    v = torch.zeros_like(t)
    for j in range(MAX_K):
        bj = bits.gather(1, (t + 1 + j).clamp(max=T - 1))
        v |= torch.where(j < k[:, None], bj << j, 0)
    z = ((t - X) << k[:, None]) | v
    z = torch.nn.functional.pad(z, (0, BLOCK - steps))
    live = torch.arange(BLOCK, device=dev)[None, :] < cnt[:, None]
    return torch.where(live, z, 0), end, end <= 8 * W


def flac_decode_plain(stream, n, L: int):
    """Kernel N's plain version.  stream [B, M] u8 (each row's flac
    stream from byte 0), n [B] (clamped to [0, L]) -> [B, L] int16, zeros
    past n; see csrc/flac.cu for the walk's rules on cut and malformed
    streams.  A step over every row a block: the verbatim samples, the
    Rice codes of a window of the block's bits (_codes; a row whose walk
    leaves the window decodes again from a window of the rest of its
    row), then the integration from the warm-up."""
    B, M = stream.shape
    dev = stream.device
    n = n.to(torch.int64).clamp(0, L)
    byte = functools.partial(bytes_at, stream)

    def u16(p):
        return byte(p) | (byte(p + 1) << 8)
    out = torch.zeros((B, L), dtype=torch.int16, device=dev)
    hdr = torch.zeros((B,), dtype=torch.int64, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    i = torch.arange(BLOCK, device=dev)[None, :]
    blocks = -(-int(n.max()) // BLOCK) if B else 0
    for blk in range(blocks):
        blen = (n - blk * BLOCK).clamp(0, BLOCK)
        act = alive & (blen > 0)
        mode, k = byte(hdr), byte(hdr + 1)
        verb = act & (mode == VERBATIM)
        rice = act & (mode <= MAX_ORDER) & (mode < blen) & (k <= MAX_K)
        alive &= verb | rice | ~act
        order = torch.where(rice, mode, 0)
        k = torch.where(rice, k, 0)
        cnt = torch.where(rice, blen - order, 0)
        s = hdr + 2 + 2 * order
        z, end, exact = _codes(byte, s, k, cnt, WINDOW)
        redo = rice & ~exact & (s + WINDOW < M)
        if bool(redo.any()):
            W = int((M - s[redo]).max().clamp(min=0)) + 8
            z2, end2, _ = _codes(byte, s, k, cnt, W)
            z = torch.where(redo[:, None], z2, z)
            end = torch.where(redo, end2, end)
        at = hdr[:, None] + 2 * i
        x = _integrate(z, order, u16(at[:, :MAX_ORDER] + 2))
        x = torch.where(verb[:, None], u16(at + 1), x) & 0xFFFF
        x = (x - ((x & 0x8000) << 1)).to(torch.int16)
        keep = (verb | rice)[:, None] & (i < blen[:, None])
        w = min(BLOCK, L - blk * BLOCK)
        out[:, blk * BLOCK: blk * BLOCK + w] = torch.where(keep, x, 0)[:, :w]
        hdr = torch.where(verb, hdr + 1 + 2 * blen,
                          torch.where(rice, s + (end + 7) // 8, hdr))
    return out


def _integrate(z, order, warm):
    """A block's samples from its zigzagged order-o residuals z [B,
    BLOCK] (residual i at column i), order [B] and warm-up [B, MAX_ORDER]
    (int64, the low 16 bits count): honours_tpu/codecs/flac.py's
    integration, D^o = [D^o[0], D^o[0] + cumsum(D^{o+1})] for o = order -
    1 .. 0, D^o[0] the o-th difference of the warm-up, column j holding
    D^o at index j - o."""
    dev = z.device
    j = torch.arange(BLOCK, device=dev)[None, :]
    r = (z >> 1) ^ -(z & 1)
    D = torch.where(j >= order[:, None],
                    r.gather(1, (j - order[:, None]).clamp(min=0)), 0)
    for o in range(MAX_ORDER - 1, -1, -1):
        first = warm[:, 0] * 0
        for m in range(o + 1):  # the o-th difference of warm at 0
            first = first + (-1) ** (o - m) * math.comb(o, m) * warm[:, m]
        cs = torch.cumsum(torch.where(j > o, D, 0), dim=1)
        D = torch.where((order > o)[:, None],
                        torch.where(j >= o, first[:, None] + cs, 0), D)
    return D


def flac_decode(stream, n, L: int):
    """Every read's samples from its flac stream -> [B, L] int16; see
    flac_decode_plain."""
    if is_cpu(stream, n):
        return flac_decode_plain(stream, n, L)
    check(stream, "stream", (torch.uint8,))
    if stream.dim() != 2:
        raise ValueError(f"stream: shape {tuple(stream.shape)} is not "
                         "[B, M]")
    B, M = stream.shape
    check(n, "n", (torch.int32,), (B,))
    if L < 0:
        raise ValueError(f"L {L} is negative")
    out = torch.empty((B, L), dtype=torch.int16, device=stream.device)
    _DECODE(stream.data_ptr(), B, M, n.data_ptr(), L, out.data_ptr(),
            stream_ptr(stream.device))
    return out
