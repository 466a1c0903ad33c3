"""Kernel B: Golomb-Rice decode (csrc/rice.cu), beside its plain version.

No TPU kernel stands behind it: honours_tpu decodes rice streams on the
host only (honours_tpu/codecs/rice.py rice_decode).  The wrapper routes
by device: CPU tensors take the plain version, CUDA tensors launch the
kernel: one block of THREADS a read, each thread a chunk of CHUNK_BITS
stream bits, chunks made exact by self-synchronisation (csrc/common.cuh
htt_chunked).
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr

_DECODE = kernel("rice_decode", "rice.cu", "htt_rice_decode", "pllpplpp")

#: threads of the block that decodes a row and stream bits of a thread's
#: chunk, in kernels B and C alike (csrc/common.cuh htt_chunked)
THREADS = 512
CHUNK_BITS = 256


#: bytes the plain version's bit tables may take at once (about 32 a
#: stream bit); rows beyond that decode in further groups of equal size
PLAIN_TABLE_BYTES = 1 << 32


def rice_decode_plain(stream, off, count, N: int):
    """stream [B, M] u8, off [B] (byte where each row's rice stream
    starts), count [B] (values to decode, clamped to [0, N]) -> [B, N]
    u8: each value the low 8 bits of (q << k) | bits, zeros past count.
    Bytes at or past M read as 0.  Vectorised over a group of rows (as
    many as PLAIN_TABLE_BYTES allow): tables of each row's bits, then
    every row's code starts by pointer doubling."""
    B, M = stream.shape
    out = torch.zeros((B, N), dtype=torch.uint8, device=stream.device)
    groups = -(-B // max(1, PLAIN_TABLE_BYTES // (32 * (8 * M + 64))))
    rows = max(1, -(-B // max(groups, 1)))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        out[lo:hi] = _decode_rows(stream[lo:hi], off[lo:hi],
                                  count[lo:hi], N)
    return out


def _decode_rows(stream, off, count, N: int):
    B, M = stream.shape
    dev = stream.device
    cnt = count.to(torch.int64).clamp(0, N)
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    steps = int(cnt.max())
    if steps == 0:
        return out
    # LSB-first bits of each row from its byte off on; from bit 8 * M on
    # every bit is 0
    W = 8 * M + 64
    idx = off.to(torch.int64).clamp(min=0)[:, None] + torch.arange(
        W // 8, device=dev)[None, :]
    byts = torch.where(idx < M, stream.gather(1, idx.clamp(max=M - 1)), 0)
    del idx
    bits = ((byts[:, :, None] >> torch.arange(
        8, device=dev, dtype=torch.uint8)) & 1).reshape(B, W)
    del byts
    k = ((bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]).to(torch.int64)
    # the first zero bit at or after each position
    pos = torch.arange(W, device=dev, dtype=torch.int32).expand(B, W)
    zero_at = torch.where(bits == 0, pos, W).flip(1)
    next_zero = zero_at.cummin(dim=1).values.flip(1)
    del zero_at
    # the k bits at each position, MSB-first
    vk = torch.zeros((B, W), dtype=torch.int32, device=dev)
    k32 = k.to(torch.int32)[:, None]
    for j in range(7):
        bj = torch.nn.functional.pad(bits[:, j:], (0, j)).to(torch.int32)
        vk |= torch.where(j < k32, bj << (k32 - 1 - j).clamp(min=0), 0)
    del bits
    last = 8 * M + 32  # any position from 8 * M on reads zeros alike
    # a code starting at p ends at its zero bit t = next_zero[p], and the
    # next starts at f(p) = t + 1 + k: the code starts are the orbit of
    # f from bit 3, found by doubling (X the first 2^j starts, F = f^2^j)
    nz = next_zero.to(torch.int64)
    del next_zero
    F = (nz + 1 + k[:, None]).clamp(max=last)
    X = torch.full((B, 1), 3, dtype=torch.int64, device=dev)
    while X.shape[1] < steps:
        X = torch.cat([X, F.gather(1, X)], dim=1)
        if X.shape[1] < steps:
            F = F.gather(1, F)
    del F
    X = X[:, :steps]
    t = nz.gather(1, X)
    v = ((t - X) << k[:, None]) | vk.gather(1, t + 1)
    i = torch.arange(steps, device=dev)[None, :]
    out[:, :steps] = torch.where(i < cnt[:, None], v & 0xFF, 0).to(
        torch.uint8)
    return out


def rice_decode(stream, off, count, N: int):
    """Rice decode of each row's stream from byte off -> [B, N] u8."""
    if is_cpu(stream, off, count):
        return rice_decode_plain(stream, off, count, N)
    check(stream, "stream", (torch.uint8,))
    if stream.dim() != 2:
        raise ValueError(f"stream: shape {tuple(stream.shape)} is not "
                         "[B, M]")
    B, M = stream.shape
    check(off, "off", (torch.int32,), (B,))
    check(count, "count", (torch.int32,), (B,))
    if M >= 1 << 28 or N >= 1 << 31:
        raise ValueError(f"[B, M] = {tuple(stream.shape)}, N = {N}: the "
                         "kernel takes M < 2^28 and N < 2^31")
    if N < 0:
        raise ValueError(f"N {N} is negative")
    out = torch.empty((B, N), dtype=torch.uint8, device=stream.device)
    _DECODE(stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(), N,
            out.data_ptr(), stream_ptr(stream.device))
    return out
