"""Kernel C: static-Huffman decode (csrc/huffdec.cu), and C2, its entry
with a table for each row (huffman_vb*_zd's), beside their plain
versions.

No TPU kernel stands behind it: honours_tpu decodes shuffman streams on
the host only (honours_tpu/native/huffdec.c ht_huffman_decode, reached
through codecs/huffman.py shuffman_decode_memory).  The wrapper routes by
device: CPU tensors take the plain version, CUDA tensors launch the
kernel: one block a read, each thread a chunk of its stream bits,
chunks made exact by self-synchronisation (csrc/common.cuh htt_chunked,
shared with kernel B; engine/rice_cuda.py THREADS and CHUNK_BITS).
C2 takes each row's table as lengths [B, 256] int32 (-1 for an absent
symbol) and codes [B, 256] int64, codes of 1 to 32 bits
(engine/huffman.py parse_tables_batch); the host decodes those streams
with the same LUT walk (codecs/huffman.py huffman_decode_memory).
"""

from __future__ import annotations

import numpy as np
import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.kernels.huffman import make_decode_lut
from honours_tpu_torch.tables.huffman import HuffmanTable

_DECODE = kernel("huffman_decode", "huffdec.cu", "htt_huffman_decode",
                 "pllpplppppp")
_DECODE_ROWS = kernel("huffman_decode_rows", "huffdec.cu",
                      "htt_huffman_decode_rows", "pllpplppppp")

#: window bits of the full LUT (the longest code a table may have) and of
#: the kernel's first-level table in shared memory (huffdec.cu)
LUT_BITS = 22
L1_BITS = 12

#: bytes the plain version's tables may take at once (about 32 a stream
#: bit, 64 for C2's); rows beyond that decode in further groups of equal
#: size
PLAIN_TABLE_BYTES = 1 << 32
#: the longest code C2 takes
ROW_CODE_BITS = 32


def decode_tables(table: HuffmanTable, device) -> dict:
    """The decode tables of a code of 1 to 22 bits a symbol, on `device`:
      lut [2^22] int16, sym | len << 8 for every 22-bit window (0 where
      no code starts);
      l1 [4096] int32 over 12-bit windows, sym1 | len1 << 8 | sym2 << 16
      | len12 << 24: the window's first code where it has at most 12
      bits (else 0), and the next code where the window holds it whole
      (len12 the two codes' bits, else sym2 = len12 = 0)."""
    if not 1 <= table.max_len <= LUT_BITS:
        raise ValueError(f"code lengths up to {table.max_len} bits: the "
                         f"decode takes 1 to {LUT_BITS}")
    sym, ln = make_decode_lut(table, LUT_BITS)
    lut = sym.astype(np.int16) | (ln.astype(np.int16) << 8)
    w = np.arange(1 << L1_BITS)
    s1, n1 = sym[w].astype(np.int64), ln[w].astype(np.int64)
    one = (n1 >= 1) & (n1 <= L1_BITS)
    # the window's bits after the first code; a second code read from
    # them (zeros above) is the true one when it ends inside the window
    rest = w >> np.where(one, n1, 0)
    n12 = n1 + ln[rest]
    two = one & (ln[rest] >= 1) & (n12 <= L1_BITS)
    l1 = np.where(one, s1 | n1 << 8, 0) | np.where(
        two, sym[rest].astype(np.int64) << 16 | n12 << 24, 0)
    return {"lut": torch.from_numpy(lut).to(device),
            "l1": torch.from_numpy(l1.astype(np.int32)).to(device)}


def huffman_decode_plain(stream, off, count, N: int, tabs):
    """stream [B, M] u8, off [B] (byte where each row's bit stream
    starts), count [B] (symbols to decode, clamped to [0, N]) ->
    (out [B, N] u8, got [B] int32).  LSB-first LUT walk (the contract of
    honours_tpu/native/huffdec.c): bytes at or past M read as 0; the
    walk stops at a window no code starts and at a code that would run
    past the row's last byte.  got is the symbols decoded, out holds
    them and zeros to N.  Vectorised over a group of rows (as many as
    PLAIN_TABLE_BYTES allow): each row's entry at every bit position is
    looked up first, then the code starts by pointer doubling."""
    B, M = stream.shape
    out = torch.zeros((B, N), dtype=torch.uint8, device=stream.device)
    got = torch.zeros((B,), dtype=torch.int32, device=stream.device)
    rows = max(1, PLAIN_TABLE_BYTES // (32 * (8 * M + 32)))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        out[lo:hi], got[lo:hi] = _decode_rows(
            stream[lo:hi], off[lo:hi], count[lo:hi], N, tabs["lut"])
    return out, got


def _row_bytes(stream, start, extra: int):
    """Each row's bytes from `start` on, [B, M + extra] int64, 0 at and
    past M."""
    B, M = stream.shape
    idx = start[:, None] + torch.arange(M + extra, device=stream.device)[
        None, :]
    return torch.where(idx < M, stream.gather(1, idx.clamp(max=M - 1)),
                       0).to(torch.int64)


def _walk(ent, start, cnt, N: int):
    """The LUT walk over ent [B, 8M] (sym | len << 8 of the code at each
    bit from the row's start, 0 where none) -> (out [B, N] u8, got [B]
    int32).  A code that runs past the row's end (limit) stops the walk
    too.  The code starts are the orbit of f(p) = p + the length of the
    code at p from bit 0 (a zero length stops a row where it stands),
    found by doubling (X the first 2^j starts, F = f^2^j)."""
    B, nbits = ent.shape
    dev = ent.device
    steps = int(cnt.max()) if B else 0
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    if steps == 0:
        return out, torch.zeros((B,), dtype=torch.int32, device=dev)
    limit = nbits - 8 * start
    q = torch.arange(nbits, device=dev)[None, :]
    ent = torch.nn.functional.pad(
        torch.where(q + (ent >> 8) <= limit[:, None], ent, 0), (0, 1))
    F = torch.arange(ent.shape[1], device=dev)[None, :] + (
        ent >> 8).to(torch.int64)
    X = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    while X.shape[1] < steps:
        X = torch.cat([X, F.gather(1, X)], dim=1)
        if X.shape[1] < steps:
            F = F.gather(1, F)
    del F
    walk = ent.gather(1, X[:, :steps])
    del X
    stop = walk < (1 << 8)
    first = torch.where(stop.any(1), stop.to(torch.int8).argmax(1), steps)
    got = torch.minimum(first, cnt)
    pos = torch.arange(steps, device=dev)[None, :]
    out[:, :steps] = torch.where(pos < got[:, None], walk & 0xFF,
                                 0).to(torch.uint8)
    return out, got.to(torch.int32)


def _decode_rows(stream, off, count, N: int, lut):
    B, M = stream.shape
    cnt = count.to(torch.int64).clamp(0, N)
    start = off.to(torch.int64).clamp(min=0)
    byts = _row_bytes(stream, start, 3).to(torch.int32)
    w32 = (byts[:, :M] | byts[:, 1:M + 1] << 8 | byts[:, 2:M + 2] << 16
           | byts[:, 3:M + 3] << 24)
    del byts
    # the entry of the 22-bit window at every bit position
    win = (w32[:, :, None] >> torch.arange(8, device=stream.device,
                                           dtype=torch.int32)
           ) & ((1 << LUT_BITS) - 1)
    del w32
    ent = lut[win.reshape(B, 8 * M).to(torch.int64)]
    del win
    return _walk(ent, start.clamp(max=M), cnt, N)


def huffman_decode(stream, off, count, N: int, tabs):
    """Huffman decode of each row's bit stream from byte off -> (out
    [B, N] u8, got [B] int32); `tabs` from decode_tables."""
    if is_cpu(stream, off, count):
        return huffman_decode_plain(stream, off, count, N, tabs)
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
    l1, lut = tabs["l1"], tabs["lut"]
    check(l1, "l1", (torch.int32,), (1 << L1_BITS,))
    check(lut, "lut", (torch.int16,), (1 << LUT_BITS,))
    if l1.data_ptr() % 16:
        raise ValueError("l1: the kernel reads it in 16-byte pieces; it "
                         "must be 16-byte aligned")
    if N < 0:
        raise ValueError(f"N {N} is negative")
    out = torch.empty((B, N), dtype=torch.uint8, device=stream.device)
    got = torch.empty((B,), dtype=torch.int32, device=stream.device)
    _DECODE(stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(), N,
            l1.data_ptr(), lut.data_ptr(), out.data_ptr(), got.data_ptr(),
            stream_ptr(stream.device))
    return out, got


def huffman_decode_rows_plain(stream, off, count, N: int, lengths, codes):
    """Kernel C's contract (huffman_decode_plain) with each row's own
    table: lengths [B, 256] int32 (-1 for an absent symbol), codes [B,
    256] int64, LSB-first.  Entries of length 0 or above ROW_CODE_BITS,
    or with code bits above their length, never match; a table whose
    present symbols all have length 0 decodes count copies of its lowest
    one.  Each row's entry at every bit position is the shortest code
    that matches the 32 bits from there (a search of the row's sorted
    (length, code) keys a length); then kernel C's walk."""
    B, M = stream.shape
    out = torch.zeros((B, N), dtype=torch.uint8, device=stream.device)
    got = torch.zeros((B,), dtype=torch.int32, device=stream.device)
    rows = max(1, PLAIN_TABLE_BYTES // (64 * (8 * M + 32)))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        out[lo:hi], got[lo:hi] = _decode_rows_own(
            stream[lo:hi], off[lo:hi], count[lo:hi], N, lengths[lo:hi],
            codes[lo:hi])
    return out, got


def _decode_rows_own(stream, off, count, N: int, lengths, codes):
    B, M = stream.shape
    dev = stream.device
    cnt = count.to(torch.int64).clamp(0, N)
    start = off.to(torch.int64).clamp(min=0)
    L = lengths.to(torch.int64)
    c = codes.to(torch.int64)
    present = L >= 0
    lone = present.any(1) & ((L == 0) | ~present).all(1)
    ok = (L >= 1) & (L <= ROW_CODE_BITS) & (c >= 0) & (
        (c >> L.clamp(0, ROW_CODE_BITS)) == 0)
    keys, order = torch.sort(torch.where(ok, L << 32 | c, 1 << 62), dim=1)
    byts = _row_bytes(stream, start, 4)
    w40 = (byts[:, :M] | byts[:, 1:M + 1] << 8 | byts[:, 2:M + 2] << 16
           | byts[:, 3:M + 3] << 24 | byts[:, 4:M + 4] << 32)
    del byts
    win = ((w40[:, :, None] >> torch.arange(8, device=dev)) & 0xFFFFFFFF
           ).reshape(B, 8 * M)
    del w40
    ent = torch.zeros((B, 8 * M), dtype=torch.int64, device=dev)
    for ln in torch.unique(L[ok]).tolist():  # shortest first
        k = (ln << 32 | (win & ((1 << ln) - 1))).contiguous()
        i = torch.searchsorted(keys, k).clamp(max=255)
        hit = (keys.gather(1, i) == k) & (ent == 0)
        ent = torch.where(hit, order.gather(1, i) | ln << 8, ent)
    del win
    out, got = _walk(ent, start.clamp(max=M), cnt, N)
    one = torch.argmax(present.to(torch.int8), dim=1)
    fill = lone[:, None] & (torch.arange(N, device=dev)[None, :]
                            < cnt[:, None])
    out = torch.where(lone[:, None], torch.where(fill, one[:, None], 0)
                      .to(torch.uint8), out)
    return out, torch.where(lone, cnt, got).to(torch.int32)


def huffman_decode_rows(stream, off, count, N: int, lengths, codes):
    """C2: huffman_decode with a table for each row -> (out [B, N] u8, got
    [B] int32); lengths [B, 256] int32 (-1 absent), codes [B, 256] int64
    (huffman_decode_rows_plain states the contract)."""
    if is_cpu(stream, off, count, lengths, codes):
        return huffman_decode_rows_plain(stream, off, count, N, lengths,
                                         codes)
    check(stream, "stream", (torch.uint8,))
    if stream.dim() != 2:
        raise ValueError(f"stream: shape {tuple(stream.shape)} is not "
                         "[B, M]")
    B, M = stream.shape
    check(off, "off", (torch.int32,), (B,))
    check(count, "count", (torch.int32,), (B,))
    check(lengths, "lengths", (torch.int32,), (B, 256))
    check(codes, "codes", (torch.int64,), (B, 256))
    if M >= 1 << 28 or N >= 1 << 31:
        raise ValueError(f"[B, M] = {tuple(stream.shape)}, N = {N}: the "
                         "kernel takes M < 2^28 and N < 2^31")
    if N < 0:
        raise ValueError(f"N {N} is negative")
    out = torch.empty((B, N), dtype=torch.uint8, device=stream.device)
    got = torch.empty((B,), dtype=torch.int32, device=stream.device)
    _DECODE_ROWS(stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(),
                 N, lengths.data_ptr(), codes.data_ptr(), out.data_ptr(),
                 got.data_ptr(), stream_ptr(stream.device))
    return out, got
