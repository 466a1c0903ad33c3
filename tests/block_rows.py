"""Reads and streams for turbopfor, flac and kernels M (the segment-header
walk) and N (the flac decode), shared by the CPU tests and the GPU
tests: numpy only, made from seeds."""

import numpy as np

#: the lengths around turbopfor's 128-value and flac's 4,096-sample blocks
EDGE_LENGTHS = [0, 1, 2, 3, 4, 5, 127, 128, 129, 4095, 4096, 4097, 8193]


def walk(rng, n: int, step: int = 40, base: int = 300) -> np.ndarray:
    return (np.cumsum(rng.integers(-step, step + 1, n)) + base).astype(
        np.int16)


def spike_read(n: int = 4096, at: int = 2000, height: int = 20000):
    """A flat block with one spike: flac codes it with a predictor and a
    small k, so the spike's residuals are unary runs of thousands of
    ones."""
    x = np.zeros(n, np.int16)
    x[at] = height
    return x


def wide_exceptions_read(seed: int = 5) -> np.ndarray:
    """Blocks of flat samples with a few jumps of +-32,767: turbopfor
    takes b = 0, and their exceptions' high parts are 16 bits wide."""
    rng = np.random.default_rng(seed)
    x = np.full(3 * 128 + 17, 100, np.int16)
    for a in rng.choice(x.size - 1, 6, replace=False):
        x[a] = 32767 if a % 2 else -32767
    return x


def block_reads(seed: int) -> list:
    """Every edge length as a random walk, full-range random samples
    (flac's verbatim blocks, turbopfor's b = 16), the spike, the wide
    exceptions, a ramp, a constant read, walks of several steps and a
    read of varied blocks (noise, flat, walk, spike) over 3 flac
    blocks."""
    rng = np.random.default_rng(seed)
    reads = [walk(rng, n) for n in EDGE_LENGTHS]
    mixed = np.concatenate([
        rng.integers(-32768, 32768, 4096), np.full(4096, -5),
        walk(rng, 3000, 3), spike_read(1500, 700, -31000)]).astype(np.int16)
    reads += [
        rng.integers(-32768, 32768, 5000).astype(np.int16),
        spike_read(), spike_read(4096, 0, 30000),
        wide_exceptions_read(seed),
        np.arange(-3000, 3000, 1, dtype=np.int16),
        np.full(700, -123, np.int16),
        walk(rng, 6000, 1), walk(rng, 9000, 400, 0),
        walk(rng, 2000, 4000, 0), mixed,
    ]
    return reads


def pad_rows(reads, L: int = None, align: int = 1):
    """Reads -> (sig [B, L] int16 zero-padded, n [B] int32)."""
    L = L or max(align, max(r.size for r in reads))
    L = -(-L // align) * align
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    return sig, np.array([r.size for r in reads], np.int32)


def stream_rows(streams, extra: int = 0):
    """Byte strings -> [B, M] u8 zero-padded, M the longest plus extra."""
    M = max(1, max(len(s) for s in streams) + extra)
    buf = np.zeros((len(streams), M), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    return buf


def hdrwalk_np(row: np.ndarray, first: int, nseg: int, counts, fmt):
    """Kernel M a row at a time: the offsets of a row's segments (bytes
    outside the row read as 0, negative counts as 0), then the end."""
    H, ib, ie, E = fmt

    def byte(p):
        return int(row[p]) if 0 <= p < row.size else 0

    out, off = [], first
    nseg = min(max(nseg, 0), len(counts))
    for s in range(len(counts)):
        out.append(off)
        if s < nseg:
            c = max(int(counts[s]), 0)
            off += H + (c * byte(off + ib) + 7) // 8 + E * byte(off + ie)
    return out


def flac_decode_np(row: np.ndarray, n: int, L: int) -> np.ndarray:
    """Kernel N a row at a time: honours_tpu/codecs/flac.py's depress with
    bytes past the row read as 0, a bit at a time, and its walk ending at
    a header the press never writes (mode 5-14, order >= blen, k > 30),
    the samples from there on 0; every sample mod 2^16."""
    out = np.zeros(L, np.int16)

    def byte(p):
        return int(row[p]) if 0 <= p < row.size else 0

    def bit(p):
        return (byte(p >> 3) >> (p & 7)) & 1

    off = pos = 0
    while pos < n:
        blen = min(4096, n - pos)
        mode = byte(off)
        if mode == 15:
            for j in range(blen):
                v = byte(off + 1 + 2 * j) | (byte(off + 2 + 2 * j) << 8)
                out[pos + j] = v - 0x10000 if v & 0x8000 else v
            off += 1 + 2 * blen
            pos += blen
            continue
        k = byte(off + 1)
        if mode > 4 or mode >= blen or k > 30:
            break
        x = [byte(off + 2 + 2 * j) | (byte(off + 3 + 2 * j) << 8)
             for j in range(mode)]
        p = 8 * (off + 2 + 2 * mode)
        start = p
        coef = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                4: [4, -6, 4, -1]}[mode]
        for _ in range(blen - mode):
            q = 0
            while bit(p):
                q += 1
                p += 1
            p += 1
            v = 0
            for j in range(k):
                v |= bit(p + j) << j
            p += k
            z = (q << k) | v
            r = (z >> 1) ^ -(z & 1)
            x.append((r + sum(c * x[-1 - i] for i, c in enumerate(coef)))
                     & 0xFFFF)
        out[pos: pos + blen] = np.array(x, np.uint16).view(np.int16)
        off = (p - start + 7) // 8 + start // 8
        pos += blen
    return out


def rice_bytes(z, k: int) -> bytes:
    """flac's Rice codes of z (q = z >> k ones, a zero, the k low bits,
    all LSB-first), padded to a byte."""
    z = np.asarray(z, np.uint64)
    q = (z >> np.uint64(k)).astype(np.int64)
    lens = q + 1 + k
    starts = np.cumsum(lens) - lens
    bits = np.zeros((int(lens.sum()) + 7) // 8 * 8, np.uint8)
    run = np.arange(int(q.sum())) - np.repeat(np.cumsum(q) - q, q)
    bits[np.repeat(starts, q) + run] = 1
    for j in range(k):
        bits[starts + q + 1 + j] = (z >> np.uint64(j)) & np.uint64(1)
    return np.packbits(bits, bitorder="little").tobytes()


def flac_block(order: int, k: int, warm, z) -> bytes:
    """A predictor block: [order][k][warm-up i16 LE][Rice codes of z]."""
    return (bytes([order, k]) + np.asarray(warm, "<i2").tobytes()
            + rice_bytes(z, k))


def flac_edge_rows(seed: int):
    """(streams, n, valid) of hand-made flac streams at kernel N's edges:
    k = 0 (unary codes only) and k = 30 (31-bit codes, nearly a tile);
    order = blen - 1 on a short last block; a valid block followed by a
    mode and by a k the press never writes; Rice regions that end on a
    chunk edge (15,360 bits, a multiple of N's 64-bit chunks and of B's
    and C's 256), on a tile edge of N (32,768 bits) and of B and C
    (131,072), on the kernel's first tile's reach (k + 3 bits a code and
    1,024 bits) and past it, each followed by a block.  valid: the host
    codec decodes the stream."""
    rng = np.random.default_rng(seed)
    full = flac_block(2, 3, [10, -20], rng.integers(0, 40, 4094))
    q = np.zeros(4096, np.int64)
    q[rng.choice(4096, 3072, replace=False)] = 1  # 3,072 + 3 x 4,096 bits
    chunk = flac_block(0, 2, [], (q << 2) | rng.integers(0, 4, 4096))
    q = np.full(4096, 2)
    q[:1024] += 1  # 9,216 ones + 4,096 zeros: 4,096 x 3 + 1,024 bits
    rows = [
        (flac_block(0, 0, [], rng.integers(0, 6, 4096)), 4096, True),
        (flac_block(1, 30, [1234], rng.integers(0, 1 << 31, 4095)), 4096,
         True),
        (full + flac_block(4, 5, [1, 2, 3, -4], [77]), 4096 + 5, True),
        (full + bytes([9, 2, 1, 2, 3]), 8192, False),
        (full + bytes([2, 31, 1, 2, 3, 4]), 8192, False),
        (chunk + full, 8192, True),
        (flac_block(0, 0, [], np.full(4096, 7)) + full, 8192, True),
        (flac_block(0, 0, [], np.full(4096, 31)) + full, 8192, True),
        (flac_block(0, 0, [], q) + full, 8192, True),
        (flac_block(0, 0, [], np.full(4096, 3)) + full, 8192, True),
    ]
    return ([r[0] for r in rows], np.array([r[1] for r in rows], np.int32),
            [r[2] for r in rows])
