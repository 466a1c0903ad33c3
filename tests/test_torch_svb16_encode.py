"""Kernel 5's tiling and its write partition, checked on the CPU (torch
and numpy only, tolerance 0): the tiles and look-back scratch of an
encode launch, and `encode_tile_ranges`, which gives every byte of an
encoded row one writing tile.  Its ranges must be disjoint, cover the row
exactly once, and, filled with each tile's own key bytes, fields and
zeros, rebuild `svb16_encode_plain`'s row."""

import numpy as np
import pytest
import torch

from honours_tpu_torch.engine import svb16_cuda as SV
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

T = SV.ENCODE_TILE


@pytest.mark.parametrize("L,tiles", [
    (0, 1), (8, 1), (T - 8, 1), (T, 1), (T + 8, 2), (4104, 3),
    (65536, 32), (1 << 18, 128),
])
def test_encode_tiles(L, tiles):
    """An encode row takes one tile per ENCODE_TILE samples (one when
    L = 0, to write the lengths); the scratch holds a state per tile and
    the ticket, and nothing when rows are one tile."""
    assert SV.encode_tiles(L) == tiles
    for B in (1, 3, 256):
        want = B * tiles + 1 if tiles > 1 else 0
        assert SV.encode_scratch_words(B, L) == want


def test_encode_scratch_limit():
    assert SV.encode_scratch_words((1 << 31) // 2048 - 1, T * 2048) > 0
    with pytest.raises(ValueError):
        SV.encode_scratch_words(1 << 20, T * 2048)
    with pytest.raises(ValueError):
        SV.encode_scratch_words(1 << 31, 8)


def _values(sig, n, zd):
    """The uint16 values the stream codes (zigzag deltas or raw), zero
    from n on."""
    u = sig.astype(np.int64) & 0xFFFF
    if zd:
        d = (u - np.concatenate([[0], u[:-1]])) & 0xFFFF
        u = ((d << 1) ^ -(d >> 15)) & 0xFFFF
    return np.where(np.arange(sig.size) < n, u, 0)


def _tile_bytes(v, t0, nt):
    """Tile-local bytes: the key bytes of samples [t0, t0 + nt), and
    their fields as one span."""
    two = v[t0:t0 + nt] >= 256
    pad = np.zeros(-(-nt // 8) * 8, bool)
    pad[:nt] = two
    keys = np.packbits(pad.reshape(-1, 8), axis=1, bitorder="little")[:, 0]
    fields = []
    for x, b in zip(v[t0:t0 + nt], two):
        fields += [x & 0xFF, x >> 8] if b else [x & 0xFF]
    return keys.astype(np.uint8), np.array(fields, np.uint8)


def _row(kind, L, n, seed, zd):
    rng = np.random.default_rng(seed)
    if kind == "one_byte":
        sig = rng.integers(0, 100 if zd else 256, L)
    elif kind == "two_byte":
        big = np.where(rng.random(L) < 0.5, 1, -1) * rng.integers(300, 30000, L)
        sig = np.cumsum(big) if zd else rng.integers(256, 65536, L)
    else:
        sig = rng.integers(0, 200, L)
        sig[rng.random(L) < 0.1] += 2000
    sig = sig.astype(np.uint16).view(np.int16)
    sig[n:] = 0
    return sig


N_CASES = [0, 1, 7, 8, T - 1, T, T + 1, 4104]


@pytest.mark.parametrize("zd", [True, False], ids=["zd", "raw"])
@pytest.mark.parametrize("kind", ["one_byte", "two_byte", "mixed"])
@pytest.mark.parametrize("n", N_CASES)
def test_encode_partition_rebuilds_the_row(n, kind, zd):
    """L = 4104: W = 8721 is odd, three tiles, the last one of 8 samples.
    Every byte of [0, W) has exactly one writer, and the row built from
    the tiles' own bytes equals the plain encoder's."""
    L = 4104
    W = SV.stream_width(L)
    sig = _row(kind, L, n, n * 7 + len(kind) + zd, zd)
    v = _values(sig, n, zd)
    tiles = SV.encode_tiles(L)
    counts = [int((v[t * T:(t + 1) * T] >= 256).sum()) for t in range(tiles)]
    if kind != "mixed":
        assert sum(counts) == (n if kind == "two_byte" else 0)
    ranges = SV.encode_tile_ranges(n, L, counts)
    assert len(ranges) == tiles
    writers = np.zeros(W, np.int64)
    row = np.full(W, 0xA5, np.uint8)
    kl = -(-n // 8)
    for t, rs in enumerate(ranges):
        t0 = t * T
        nt = max(0, min(n - t0, T))
        keys, fields = _tile_bytes(v, t0, nt)
        for lo, hi, what in rs:
            assert 0 <= lo < hi <= W
            writers[lo:hi] += 1
            if what == "key":
                assert (lo, hi - lo) == (t0 // 8, keys.size)
                row[lo:hi] = keys
            elif what == "field":
                assert hi - lo == fields.size and lo >= kl
                row[lo:hi] = fields
            else:
                row[lo:hi] = 0
    assert (writers == 1).all()
    want, length = SV.svb16_encode_plain(
        torch.from_numpy(sig[None]), torch.tensor([n], dtype=torch.int32), zd)
    assert np.array_equal(row, want[0].numpy())
    assert int(length[0]) == kl + n + sum(counts)


@pytest.mark.parametrize("L", [8, T, T + 8, 3 * T])
def test_encode_partition_random_rows(L):
    """Random n and mixed rows at one, two and three tiles: one writer a
    byte, and every live tile writes 2 nt bytes of fields and zeros."""
    rng = np.random.default_rng(L)
    W = SV.stream_width(L)
    for _ in range(20):
        n = int(rng.integers(0, L + 1))
        v = _values(_row("mixed", L, n, int(rng.integers(1 << 30)), True), n,
                    True)
        counts = [int((v[t * T:(t + 1) * T] >= 256).sum())
                  for t in range(SV.encode_tiles(L))]
        writers = np.zeros(W, np.int64)
        top = -(-n // 8) + 2 * n
        for t, rs in enumerate(SV.encode_tile_ranges(n, L, counts)):
            nt = max(0, min(n - t * T, T))
            assert sum(hi - lo for lo, hi, what in rs
                       if what != "key" and hi <= top) == 2 * nt
            for lo, hi, _ in rs:
                writers[lo:hi] += 1
        assert (writers == 1).all()
