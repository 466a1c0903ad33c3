"""The arithmetic and tables of the rANS walks' kernels (kernels 3, 4,
4b and 8) and kernel 6's tiling, checked on the CPU against their
definitions (tolerance 0): the encode walk's division by a reciprocal,
the decode walks' lookup tables and the nibble walk's count against a
search of the CDF for every slot, the walks' reads per block, and the
svb16 decode's tiles and look-back scratch."""

import numpy as np
import pytest
import torch

from honours_tpu_torch.engine import rans_encode_cuda as E
from honours_tpu_torch.engine import rans_n4_cuda as N4
from honours_tpu_torch.engine import rans_o1_cuda as O
from honours_tpu_torch.engine import svb16_cuda as SV
from honours_tpu_torch.kernels.rans import M
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

F_BLOCKS = 8  # f in [1, M] split into cases of M / F_BLOCKS


@pytest.mark.parametrize("block", range(F_BLOCKS))
def test_reciprocal_division_is_exact(block):
    """x // f by the reciprocal table, for every f in [1, M], at the
    edges of quotients (q*f - 1, q*f, q*f + f - 1 for quotients spread
    over the range), at 2^23 and 2^31 - 1 and on a seeded sample of x
    below 2^31 (what a valid table keeps the state below)."""
    rcp = E.reciprocals()
    f = np.arange(block * M // F_BLOCKS + 1, (block + 1) * M // F_BLOCKS + 1,
                  dtype=np.uint64)[:, None]
    top = (np.uint64(2**31 - 1) // f)
    frac = np.linspace(0, 1, 41)[None, :]
    q = np.maximum((top * frac).astype(np.uint64), 1)
    edges = np.concatenate([q * f - 1, q * f, q * f + f - 1], axis=1)
    rng = np.random.default_rng(block)
    sample = rng.integers(0, 2**31, (f.shape[0], 64), dtype=np.uint64)
    fixed = np.array([[0, 1, 2**23, 2**31 - 1]], np.uint64)
    x = np.concatenate([edges, sample, np.repeat(fixed, f.shape[0], 0)], 1)
    x = np.minimum(x, np.uint64(2**31 - 1))
    ff = np.broadcast_to(f, x.shape)
    got = E.div_by_reciprocal(x, ff.astype(np.int64), rcp)
    assert np.array_equal(got, x // ff)
    assert np.array_equal(x - got * ff, x % ff)


def test_reciprocal_table_shape():
    rcp = E.reciprocals()
    assert rcp.shape == (E.RCP_WORDS,) and rcp.dtype == np.uint32
    assert rcp[0] == rcp[1] == 0 and (rcp[2:M + 1] >= 2**31).all()
    assert not rcp[M + 1:].any()


def _o1_freqs(kind):
    """[257, 256] order-1 frequency tables."""
    from honours_tpu_torch.kernels.rans import normalize_freqs
    from honours_tpu_torch.tables.o1 import canned_o1_freqs

    rng = np.random.default_rng(5)
    if kind == "canned":
        return canned_o1_freqs()
    if kind == "one_cluster":
        return np.tile(normalize_freqs(rng.integers(1, 100, 256)), (257, 1))
    # symbols 20-59 and 96-255 never occur; one symbol holds most of M
    live = np.zeros(256, bool)
    live[:20] = live[60:96] = True
    rows = [normalize_freqs(rng.integers(1, 50, 256) * live
                            + (np.arange(256) == 7) * 40_000 * (i % 2))
            for i in range(6)]
    return np.stack([rows[c % 6] for c in range(257)])


def _fitted_tables():
    """A drans table fitted on the device path from a seeded histogram."""
    from honours_tpu_torch.engine.drans import fit_tables_device
    from honours_tpu_torch.tables.drans import NB

    rng = np.random.default_rng(9)
    counts = rng.integers(0, 400, (NB, 256)) * (rng.random((NB, 256)) < 0.3)
    return fit_tables_device(torch.from_numpy(counts))


@pytest.mark.parametrize("kind", ["canned", "one_cluster", "zero_runs",
                                  "fitted"])
def test_o1_lookup_tables_match_cdf_search(kind):
    """The order-1 walk's tables (the plain version of its prep kernel)
    give, for every context and every slot, the symbol s with
    cum[s] <= slot < cum[s + 1] and its (c, f): zero-frequency symbols
    are never chosen, however long their runs."""
    from honours_tpu_torch.engine.entropy_o1 import make_o1_tables

    cpu = torch.device("cpu")
    tabs = (_fitted_tables() if kind == "fitted"
            else make_o1_tables(_o1_freqs(kind), cpu))
    cum, cmap = tabs["cum"], tabs["cmap"]
    r = cum.shape[0]
    tables = O.o1_tables_plain(cmap, cum)
    assert tables.shape == (O.o1_layout_bytes(r),)
    ctx = torch.arange(257)[:, None].expand(257, M).reshape(-1)
    slot = torch.arange(M).expand(257, M).reshape(-1)
    sym, c, f = O.lookup_plain(tables, r, ctx, slot)
    rows = cum.to(torch.int64)[cmap.to(torch.int64)[ctx]]
    want = torch.searchsorted(rows, slot[:, None], right=True)[:, 0] - 1
    assert torch.equal(sym, want)
    lo = rows.gather(1, want[:, None])[:, 0]
    assert torch.equal(c, lo)
    assert torch.equal(f, rows.gather(1, want[:, None] + 1)[:, 0] - lo)
    assert (f > 0).all()


@pytest.mark.parametrize("kind", ["canned", "zero_runs"])
def test_o0_lookup_table_matches_cdf_search(kind):
    from honours_tpu_torch.engine.pipeline import canned_rans_tables

    cum = (canned_rans_tables(torch.device("cpu"))["cum"] if kind == "canned"
           else torch.from_numpy(np.concatenate(
               [[0], np.cumsum(_o1_freqs("zero_runs")[0])])).to(torch.int32))
    words = O.o0_tables_plain(cum)
    slot = torch.arange(M)
    want = torch.searchsorted(cum.to(torch.int64), slot, right=True) - 1
    c = words & 4095
    assert torch.equal(words >> 24, want)
    assert torch.equal(c, cum[want].to(torch.int64))
    hi = cum[want + 1].to(torch.int64)
    assert torch.equal(((words >> 12) & 4095) + 1, hi)


@pytest.mark.parametrize("B,sms,want", [
    (0, 132, 1), (1, 132, 1), (132, 132, 1), (133, 132, 2), (256, 132, 2),
    (1056, 132, 8), (5000, 132, 8), (256, 114, 3),
])
def test_walk_reads_per_block(B, sms, want):
    """Enough reads a block that the batch fits in one block per SM, so
    each SM copies the walk's tables once, and never more than the
    kernels' MAX_RPB."""
    assert O.walk_reads_per_block(B, sms) == want


def _nibble_tables(kind):
    """Nibble tables (tables.o1n.build_nibble_tables): "canned"; "one"
    (r = rL = 1); "spiked" (8 rows, each one symbol holding nearly all of
    M, so L rows have cells of 1); "r64" (64 random rows, rL = 64)."""
    from honours_tpu_torch.engine.entropy_o1n import make_o1n_tables
    from honours_tpu_torch.kernels.rans import normalize_freqs
    from honours_tpu_torch.tables.o1n import (
        build_nibble_tables,
        canned_nibble_tables,
    )

    rng = np.random.default_rng(8)
    if kind == "canned":
        nib = canned_nibble_tables()
    elif kind == "one":
        row = normalize_freqs(rng.integers(1, 1000, 256))
        nib = build_nibble_tables(np.tile(row, (257, 1)), r_lo=1)
    elif kind == "spiked":
        rows = [normalize_freqs(np.ones(256) + (np.arange(256) == 37 * i + 5)
                                * 1e6) for i in range(8)]
        nib = build_nibble_tables(np.stack([rows[c % 8] for c in range(257)]))
    else:
        rows = [normalize_freqs(rng.integers(1, 1000, 256) ** 3 % 5000 + 1)
                for _ in range(64)]
        nib = build_nibble_tables(np.stack([rows[c % 64] for c in range(257)]))
    return nib, make_o1n_tables(nib, torch.device("cpu"))


@pytest.mark.parametrize("kind", ["canned", "one", "spiked", "r64"])
def test_n4_tables_match_cdf_search(kind):
    """The nibble walk's tables (the plain version of its prep kernel)
    give, for every H and L row and every slot, by the kernel's count
    over packed 13-bit fields, the symbol s with cum[s] <= slot <
    cum[s + 1] and its (c, f); H words carry the row's lo row, and the
    next-row table each context's H row."""
    nib, t = _nibble_tables(kind)
    H, L = np.asarray(nib["H"]), np.asarray(nib["L"])
    r, rL = H.shape[0], L.shape[0]
    if kind == "spiked":
        assert (L == 1).any()
    tables = N4.n4_tables_plain(t["cmap"], t["lo_assign"], t["fcH"], t["fcL"])
    assert tables.shape == (N4.n4_layout_bytes(r, rL),)
    words = tables.numpy().view("<u4")
    rows = words[:(r + rL) * N4.ROWB // 4].reshape(r + rL, N4.ROWB // 4)
    f = np.concatenate([H, L])
    cum = np.concatenate([np.zeros((r + rL, 1), np.int64),
                          np.cumsum(f, 1)], 1)
    slot = np.arange(M)
    sym = N4.rank16_np(rows[:, None, :8], slot[None, :]).astype(np.int64)
    want = np.stack([np.searchsorted(c, slot, side="right") - 1 for c in cum])
    assert np.array_equal(sym, want)
    w = np.take_along_axis(rows[:, 8:24], sym, 1).astype(np.int64)
    assert np.array_equal(w & 0xFFF, np.take_along_axis(cum, want, 1))
    assert np.array_equal(w >> 19, np.take_along_axis(f, want, 1))
    gl = np.asarray(nib["lo_assign"]).reshape(r, 16)
    assert np.array_equal((rows[:r, 8:24] >> 12) & 63, gl)
    assert not ((rows[r:, 8:24] >> 12) & 63).any() and not rows[:, 24:].any()
    nxt = words[(r + rL) * N4.ROWB // 4:]
    assert nxt.shape == (N4.NEXT,)
    assert np.array_equal(nxt[:257], np.asarray(nib["cmap"]) * N4.ROWB)
    assert not nxt[257:].any()


@pytest.mark.parametrize("seed", range(4))
def test_rank16_recipe_matches_search(seed):
    """The count by packed subtracts on monotone rows of cum[1..15],
    zero-frequency runs and cum values at 0 and M included (the 16th
    field 0x1FFF as the kernel stores it): the largest s with
    cum[s] <= slot, for every slot."""
    rng = np.random.default_rng(seed)
    cut = np.sort(rng.integers(0, M + 1, (64, 15)), 1)
    cut[:8, :] = 0
    cut[8:16, 7:] = M
    cut[16:24, 1::2] = cut[16:24, :-1:2]
    cum = np.concatenate([np.zeros((64, 1), np.int64), cut,
                          np.full((64, 1), M)], 1)
    fields = cum[:, 1:].copy()
    fields[:, 15] = 0x1FFF
    pairs = (fields[:, 0::2] | (fields[:, 1::2] << 14)).astype(np.uint32)
    slot = np.arange(M)
    got = N4.rank16_np(pairs[:, None, :], slot[None, :])
    want = np.stack([np.searchsorted(c, slot, side="right") - 1 for c in cum])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("L,tiles", [
    (0, 0), (8, 1), (SV.DECODE_TILE - 1, 1), (SV.DECODE_TILE, 1),
    (SV.DECODE_TILE + 1, 2), (65536, 32), (1 << 18, 128),
    ((1 << 21) + 5, 1025),
])
def test_svb16_decode_tiles(L, tiles):
    """A decode row takes one tile per DECODE_TILE samples; a launch's
    look-back scratch holds a state per tile and the ticket, and none
    when rows are one tile."""
    assert SV.decode_tiles(L) == tiles
    for B in (1, 3, 256):
        want = B * tiles + 1 if tiles > 1 else 0
        assert SV.decode_scratch_words(B, L) == want


def test_svb16_decode_scratch_limit():
    with pytest.raises(ValueError):
        SV.decode_scratch_words(1 << 20, SV.DECODE_TILE * 2048)
