"""Batched drans_vbbe21_zd (format v5): self-contained dynamic order-1 rANS.

Stream: [G:u16][zd0:u16][vbbe21 exception block][S:u32][K states:u32]
[shared body].  Lane-grid steps t < ceil(S/4) are coded with the canned
o1 table; a bucketed histogram of those prefix symbols, over the whole
batch, is fitted identically by encoder and decoder (tables/drans.py)
and codes the remaining steps.  The batch is the compression unit: G is
the number of the group's streams with a non-empty body, and a decode
whose own count disagrees raises ValueError instead of returning
garbage.  Byte-exact with honours_tpu's engine and host codec over the
same grouping.
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bits import (
    read_u16le,
    read_u32le,
    rowwise_concat,
    u16le_bytes,
)
from honours_tpu_torch.engine.entropy_o1 import (
    _lane_grid,
    _o1_fc,
    _rd_states,
    _ungrid,
    cdiv,
    encode_from_fc,
)
from honours_tpu_torch.engine.permute import monotone_expand
from honours_tpu_torch.engine.pipeline import _zd_merge, _zd_parts
from honours_tpu_torch.engine.rans_o1_cuda import o1_decode
from honours_tpu_torch.engine.vbbe21 import (
    vbbe21_fill_batch,
    vbbe21_parse_batch,
    vbbe21_parts_batch,
    wrap_i32,
)
from honours_tpu_torch.kernels.rans import CTX0, K_SHARED, M
from honours_tpu_torch.tables.drans import (
    NB,
    PREFIX_DEN,
    W_FIT,
    base_rows,
    bucket_of,
)

# ---------------------------------------------------------------------------
# table fit (bit-identical to tables.drans.fit_freqs)
# ---------------------------------------------------------------------------


def _dnorm_rows(e):
    """[NB, 256] int64 count rows -> rows summing to M, row by row equal
    to tables.drans.dnorm.  The remainder key embeds the symbol index,
    so it is unique and the sort needs no stability."""
    present = (e > 0).to(torch.int64)
    npres = present.sum(dim=1, keepdim=True)
    tot = e.sum(dim=1, keepdim=True)
    s = (tot >> 17) + 1
    e = torch.maximum(e // s, present)
    tot = e.sum(dim=1, keepdim=True)
    t = M - npres
    q = (e * t) // tot
    rem = e * t - q * tot
    f = q + present
    diff = M - f.sum(dim=1, keepdim=True)
    key = rem * 256 + (255 - torch.arange(256, device=e.device))[None, :]
    order = torch.argsort(-key, dim=1)
    rank = torch.argsort(order, dim=1)
    return f + (rank < diff).to(torch.int64)


def fit_tables_device(counts) -> dict:
    """[NB, 256] prefix counts -> engine tables on the counts' device.
    The clusters are the NB bucket rows themselves (cmap = bucket_of),
    so every (f, c) equals make_o1_tables(fit_freqs(counts))."""
    dev = counts.device
    base = torch.tensor(base_rows(), device=dev)
    rows = _dnorm_rows(counts.to(torch.int64) * W_FIT + base)
    cum = torch.nn.functional.pad(torch.cumsum(rows, dim=1), (1, 0))
    cmap = bucket_of(torch.arange(CTX0 + 1, device=dev))
    return {
        "cmap": cmap.to(torch.int32),
        "fc": (rows + cum[:, :256] * 8192).to(torch.int32),
        "cum": cum.to(torch.int32),
    }


def o1_prefix_hist(g3, ctx3, act3, T0_b):
    """Exact [NB, 256] histogram of (bucket(ctx), sym) over lane-grid
    positions t < T0_b that are active.  g3/ctx3 [B, K, T], act3 bool."""
    t = torch.arange(g3.shape[2], device=g3.device)[None, None, :]
    mask = act3 & (t < T0_b.to(torch.int64)[:, None, None])
    idx = bucket_of(ctx3.to(torch.int64)) * 256 + g3.to(torch.int64)
    counts = torch.bincount(idx[mask], minlength=NB * 256)
    return counts.reshape(NB, 256)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def press_drans_batch(sig, n, tabs_canned, emax: int = None, member=None):
    """Batched drans_vbbe21_zd encode of sig [B, L] int16 (first n[b]
    valid) -> (stream [B, W] u8, len [B] int64).

    `tabs_canned` from pipeline.canned_o1_device_tables.  Rows with more
    than emax exceptions give invalid streams and are left out of the
    shared fit and of G (the runner re-encodes them).  `member` [B] bool
    restricts the fit and G to a sub-group; other rows still give
    (discardable) streams."""
    B, L = sig.shape
    emax = emax or L
    K = K_SHARED
    dev = sig.device
    n = n.to(torch.int64)
    zd0, rest = _zd_parts(sig, n)
    parts = vbbe21_parts_batch(rest, n - 1, emax)
    Smax = -(-L // K)
    g3, ctx3, act3, S_b = _lane_grid(parts["data"], parts["data_len"], K,
                                     Smax)
    T0_b = cdiv(S_b, PREFIX_DEN)
    include = parts["nex"] <= emax
    if member is not None:
        include = include & member
    counts = o1_prefix_hist(g3, ctx3, act3 & include[:, None, None], T0_b)
    tabs_fit = fit_tables_device(counts)
    G = ((S_b > 0) & include).sum()

    g = g3.reshape(B, -1).to(torch.int32)
    c_ = ctx3.reshape(B, -1)
    fca = _o1_fc(g, c_, tabs_canned).reshape(B, K, Smax)
    fcb = _o1_fc(g, c_, tabs_fit).reshape(B, K, Smax)
    t = torch.arange(Smax, device=dev)[None, None, :]
    fc3 = torch.where(t < T0_b[:, None, None], fca, fcb)
    segs_body, planew = encode_from_fc(fc3, act3, S_b, K)

    two = torch.full((B,), 2, device=dev)
    segs = ([(u16le_bytes(G.expand(B)), two), (u16le_bytes(zd0), two)]
            + parts["exsegs"] + segs_body)
    total = (2 + 2 + 4 + (4 + 4 * emax + 1) + (4 + 2 * emax + 1) + 6
             + (4 + 4 * K + planew))
    return rowwise_concat(segs, total)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _grid_ctx(grid):
    """In-lane predecessor contexts of a lane grid (CTX0 at t = 0)."""
    B, K, _ = grid.shape
    return torch.cat(
        [torch.full((B, K, 1), CTX0, dtype=torch.int32, device=grid.device),
         grid[:, :, :-1].to(torch.int32)], dim=2)


def _merge_grids(grid1, grid2, T0_b, S_b, Smax: int, K: int):
    """Phase grids (local steps) -> global lane grid [B, K, Smax] u8:
    phase-2 step i lands at global step T0_b + i."""
    B, _, T1 = grid1.shape
    T2 = grid2.shape[2]
    g1 = torch.nn.functional.pad(grid1, (0, Smax - T1))
    r2 = grid2.reshape(B * K, T2)
    if Smax > T2:
        r2 = torch.nn.functional.pad(r2, (0, Smax - T2))
    r2 = r2[:, :Smax]
    sh = T0_b.repeat_interleave(K)[:, None]
    cnt2 = (S_b - T0_b).repeat_interleave(K)[:, None]
    cols = torch.arange(Smax, device=grid1.device)[None, :]
    shifted, _ = monotone_expand(r2, sh.expand(B * K, Smax), cols < cnt2,
                                 Smax)
    t3 = cols[None]
    return torch.where(t3 < T0_b[:, None, None], g1,
                       shifted.reshape(B, K, Smax))


def decode_setup(stream, n, L: int, emax: int):
    """Parse each row's header and exception block: everything phase 1
    of the decode walk needs.  Returns a dict of [B] / [B, K] tensors
    (int32 where they feed kernel 4)."""
    B, _ = stream.shape
    K = K_SHARED
    n = n.to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=stream.device)
    parsed = vbbe21_parse_batch(stream, zero + 4, n - 1, L, emax)
    base_off = parsed["end_off"]
    S_b = wrap_i32(read_u32le(stream, base_off))
    i32 = torch.int32
    return {
        "g_hdr": read_u16le(stream, zero),
        "zd0": read_u16le(stream, zero + 2),
        "parsed": parsed,
        "dlen": (n - 1 - parsed["nex"]).to(i32),
        "S_b": S_b.to(i32),
        "T0_b": cdiv(S_b, PREFIX_DEN).to(i32),
        "states": _rd_states(stream, base_off, K),
        "body_off": (base_off + 4 + 4 * K).to(i32),
    }


def prefix_counts(grid1, d, include):
    """The fit's histogram over phase 1's lane grid (the prefix symbols
    of the rows in `include`)."""
    B, K, T1 = grid1.shape
    dev = grid1.device
    t = torch.arange(T1, device=dev)[None, None, :]
    lanes = torch.arange(K, device=dev)[None, :, None]
    T0_b = d["T0_b"][:, None, None]
    act3 = (t < T0_b) & (lanes * d["S_b"].to(torch.int64)[:, None, None] + t
                         < d["dlen"].to(torch.int64)[:, None, None])
    return o1_prefix_hist(grid1, _grid_ctx(grid1),
                          act3 & include[:, None, None], d["T0_b"])


def phase2_setup(grid1, d, tabs_fit):
    """Per-lane context cluster at step T0_b: the fitted cmap of the
    lane's last prefix symbol (CTX0's cluster where the lane has no
    prefix symbol)."""
    B, K, T1 = grid1.shape
    T0 = d["T0_b"].to(torch.int64)
    last = torch.gather(grid1, 2,
                        (T0 - 1).clamp(0, T1 - 1)[:, None, None].expand(
                            B, K, 1))[:, :, 0].to(torch.int64)
    lanes = torch.arange(K, device=grid1.device)[None, :]
    has = (T0[:, None] > 0) & (lanes * d["S_b"].to(torch.int64)[:, None]
                               < d["dlen"].to(torch.int64)[:, None])
    cmap = tabs_fit["cmap"]
    return torch.where(has, cmap[last], cmap[CTX0]).to(torch.int32)


def depress_drans_batch(stream, n, tabs_canned, L: int, emax: int = None,
                        member=None):
    """Batched drans_vbbe21_zd decode -> [B, L] int16.

    Must receive the encoder's batch grouping (the fit is batch-shared);
    raises ValueError when any stream's G header disagrees.  `member`
    [B] bool restricts the shared fit and the G check to a sub-group."""
    B, _ = stream.shape
    emax = emax or L
    K = K_SHARED
    Smax = -(-L // K)
    T1 = -(-Smax // PREFIX_DEN)
    T2 = max(Smax - T1, 1)  # most suffix steps any row can have
    n = n.to(torch.int64)
    d = decode_setup(stream, n, L, emax)
    parsed, S_b, T0_b, dlen = d["parsed"], d["S_b"], d["T0_b"], d["dlen"]
    include = parsed["nex"] <= emax
    if member is not None:
        include = include & member

    zeros = torch.zeros_like(S_b)
    cl0 = tabs_canned["cmap"][CTX0].to(torch.int32).expand(B, K).contiguous()
    grid1, fst, fptr = o1_decode(
        stream, d["states"], dlen, S_b, tabs_canned["cmap"],
        tabs_canned["cum"], T1, zeros, T0_b, cl0, d["body_off"])

    tabs_fit = fit_tables_device(prefix_counts(grid1, d, include))
    cl2 = phase2_setup(grid1, d, tabs_fit)
    grid2, _, _ = o1_decode(
        stream, fst, dlen, S_b, tabs_fit["cmap"], tabs_fit["cum"], T2,
        T0_b, S_b, cl2, fptr)

    grid = _merge_grids(grid1, grid2, T0_b.to(torch.int64),
                        S_b.to(torch.int64), Smax, K)
    data = _ungrid(grid, S_b, dlen, K, Smax, L)
    vals = vbbe21_fill_batch(parsed, data, n - 1, L)
    out = _zd_merge(d["zd0"], vals, n, L)
    g_expected = ((S_b > 0) & include).sum()
    g_ok = (S_b == 0) | ~include | (d["g_hdr"] == g_expected)
    if not bool(g_ok.all()):
        bad = torch.nonzero(~g_ok).flatten()[:8].tolist()
        raise ValueError(
            f"drans group mismatch: rows {bad} carry a G header that "
            "disagrees with this batch's non-empty-stream count; decode "
            "with the original encode grouping")
    return out
