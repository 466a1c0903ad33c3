"""Kernels 2, 4 and 4b (csrc/rans_o1.cu), each beside its plain PyTorch
version.

Kernel 2, `o1_fc`, replaces honours_tpu/engine/rans_o1_pallas.py
o1_fc_gather_pallas: fc = fc_tab[cmap[ctx], sym] (f + cum_lo*8192).

Kernel 4, `o1_decode`, replaces rans_o1_pallas.py `_decode_call` as
launched by rans_o1_decode_resume_pallas: the order-1 decode walk over
global steps [step_lo, step_hi) of each read (block-interleaved lanes,
lane k owns [k*S, (k+1)*S)), with shared-stream refills in lane order.

Kernel 4b, `o0_decode`, replaces the order-0 entry of the same walk,
rans_o1_pallas.py rans_decode_shared_pallas: format v2, one CDF
cum [257], round-robin lanes (step t of lane k is byte t*K + k).

Tables (entropy_o1.make_o1_tables): cmap [257] int32 context -> cluster,
fc [r, 256] int32, cum [r, 257] int32 cluster CDFs (cum[:, 0] = 0,
cum[:, 256] = M, non-decreasing), r <= 64.

The walks look a symbol up in tables a prep kernel writes per launch
(`o1_tables_plain` and `o0_tables_plain` are their plain versions, and
`lookup_plain` the order-1 kernel's lookup): packed words c |
(c + f - 1) << 12 | sym << 24; order 0 has one per slot; order 1 has the
non-zero symbols of each cluster and, per slot pair (2j, 2j + 1), the
rank of the symbol holding slot 2j (slot 2j + 1 lies in it or the next).
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import (
    check,
    is_cpu,
    kernel,
    sm_count,
    stream_ptr,
)
from honours_tpu_torch.engine.permute import M32, i32_to_u32, u32_to_i32
from honours_tpu_torch.kernels.rans import (
    CTX0,
    K_SHARED,
    M,
    PROB_BITS,
    RANS_L,
)

MAX_CLUSTERS = 64
_FC_THREADS = 1024  # one block per SM: the table (<= 66 KB) loaded once
_FC_PER_THREAD = 4  # one 16-byte vector of each operand per step

# the decode walks' tables and blocks (csrc/rans_o1.cu)
NZW = 260  # packed words a cluster row: <= 256 symbols, a pad, 16-byte rows
PAIRS = M // 2  # order-1 slot pairs a cluster
FC_CMAP = 260  # contexts, padded to 16 bytes
MAX_RPB = 8  # reads (warps) a block

_FC = kernel("o1_fc", "rans_o1.cu", "htt_o1_fc", "ppppllplp")
_DECODE = kernel("o1_decode", "rans_o1.cu", "htt_o1_decode",
                 "pllpppppppppllpppplp")
_O0_DECODE = kernel("o0_decode", "rans_o1.cu", "htt_o0_decode",
                    "pllppppllpplp")


def o1_layout_bytes(r: int) -> int:
    """Bytes of the order-1 walk's tables for r clusters: words [r, NZW]
    u32, pair ranks [r, PAIRS] u8, cluster offsets [FC_CMAP, 2] int32."""
    return r * (NZW * 4 + PAIRS) + FC_CMAP * 8


def walk_reads_per_block(B: int, sms: int) -> int:
    """Reads (one warp each) a walk block takes: enough that the B reads
    fit in one block per SM, so each SM copies the tables once, at most
    MAX_RPB."""
    return max(1, min(MAX_RPB, -(-B // sms)))


def _le_bytes(t, n: int):
    sh = torch.arange(n, device=t.device) * 8
    b = (t.to(torch.int64)[..., None] >> sh) & 255
    return b.to(torch.uint8).reshape(-1)


def _from_le(b, n: int):
    sh = torch.arange(n, device=b.device) * 8
    return (b.reshape(-1, n).to(torch.int64) << sh).sum(1)


def _pack_words(c, hi, sym):
    return c | ((hi - 1) << 12) | (sym << 24)


def _cdf_search(cum64, v):
    """Largest s in [0, 255] with cum[s] <= v, per row of cum64 [r, 257]."""
    s = torch.searchsorted(cum64, v.contiguous(), right=True) - 1
    return s.clamp(0, 255)


def o1_tables_plain(cmap, cum):
    """The order-1 walk's tables as its prep kernel writes them (u8 bytes,
    o1_layout_bytes(r)): each cluster's non-zero symbols as packed words
    in symbol order, the rest of the row all ones; pairs[cl, j] = the rank
    of the symbol holding slot 2j; per context the cluster's byte offsets
    (cluster * PAIRS into the ranks, cluster * NZW * 4 into the words)."""
    r = cum.shape[0]
    dev = cum.device
    cum64 = cum.to(torch.int64)
    c, hi = cum64[:, :256], cum64[:, 1:]
    live = hi > c
    rank = torch.cumsum(live.to(torch.int64), 1) - 1
    rows = torch.arange(r, device=dev)[:, None].expand(r, 256)
    sym = torch.arange(256, device=dev).expand(r, 256)
    words = torch.full((r, NZW), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    words[rows[live], rank[live]] = _pack_words(c, hi, sym)[live]
    slots = torch.arange(PAIRS, device=dev).expand(r, PAIRS) * 2
    pairs = rank.gather(1, _cdf_search(cum64, slots))
    cl = torch.zeros(FC_CMAP, dtype=torch.int64, device=dev)
    cl[:CTX0 + 1] = cmap.to(torch.int64).clamp(0, r - 1)
    bases = torch.stack([cl * PAIRS, cl * NZW * 4], 1)
    return torch.cat([_le_bytes(words, 4), _le_bytes(pairs, 1),
                      _le_bytes(bases, 4)])


def o0_tables_plain(cum):
    """The order-0 walk's table: the packed word of every slot [M]."""
    cum64 = cum.to(torch.int64)
    s = _cdf_search(cum64[None], torch.arange(M, device=cum.device)[None])[0]
    return _pack_words(cum64[s], cum64[s + 1], s)


def lookup_plain(tables, r: int, ctx, slot):
    """(sym, c, f) of `slot` under context `ctx` (tensors of one shape)
    as the order-1 walk finds it in o1_tables_plain's bytes: the pair's
    rank, then its word or the next one."""
    words = _from_le(tables[:r * NZW * 4], 4)
    pairs = tables[r * NZW * 4:r * (NZW * 4 + PAIRS)].to(torch.int64)
    bases = _from_le(tables[r * (NZW * 4 + PAIRS):], 4).reshape(-1, 2)
    b = bases[ctx]
    wi = b[..., 1] // 4 + pairs[b[..., 0] + (slot >> 1)]
    w0, w1 = words[wi], words[wi + 1]
    w = torch.where(slot > ((w0 >> 12) & 4095), w1, w0)
    c = w & 4095
    return w >> 24, c, ((w >> 12) & 4095) + 1 - c


def _check_tables(cmap, fc_tab=None, cum=None):
    check(cmap, "cmap", (torch.int32,), (CTX0 + 1,))
    for t, name, w in ((fc_tab, "fc_tab", 256), (cum, "cum", 257)):
        if t is not None:
            check(t, name, (torch.int32,))
            if t.dim() != 2 or t.shape[1] != w or not (
                    1 <= t.shape[0] <= MAX_CLUSTERS):
                raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                                 f"[r <= {MAX_CLUSTERS}, {w}]")


# ---------------------------------------------------------------------------
# kernel 2: (f, cum) lookup
# ---------------------------------------------------------------------------


def o1_fc_plain(sym, ctx, cmap, fc_tab):
    cl = cmap.to(torch.int64).clamp(0, fc_tab.shape[0] - 1)
    idx = cl[ctx.to(torch.int64).clamp(0, CTX0)] * 256 + (sym.to(torch.int64) & 255)
    return fc_tab.reshape(-1)[idx].to(torch.int32)


def o1_fc(sym, ctx, cmap, fc_tab):
    """sym [B, G] int32 in [0, 256), ctx [B, G] int32 in [0, 256] ->
    fc [B, G] int32 = f + cum_lo * 8192."""
    if is_cpu(sym, ctx, cmap, fc_tab):
        return o1_fc_plain(sym, ctx, cmap, fc_tab)
    check(sym, "sym", (torch.int32,))
    check(ctx, "ctx", (torch.int32,), sym.shape)
    _check_tables(cmap, fc_tab=fc_tab)
    n = sym.numel()
    # fc shares sym's offset within 16 bytes, so both move as vectors
    off = sym.data_ptr() % 16 // 4
    out = torch.empty((n + off,), dtype=torch.int32,
                      device=sym.device)[off:].view(sym.shape)
    if n:
        sms = sm_count(sym.device)
        grid = min(-(-n // (_FC_THREADS * _FC_PER_THREAD)), sms)
        _FC(sym.data_ptr(), ctx.data_ptr(), cmap.data_ptr(),
            fc_tab.data_ptr(), fc_tab.shape[0], n, out.data_ptr(), grid,
            stream_ptr(sym.device))
    return out


# ---------------------------------------------------------------------------
# kernel 4: resumable order-1 decode walk
# ---------------------------------------------------------------------------


def _refill_plain(stream, x, active, ptr):
    """The shared-stream refill of one step: every active lane below
    RANS_L takes the next byte in lane order, then the lanes still below
    take a second one.  Bytes outside the row read as 0.  x [B, K] int64
    uint32 values, ptr [B] int64 absolute byte positions."""
    Mb = stream.shape[1]
    for _ in range(2):
        need = active & (x < RANS_L)
        cnt = need.to(torch.int64)
        p = ptr[:, None] + torch.cumsum(cnt, dim=1) - cnt
        byte = torch.gather(stream, 1, p.clamp(0, Mb - 1)).to(torch.int64)
        byte = torch.where((p >= 0) & (p < Mb), byte, 0)
        x = torch.where(need, ((x << 8) | byte) & M32, x)
        ptr = ptr + cnt.sum(dim=1)
    return x, ptr


def o1_decode_plain(stream, states, dlen, S_b, cmap, cum, T: int, step_lo,
                    step_hi, init_cl, body_off):
    B = stream.shape[0]
    K = states.shape[1]
    dev = stream.device
    r = cum.shape[0]
    cum64 = cum.to(torch.int64)
    cmap64 = cmap.to(torch.int64).clamp(0, r - 1)
    x = i32_to_u32(states)
    cl = init_cl.to(torch.int64).clamp(0, r - 1)
    lane_base = torch.arange(K, device=dev)[None, :] * S_b.to(torch.int64)[:, None]
    lo, hi = step_lo.to(torch.int64), step_hi.to(torch.int64)
    dl = dlen.to(torch.int64)[:, None]
    ptr = body_off.to(torch.int64)
    grid = torch.empty((B, K, T), dtype=torch.uint8, device=dev)
    for i in range(T):
        u = lo + i
        active = (u < hi)[:, None] & (lane_base + u[:, None] < dl)
        slot = x & (M - 1)
        rows = cum64[cl]  # [B, K, 257]
        sym = torch.searchsorted(rows, slot[..., None], right=True)[..., 0] - 1
        grid[:, :, i] = sym.to(torch.uint8)
        c = rows.gather(2, sym[..., None])[..., 0]
        f = rows.gather(2, sym[..., None] + 1)[..., 0] - c
        x = torch.where(active, (f * (x >> PROB_BITS) + slot - c) & M32, x)
        x, ptr = _refill_plain(stream, x, active, ptr)
        cl = torch.where(active, cmap64[sym], cl)
    return grid, u32_to_i32(x), ptr.to(torch.int32)


def o1_decode(stream, states, dlen, S_b, cmap, cum, T: int, step_lo,
              step_hi, init_cl, body_off):
    """Decode global steps [step_lo, step_hi) of each read.

    stream [B, Mb] u8 with the body at byte `body_off` of each row,
    states [B, K] int32 (uint32 bits), dlen/S_b/step_lo/step_hi/body_off
    [B] int32, init_cl [B, K] int32 (the cluster of each lane's context
    at step_lo).  T = steps this launch runs.  Returns (grid [B, K, T] u8
    with this launch's symbols at local steps 0.., final states [B, K]
    int32, final absolute byte pointer [B] int32)."""
    args = (stream, states, dlen, S_b, cmap, cum, step_lo, step_hi, init_cl,
            body_off)
    if is_cpu(*args):
        return o1_decode_plain(stream, states, dlen, S_b, cmap, cum, T,
                               step_lo, step_hi, init_cl, body_off)
    B, Mb = stream.shape
    check(stream, "stream", (torch.uint8,))
    check(states, "states", (torch.int32,), (B, K_SHARED))
    check(init_cl, "init_cl", (torch.int32,), (B, K_SHARED))
    for t, name in ((dlen, "dlen"), (S_b, "S_b"), (step_lo, "step_lo"),
                    (step_hi, "step_hi"), (body_off, "body_off")):
        check(t, name, (torch.int32,), (B,))
    _check_tables(cmap, cum=cum)
    dev = stream.device
    grid = torch.empty((B, K_SHARED, T), dtype=torch.uint8, device=dev)
    fst = torch.empty((B, K_SHARED), dtype=torch.int32, device=dev)
    fptr = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        r = cum.shape[0]
        tables = torch.empty((o1_layout_bytes(r),), dtype=torch.uint8,
                             device=dev)
        _DECODE(stream.data_ptr(), B, Mb, states.data_ptr(), dlen.data_ptr(),
                S_b.data_ptr(), step_lo.data_ptr(), step_hi.data_ptr(),
                init_cl.data_ptr(), body_off.data_ptr(), cmap.data_ptr(),
                cum.data_ptr(), r, T, grid.data_ptr(), fst.data_ptr(),
                fptr.data_ptr(), tables.data_ptr(),
                walk_reads_per_block(B, sm_count(dev)), stream_ptr(dev))
    return grid, fst, fptr


# ---------------------------------------------------------------------------
# kernel 4b: order-0 decode walk (format v2)
# ---------------------------------------------------------------------------


def o0_decode_plain(stream, states, dlen, cum, N: int, body_off):
    B = stream.shape[0]
    K = states.shape[1]
    dev = stream.device
    T = -(-N // K)
    cum64 = cum.to(torch.int64)
    x = i32_to_u32(states)
    lanes = torch.arange(K, device=dev)[None, :]
    dl = dlen.to(torch.int64)[:, None]
    ptr = body_off.to(torch.int64)
    out = torch.empty((B, T * K), dtype=torch.uint8, device=dev)
    for t in range(T):
        active = t * K + lanes < dl
        slot = x & (M - 1)
        sym = torch.searchsorted(cum64, slot, right=True) - 1
        c = cum64[sym]
        f = cum64[sym + 1] - c
        out[:, t * K:(t + 1) * K] = torch.where(active, sym, 0).to(torch.uint8)
        x = torch.where(active, (f * (x >> PROB_BITS) + slot - c) & M32, x)
        x, ptr = _refill_plain(stream, x, active, ptr)
    return out[:, :N]


def o0_decode(stream, states, dlen, cum, N: int, body_off):
    """Decode the v2 body at byte `body_off` of each row.

    stream [B, Mb] u8, states [B, K] int32 (uint32 bits), dlen/body_off
    [B] int32, cum [257] int32 (cum[0] = 0, cum[256] = M).  Returns
    [B, N] u8: byte t*K + k is step t of lane k, 0 at and past dlen."""
    if is_cpu(stream, states, dlen, cum, body_off):
        return o0_decode_plain(stream, states, dlen, cum, N, body_off)
    B, Mb = stream.shape
    check(stream, "stream", (torch.uint8,))
    check(states, "states", (torch.int32,), (B, K_SHARED))
    check(dlen, "dlen", (torch.int32,), (B,))
    check(body_off, "body_off", (torch.int32,), (B,))
    check(cum, "cum", (torch.int32,), (257,))
    dev = stream.device
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    if B and N:
        tables = torch.empty((M,), dtype=torch.int32, device=dev)
        _O0_DECODE(stream.data_ptr(), B, Mb, states.data_ptr(),
                   dlen.data_ptr(), body_off.data_ptr(), cum.data_ptr(), N,
                   -(-N // K_SHARED), out.data_ptr(), tables.data_ptr(),
                   walk_reads_per_block(B, sm_count(dev)), stream_ptr(dev))
    return out
