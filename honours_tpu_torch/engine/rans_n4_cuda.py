"""Kernels 7 and 8 (csrc/rans_n4.cu), each beside its plain PyTorch
version: the nibble-factorized order-1 rANS of srans3 (wire format v4).

Kernel 7, `o1n_fc`, replaces honours_tpu/engine/rans_n4_pallas.py
o1n_fc_gather_pallas: per byte, cl = cmap[ctx], fc_hi = fcH[cl*16 + hi],
gl = lo_assign[cl*16 + hi], fc_lo = fcL[gl*16 + lo].

Kernel 8, `n4_decode`, replaces rans_n4_pallas.py rans_n4_decode_pallas:
the forward decode walk of a v4 body (block-interleaved lanes, lane k
owns [k*S, (k+1)*S)).  Per byte step a 16-symbol hi step under cl and a
16-symbol lo step under gl, each followed by a two-round shared-stream
refill in lane order; then cl = cmap[hi*16 + lo] for active lanes.

Tables (entropy_o1n.make_o1n_tables): cmap [257], lo_assign [r*16],
fcH [r*16], fcL [rL*16] int32, fc = f + cum_lo * 8192, r, rL <= 64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.permute import M32, i32_to_u32
from honours_tpu_torch.kernels.rans import CTX0, K_SHARED, M, PROB_BITS, RANS_L

MAX_CLUSTERS = 64
_FC_THREADS = 512
_FC_BLOCKS_PER_SM = 4

_FC = kernel("o1n_fc", "rans_n4.cu", "htt_o1n_fc", "pppppplllpplp")
_DECODE = kernel("n4_decode", "rans_n4.cu", "htt_n4_decode",
                 "pllpppppppplllpp")


def _check_tables(cmap, lo_assign, fcH, fcL):
    check(cmap, "cmap", (torch.int32,), (CTX0 + 1,))
    for t, name in ((lo_assign, "lo_assign"), (fcH, "fcH"), (fcL, "fcL")):
        check(t, name, (torch.int32,))
        if t.dim() != 1 or t.numel() % 16 or not (
                1 <= t.numel() // 16 <= MAX_CLUSTERS):
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                             f"[r*16], r <= {MAX_CLUSTERS}")
    if lo_assign.numel() != fcH.numel():
        raise ValueError("lo_assign and fcH must both be [r*16]")


def _clamped(cmap, lo_assign, r: int, rL: int):
    return (cmap.to(torch.int64).clamp(0, r - 1),
            lo_assign.to(torch.int64).clamp(0, rL - 1))


# ---------------------------------------------------------------------------
# kernel 7: per-byte (fc_hi, fc_lo) lookups
# ---------------------------------------------------------------------------


def o1n_fc_plain(sym, ctx, cmap, lo_assign, fcH, fcL):
    cm, lo_a = _clamped(cmap, lo_assign, fcH.numel() // 16, fcL.numel() // 16)
    b = sym.to(torch.int64) & 255
    idx = cm[ctx.to(torch.int64).clamp(0, CTX0)] * 16 + (b >> 4)
    return (fcH[idx].to(torch.int32),
            fcL[lo_a[idx] * 16 + (b & 15)].to(torch.int32))


def o1n_fc(sym, ctx, cmap, lo_assign, fcH, fcL):
    """sym [B, G] int32 bytes, ctx [B, G] int32 in [0, 256] ->
    (fc_hi, fc_lo) [B, G] int32."""
    if is_cpu(sym, ctx, cmap, lo_assign, fcH, fcL):
        return o1n_fc_plain(sym, ctx, cmap, lo_assign, fcH, fcL)
    check(sym, "sym", (torch.int32,))
    check(ctx, "ctx", (torch.int32,), sym.shape)
    _check_tables(cmap, lo_assign, fcH, fcL)
    out_h = torch.empty_like(sym)
    out_l = torch.empty_like(sym)
    n = sym.numel()
    if n:
        sms = torch.cuda.get_device_properties(sym.device).multi_processor_count
        grid = min(-(-n // _FC_THREADS), _FC_BLOCKS_PER_SM * sms)
        _FC(sym.data_ptr(), ctx.data_ptr(), cmap.data_ptr(),
            lo_assign.data_ptr(), fcH.data_ptr(), fcL.data_ptr(),
            fcH.numel() // 16, fcL.numel() // 16, n, out_h.data_ptr(),
            out_l.data_ptr(), grid, stream_ptr(sym.device))
    return out_h, out_l


# ---------------------------------------------------------------------------
# kernel 8: v4 decode walk
# ---------------------------------------------------------------------------


def _cdf_rows(fc):
    """[r*16] packed fc -> [r, 17] int64 CDFs (cum[:, 16] = M)."""
    cum = (fc.to(torch.int64) >> 13).reshape(-1, 16)
    return F.pad(cum, (0, 1), value=M)


def _nibble_step(x, rows, active, ptr, stream):
    """One 16-symbol step against CDF rows [B, K, 17]: (x, symbol, ptr)."""
    Mb = stream.shape[1]
    slot = x & (M - 1)
    sym = torch.searchsorted(rows, slot[..., None], right=True)[..., 0] - 1
    c = rows.gather(2, sym[..., None])[..., 0]
    f = rows.gather(2, sym[..., None] + 1)[..., 0] - c
    x = torch.where(active, (f * (x >> PROB_BITS) + slot - c) & M32, x)
    for _ in range(2):
        need = active & (x < RANS_L)
        cnt = need.to(torch.int64)
        p = ptr[:, None] + torch.cumsum(cnt, dim=1) - cnt
        byte = torch.gather(stream, 1, p.clamp(0, Mb - 1)).to(torch.int64)
        byte = torch.where((p >= 0) & (p < Mb), byte, 0)
        x = torch.where(need, ((x << 8) | byte) & M32, x)
        ptr = ptr + cnt.sum(dim=1)
    return x, sym, ptr


def n4_decode_plain(stream, states, dlen, S_b, body_off, cmap, lo_assign,
                    fcH, fcL, T: int):
    B = stream.shape[0]
    K = states.shape[1]
    dev = stream.device
    cum_h, cum_l = _cdf_rows(fcH), _cdf_rows(fcL)
    cm, lo_a = _clamped(cmap, lo_assign, cum_h.shape[0], cum_l.shape[0])
    x = i32_to_u32(states)
    cl = cm[CTX0].expand(B, K)
    lane_base = torch.arange(K, device=dev)[None, :] * S_b.to(torch.int64)[:, None]
    S = S_b.to(torch.int64)[:, None]
    dl = dlen.to(torch.int64)[:, None]
    ptr = body_off.to(torch.int64)
    grid = torch.empty((B, K, T), dtype=torch.uint8, device=dev)
    for t in range(T):
        active = (t < S) & (lane_base + t < dl)
        x, hi, ptr = _nibble_step(x, cum_h[cl], active, ptr, stream)
        x, lo, ptr = _nibble_step(x, cum_l[lo_a[cl * 16 + hi]], active, ptr,
                                  stream)
        byte = hi * 16 + lo
        grid[:, :, t] = byte.to(torch.uint8)
        cl = torch.where(active, cm[byte], cl)
    return grid


def n4_decode(stream, states, dlen, S_b, body_off, cmap, lo_assign, fcH, fcL,
              T: int):
    """Decode T byte steps of each read's v4 body.

    stream [B, Mb] u8 with the body at byte `body_off` of each row,
    states [B, K] int32 (uint32 bits of the lane states), dlen/S_b/
    body_off [B] int32.  Returns the lane grid [B, K, T] u8 (entries of
    inactive steps are whatever the walk decoded there)."""
    args = (stream, states, dlen, S_b, body_off, cmap, lo_assign, fcH, fcL)
    if is_cpu(*args):
        return n4_decode_plain(*args, T)
    B, Mb = stream.shape
    check(stream, "stream", (torch.uint8,))
    check(states, "states", (torch.int32,), (B, K_SHARED))
    for t, name in ((dlen, "dlen"), (S_b, "S_b"), (body_off, "body_off")):
        check(t, name, (torch.int32,), (B,))
    _check_tables(cmap, lo_assign, fcH, fcL)
    grid = torch.empty((B, K_SHARED, T), dtype=torch.uint8, device=stream.device)
    if B:
        _DECODE(stream.data_ptr(), B, Mb, states.data_ptr(), dlen.data_ptr(),
                S_b.data_ptr(), body_off.data_ptr(), cmap.data_ptr(),
                lo_assign.data_ptr(), fcH.data_ptr(), fcL.data_ptr(),
                fcH.numel() // 16, fcL.numel() // 16, T, grid.data_ptr(),
                stream_ptr(stream.device))
    return grid
