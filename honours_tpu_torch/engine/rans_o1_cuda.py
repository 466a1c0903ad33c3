"""Kernels 2 and 4 (csrc/rans_o1.cu), each beside its plain PyTorch
version.

Kernel 2, `o1_fc`, replaces honours_tpu/engine/rans_o1_pallas.py
o1_fc_gather_pallas: fc = fc_tab[cmap[ctx], sym] (f + cum_lo*8192).

Kernel 4, `o1_decode`, replaces rans_o1_pallas.py `_decode_call` as
launched by rans_o1_decode_resume_pallas: the order-1 decode walk over
global steps [step_lo, step_hi) of each read (block-interleaved lanes,
lane k owns [k*S, (k+1)*S)), with shared-stream refills in lane order.

Tables (entropy_o1.make_o1_tables): cmap [257] int32 context -> cluster,
fc [r, 256] int32, cum [r, 257] int32 cluster CDFs (cum[:, 0] = 0,
cum[:, 256] = M), r <= 64.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.permute import M32, i32_to_u32, u32_to_i32
from honours_tpu_torch.kernels.rans import (
    CTX0,
    K_SHARED,
    M,
    PROB_BITS,
    RANS_L,
)

MAX_CLUSTERS = 64
_FC_THREADS = 512
_FC_BLOCKS_PER_SM = 3  # 66 KB of shared memory per block

_FC = kernel("o1_fc", "rans_o1.cu", "htt_o1_fc", "ppppllplp")
_DECODE = kernel("o1_decode", "rans_o1.cu", "htt_o1_decode",
                 "pllpppppppppllpppp")


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
    out = torch.empty_like(sym)
    n = sym.numel()
    if n:
        sms = torch.cuda.get_device_properties(sym.device).multi_processor_count
        grid = min(-(-n // _FC_THREADS), _FC_BLOCKS_PER_SM * sms)
        _FC(sym.data_ptr(), ctx.data_ptr(), cmap.data_ptr(),
            fc_tab.data_ptr(), fc_tab.shape[0], n, out.data_ptr(), grid,
            stream_ptr(sym.device))
    return out


# ---------------------------------------------------------------------------
# kernel 4: resumable order-1 decode walk
# ---------------------------------------------------------------------------


def o1_decode_plain(stream, states, dlen, S_b, cmap, cum, T: int, step_lo,
                    step_hi, init_cl, body_off):
    B, Mb = stream.shape
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
        for _ in range(2):
            need = active & (x < RANS_L)
            cnt = need.to(torch.int64)
            p = ptr[:, None] + torch.cumsum(cnt, dim=1) - cnt
            byte = torch.gather(stream, 1, p.clamp(0, Mb - 1)).to(torch.int64)
            byte = torch.where((p >= 0) & (p < Mb), byte, 0)
            x = torch.where(need, ((x << 8) | byte) & M32, x)
            ptr = ptr + cnt.sum(dim=1)
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
        _DECODE(stream.data_ptr(), B, Mb, states.data_ptr(), dlen.data_ptr(),
                S_b.data_ptr(), step_lo.data_ptr(), step_hi.data_ptr(),
                init_cl.data_ptr(), body_off.data_ptr(), cmap.data_ptr(),
                cum.data_ptr(), cum.shape[0], T, grid.data_ptr(),
                fst.data_ptr(), fptr.data_ptr(), stream_ptr(dev))
    return grid, fst, fptr
