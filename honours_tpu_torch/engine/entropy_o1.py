"""Batched order-1 static-CDF rANS pieces (wire format v3 body).

Lanes are block-interleaved: lane k owns [k*S, (k+1)*S) of a read's
residual bytes, S = ceil(n / K), so each symbol's context is its
predecessor in the same lane (CTX0 for a lane's first symbol) and all K
contexts are known in lockstep during decode.  srans2 runs the v3 body
with the canned table (rans_o1_encode_batch, rans_o1_decode_batch); the
drans engine (format v5) drives the same pieces with two tables; srans3
(format v4, entropy_o1n.py) shares the lane grid, the encode tail and
the state header.
"""

from __future__ import annotations

import numpy as np
import torch

from honours_tpu_torch.engine.bits import read_u32le, u32le_bytes
from honours_tpu_torch.engine.permute import (
    i32_to_u32,
    monotone_compact,
    monotone_expand,
    u32_to_i32,
)
from honours_tpu_torch.engine.rans_encode_cuda import encode_core
from honours_tpu_torch.engine.rans_o1_cuda import (
    MAX_CLUSTERS,
    o1_decode,
    o1_fc,
)
from honours_tpu_torch.engine.vbbe21 import wrap_i32
from honours_tpu_torch.kernels.rans import CTX0, K_SHARED, M


def cdiv(a, k: int):
    """Ceiling division of an integer tensor by a positive int."""
    return -torch.div(-a, k, rounding_mode="floor")


def make_o1_tables(freq257: np.ndarray, device) -> dict:
    """Device tables for a [257, 256] order-1 frequency table.

    The rows are clustered (np.unique recovers the distinct rows), so
    the kernels work against r <= 64 cluster rows.  Returns dict with
      cmap [257] int32: context -> cluster row,
      fc [r, 256] int32: f + cum_lo * 8192 per (cluster, symbol),
      cum [r, 257] int32: cluster CDFs (cum[:, 0] = 0, cum[:, 256] = M).
    """
    ft = np.asarray(freq257, dtype=np.int64)
    if ft.shape != (257, 256) or not (ft.sum(axis=1) == M).all():
        raise ValueError("an o1 table is [257, 256] with rows summing to M")
    urows, cmap = np.unique(ft, axis=0, return_inverse=True)
    if urows.shape[0] > MAX_CLUSTERS:
        raise ValueError(f"{urows.shape[0]} distinct rows > {MAX_CLUSTERS}")
    ucum = np.cumsum(urows, axis=1)
    cum = np.concatenate([np.zeros((urows.shape[0], 1), np.int64), ucum],
                         axis=1)
    fc = urows + (ucum - urows) * 8192

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=device)

    return {"cmap": dev(cmap.reshape(-1)), "fc": dev(fc), "cum": dev(cum)}


def _o1_fc(sym, ctx, tabs):
    """(f + cum_lo * 8192) per element from kernel 2."""
    return o1_fc(sym, ctx, tabs["cmap"], tabs["fc"])


def _u32le_grid(x):
    """[B, K] uint32 bits -> [B, 4K] u8 little-endian."""
    B, K = x.shape
    shifts = torch.tensor([0, 8, 16, 24], device=x.device)
    return ((i32_to_u32(x)[:, :, None] >> shifts) & 0xFF).to(
        torch.uint8).reshape(B, 4 * K)


def _lane_grid(data, dlen, K: int, Smax: int):
    """[B, N] u8 linear bytes -> block-interleaved lane grid.

    grid[b, k, t] = data[b, k*S_b + t] for t < S_b, S_b = ceil(dlen/K):
    one monotone expansion, source j landing at
    j + (j // S_b) * (Smax - S_b).  Returns (grid u8, ctx int32,
    act bool) each [B, K, Smax], plus S_b [B] int64."""
    B, N = data.shape
    dlen = dlen.to(torch.int64)
    S_b = cdiv(dlen, K)
    S_div = S_b.clamp(min=1)[:, None]
    j = torch.arange(N, device=data.device)[None, :]
    valid = j < dlen[:, None]
    shift = torch.where(valid, (j // S_div) * (Smax - S_b[:, None]), 0)
    grid, alive = monotone_expand(data, shift, valid, K * Smax)
    g3 = grid.reshape(B, K, Smax)
    ctx3 = torch.cat(
        [torch.full((B, K, 1), CTX0, dtype=torch.int32, device=data.device),
         g3[:, :, :-1].to(torch.int32)], dim=2)
    return g3, ctx3, alive.reshape(B, K, Smax), S_b


def encode_segments(fc, nsteps: int, S_b, K: int = K_SHARED):
    """Encode tail: step-major packed (f, c) [B, nsteps*K] (0 where
    inactive) -> body concat segments [S:u32][K states:u32][candidate
    plane + keep mask], and the plane width.  The body compaction rides
    the caller's rowwise_concat."""
    B = fc.shape[0]
    cand, keep, states = encode_core(fc.to(torch.int32).contiguous(), nsteps,
                                     K)
    dev = fc.device
    segs = [
        (u32le_bytes(S_b), torch.full((B,), 4, device=dev)),
        (_u32le_grid(states), torch.full((B,), 4 * K, device=dev)),
        (cand, keep),
    ]
    return segs, cand.shape[1]


def encode_from_fc(fc3, act3, S_b, K: int = K_SHARED):
    """v3 body from packed (f, c) per lane-grid position [B, K, Smax]."""
    B, _, Smax = fc3.shape
    fc = torch.where(act3, fc3, 0).transpose(1, 2).reshape(B, Smax * K)
    return encode_segments(fc, Smax, S_b, K)


def rans_o1_encode_batch(data, dlen, tabs):
    """[B, N] u8 residual bytes (first dlen valid) -> v3 body as concat
    segments [S:u32][K states:u32][candidate plane + keep mask], and the
    plane width: lane grid, kernel 2 against one o1 table, kernel 3."""
    B, N = data.shape
    K = K_SHARED
    Smax = -(-N // K)
    g3, ctx3, act3, S_b = _lane_grid(data, dlen, K, Smax)
    fc3 = _o1_fc(g3.reshape(B, -1).to(torch.int32),
                 ctx3.reshape(B, -1).contiguous(), tabs).reshape(B, K, Smax)
    return encode_from_fc(fc3, act3, S_b, K)


def rans_o1_decode_batch(stream, base_off, dlen, tabs, N: int):
    """Decode the v3 body at base_off of each row -> data [B, N] u8: one
    full walk of kernel 4 (steps [0, S_b), every lane starting in
    cmap[CTX0]'s cluster), then the lane grid back to linear bytes.
    S_b comes from each row's header, so host streams decode too."""
    B = stream.shape[0]
    K = K_SHARED
    Smax = -(-N // K)
    base_off = base_off.to(torch.int64)
    S_b = wrap_i32(read_u32le(stream, base_off)).to(torch.int32)
    cl0 = tabs["cmap"][CTX0].expand(B, K).contiguous()
    grid, _, _ = o1_decode(
        stream.contiguous(), _rd_states(stream, base_off, K),
        dlen.to(torch.int32).contiguous(), S_b, tabs["cmap"], tabs["cum"],
        Smax, torch.zeros_like(S_b), S_b, cl0,
        (base_off + 4 + 4 * K).to(torch.int32))
    return _ungrid(grid, S_b, dlen, K, Smax, N)


def _rd_states(stream, base_off, K: int):
    """The K u32 lane states after the S header at base_off, as int32
    bits."""
    return read_states(stream, base_off + 4, K)


def read_states(stream, off, K: int):
    """K u32 LE lane states at byte `off` [B] of each row, as int32 bits
    (reads past the row clamp to it)."""
    B, Mb = stream.shape
    so = off[:, None] + 4 * torch.arange(K, device=stream.device)
    idx = so[:, :, None] + torch.arange(4, device=stream.device)
    b = torch.gather(stream, 1, idx.reshape(B, -1).clamp(0, Mb - 1))
    b = b.reshape(B, K, 4).to(torch.int64)
    return u32_to_i32((b << torch.tensor([0, 8, 16, 24],
                                         device=stream.device)).sum(dim=2))


def _ungrid(out3, S_b, dlen, K: int, Smax: int, N: int):
    """[B, K, Smax] u8 lane grid -> [B, N] linear bytes (per-row S_b)."""
    B = out3.shape[0]
    dev = out3.device
    t = torch.arange(Smax, device=dev)[None, None, :]
    k = torch.arange(K, device=dev)[None, :, None]
    S = S_b.to(torch.int64)[:, None, None]
    keep = (t < S) & (k * S + t < dlen.to(torch.int64)[:, None, None])
    lin, _ = monotone_compact(out3.reshape(B, K * Smax),
                              keep.reshape(B, K * Smax))
    return lin[:, :N]
