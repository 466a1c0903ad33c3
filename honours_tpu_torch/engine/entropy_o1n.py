"""Batched nibble-factorized order-1 rANS (wire format v4), the body of
srans3.

Same lane discipline as the v3/v5 bodies (entropy_o1.py): block-
interleaved lanes, a shared refill stream, a per-row S header.  Each
byte codes as two 4-bit symbols (tables/o1n.py): kernel 7 looks up both
(f, cum) pairs, the encode walk is kernel 3 run over 2*Smax steps, and
kernel 8 decodes.  Byte-exact with honours_tpu's engine and its host
coder kernels.rans.rans_{en,de}code_o1n.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from honours_tpu_torch.engine.bits import read_u32le
from honours_tpu_torch.engine.entropy_o1 import (
    _lane_grid,
    _rd_states,
    _ungrid,
    encode_segments,
)
from honours_tpu_torch.engine.rans_n4_cuda import n4_decode, o1n_fc
from honours_tpu_torch.engine.vbbe21 import wrap_i32
from honours_tpu_torch.kernels.rans import K_SHARED
from honours_tpu_torch.tables.o1n import canned_nibble_tables


def make_o1n_tables(nib: dict, device) -> dict:
    """Device tables from tables.o1n.build_nibble_tables output: cmap
    [257], lo_assign [r*16], and the packed fcH [r*16] / fcL [rL*16]
    (f + cum_lo * 8192, which carry H, L and their CDFs), all int32."""
    H = np.asarray(nib["H"], np.int64)
    L = np.asarray(nib["L"], np.int64)

    def packed(f):
        cum = np.cumsum(f, axis=1) - f
        return (f + cum * 8192).reshape(-1)

    def dev(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    return {
        "cmap": dev(np.asarray(nib["cmap"]).reshape(-1)),
        "lo_assign": dev(np.asarray(nib["lo_assign"]).reshape(-1)),
        "fcH": dev(packed(H)),
        "fcL": dev(packed(L)),
    }


@functools.cache
def canned_o1n_device_tables(device) -> dict:
    """The canned nibble tables on `device` (built once per device)."""
    return make_o1n_tables(canned_nibble_tables(), device)


def rans_o1n_encode_batch(data, dlen, tabs):
    """[B, N] u8 residual bytes (first dlen valid) -> v4 body as concat
    segments [S:u32][K states:u32][candidate plane + keep mask], and the
    plane width."""
    B, N = data.shape
    K = K_SHARED
    Smax = -(-N // K)
    g3, ctx3, act3, S_b = _lane_grid(data, dlen, K, Smax)
    fch, fcl = o1n_fc(g3.reshape(B, -1).to(torch.int32),
                      ctx3.reshape(B, -1).contiguous(), tabs["cmap"],
                      tabs["lo_assign"], tabs["fcH"], tabs["fcL"])
    act = act3.reshape(B, -1)
    fch = torch.where(act, fch, 0).reshape(B, K, Smax)
    fcl = torch.where(act, fcl, 0).reshape(B, K, Smax)
    # step-major [B, 2*Smax*K]: column (2t + phase)*K + k
    fc = torch.stack([fch, fcl], dim=3).permute(0, 2, 3, 1).reshape(
        B, 2 * Smax * K)
    return encode_segments(fc, 2 * Smax, S_b, K)


def rans_o1n_decode_batch(stream, base_off, dlen, tabs, N: int):
    """Decode the v4 body at base_off of each row -> data [B, N] u8."""
    K = K_SHARED
    Smax = -(-N // K)
    base_off = base_off.to(torch.int64)
    S_b = wrap_i32(read_u32le(stream, base_off)).to(torch.int32)
    i32 = torch.int32
    grid = n4_decode(stream.contiguous(), _rd_states(stream, base_off, K),
                     dlen.to(i32).contiguous(), S_b,
                     (base_off + 4 + 4 * K).to(i32), tabs["cmap"],
                     tabs["lo_assign"], tabs["fcH"], tabs["fcL"], Smax)
    return _ungrid(grid, S_b, dlen, K, Smax, N)
