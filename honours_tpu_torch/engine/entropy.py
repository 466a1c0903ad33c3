"""Batched entropy stages: static-Huffman encode (the body of shuffman)
and order-0 static-CDF rANS (wire format v2, the body of srans).

shuff encode: per-byte code lengths -> bit-offset prefix sum -> LSB-first
field pack (press/huffman do_memory_encode's bit order), behind its
[dataBytes:u32 BE] header.  Byte-exact with honours_tpu's host coder
kernels.huffman_np.huffman_encode, and with its engine
(engine/entropy.py shuff_encode_batch) wherever that engine's bits fit
the 2N + 8 bytes it sizes them for (ROADMAP.md watch list): here a row
holds N codes of up to 22 bits.

rANS v2:

K = 32 lanes per read share one stream, in decoder consumption order,
with round-robin lanes: step t of lane k codes byte t*K + k.  The body
is [K states:u32 LE][shared body]; there is no S header.  The encode
runs kernel 2 against a single-cluster table (cmap all 0, one fc row)
and kernel 3 over the step-major byte plane, which round-robin lanes
make the linear bytes themselves; the decode is kernel 4b.  Byte-exact
with honours_tpu's engine and its host coder
kernels.rans.rans_{en,de}code_shared.
"""

from __future__ import annotations

import numpy as np
import torch

from honours_tpu_torch.engine.bits import (
    pack_fields_lsb,
    rowwise_concat,
    u32le_bytes,
)
from honours_tpu_torch.engine.entropy_o1 import _u32le_grid, read_states
from honours_tpu_torch.engine.rans_encode_cuda import encode_core
from honours_tpu_torch.engine.rans_o1_cuda import o0_decode, o1_fc
from honours_tpu_torch.kernels.rans import CTX0, K_SHARED, M


def shuff_encode_batch(data, dlen, tabs):
    """[B, N] u8 (first dlen valid) -> shuffman blob [dataBytes:u32 BE]
    [bits] (dataBytes = dlen as uint32, so 0xFFFFFFFF for -1) as (blob
    [B, W] u8, len [B]).  tabs["lengths"], tabs["codes"]: [256] int64,
    the table's codes of 1 to 22 bits."""
    B, N = data.shape
    dev = data.device
    pos = torch.arange(N, device=dev)[None, :]
    valid = pos < dlen.to(torch.int64)[:, None]
    d = data.to(torch.int64)
    lens = torch.where(valid, tabs["lengths"][d], 0)
    ends = torch.cumsum(lens, dim=1)
    total_bits = ends[:, -1]
    n_words = (22 * N + 31) // 32
    bits = pack_fields_lsb(torch.where(valid, tabs["codes"][d], 0),
                           ends - lens, valid, n_words)
    return rowwise_concat(
        [(u32le_bytes(dlen).flip(1), torch.full((B,), 4, device=dev)),
         (bits, (total_bits + 7) // 8)], 4 * n_words + 4)


def make_tables(freqs_np: np.ndarray, device) -> dict:
    """Device tables for a normalized [256] order-0 table (sum M):
      freqs [256] int32,
      cum [257] int32 (cum[0] = 0, cum[256] = M),
      cmap [257] int32 zeros and fc [1, 256] int32 (f + cum_lo * 8192):
      the single-cluster table kernel 2 looks symbols up in."""
    f = np.asarray(freqs_np, dtype=np.int64)
    if f.shape != (256,) or f.sum() != M:
        raise ValueError("an order-0 table is [256] summing to M")
    cum = np.concatenate([[0], np.cumsum(f)])

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=device)

    return {"freqs": dev(f), "cum": dev(cum), "cmap": dev(np.zeros(CTX0 + 1)),
            "fc": dev((f + cum[:256] * 8192).reshape(1, 256))}


def rans_encode_batch(data, dlen, tabs):
    """[B, N] u8 (first dlen valid) -> v2 body as concat segments
    [K states:u32][candidate plane + keep mask], and the plane width."""
    B, N = data.shape
    K = K_SHARED
    nsteps = -(-N // K)
    d = torch.nn.functional.pad(data.to(torch.int32), (0, nsteps * K - N))
    fc = o1_fc(d, d, tabs["cmap"], tabs["fc"])
    pos = torch.arange(nsteps * K, device=data.device)[None, :]
    fc = torch.where(pos < dlen.to(torch.int64)[:, None], fc, 0)
    cand, keep, states = encode_core(fc.contiguous(), nsteps, K)
    segs = [
        (_u32le_grid(states), torch.full((B,), 4 * K, device=data.device)),
        (cand, keep),
    ]
    return segs, cand.shape[1]


def rans_decode_batch(stream, base_off, dlen, tabs, N: int):
    """Decode the v2 body at base_off of each row -> data [B, N] u8
    (0 at and past dlen)."""
    K = K_SHARED
    base_off = base_off.to(torch.int64)
    return o0_decode(stream.contiguous(), read_states(stream, base_off, K),
                     dlen.to(torch.int32).contiguous(), tabs["cum"], N,
                     (base_off + 4 * K).to(torch.int32))
