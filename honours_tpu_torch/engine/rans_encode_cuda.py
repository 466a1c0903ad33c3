"""Kernel 3: the rANS encode state walk (csrc/rans_encode.cu), beside its
plain PyTorch version.

Replaces honours_tpu/engine/rans_encode_pallas.py rans_encode_core_pallas.
fc [B, Smax*K] int32 is step-major (column t*K + lane), f + cum*8192 for
active elements and 0 for inactive ones.  Returns the candidate byte
plane and its keep mask, [B, Smax*2K] each (column t*2K + j: round 1 of
lane j for j < K, round 2 of lane j-K otherwise), and the final lane
states [B, K] as int32 bit patterns of the uint32 states.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.permute import u32_to_i32
from honours_tpu_torch.kernels.rans import K_SHARED, PROB_BITS, RANS_L

_ENCODE = kernel("rans_encode", "rans_encode.cu", "htt_rans_encode",
                 "pllpppp")


def encode_core_plain(fc, Smax: int, K: int = K_SHARED):
    B = fc.shape[0]
    fc3 = fc.reshape(B, Smax, K).to(torch.int64)
    x = torch.full((B, K), RANS_L, dtype=torch.int64, device=fc.device)
    cand = torch.empty((B, Smax, 2 * K), dtype=torch.uint8, device=fc.device)
    keep = torch.empty((B, Smax, 2 * K), dtype=torch.bool, device=fc.device)
    hi = 19  # x >= f * 2^19 <=> (x >> 19) >= f
    for t in range(Smax - 1, -1, -1):
        v = fc3[:, t]
        active = v > 0
        f = torch.where(active, v & 8191, 1)
        c = torch.where(active, v >> 13, 0)
        b1 = x & 0xFF
        over1 = active & ((x >> hi) >= f)
        x = torch.where(over1, x >> 8, x)
        b2 = x & 0xFF
        over2 = active & ((x >> hi) >= f)
        x = torch.where(over2, x >> 8, x)
        x = torch.where(active, ((x // f) << PROB_BITS) + x % f + c, x)
        cand[:, t, :K] = torch.where(over2, b2, b1)
        keep[:, t, :K] = over1
        cand[:, t, K:] = b1
        keep[:, t, K:] = over2
    return (cand.reshape(B, Smax * 2 * K), keep.reshape(B, Smax * 2 * K),
            u32_to_i32(x))


def encode_core(fc, Smax: int, K: int = K_SHARED):
    """-> (cand [B, Smax*2K] u8, keep [B, Smax*2K] bool, states [B, K]
    int32)."""
    if is_cpu(fc):
        return encode_core_plain(fc, Smax, K)
    if K != K_SHARED:
        raise ValueError(f"the kernel walks {K_SHARED} lanes per read")
    B = fc.shape[0]
    check(fc, "fc", (torch.int32,), (B, Smax * K))
    cand = torch.empty((B, Smax * 2 * K), dtype=torch.uint8, device=fc.device)
    keep = torch.empty((B, Smax * 2 * K), dtype=torch.bool, device=fc.device)
    states = torch.empty((B, K), dtype=torch.int32, device=fc.device)
    if B:
        _ENCODE(fc.data_ptr(), B, Smax, cand.data_ptr(), keep.data_ptr(),
                states.data_ptr(), stream_ptr(fc.device))
    return cand, keep, states
