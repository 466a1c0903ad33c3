"""Kernel K: flat_uint_submin's optimal step-aligned partition
(csrc/flats.cu), beside its plain version (engine/flats.py
flats_partition_plain).

No TPU kernel stands behind it: honours_tpu partitions on the host only
(honours_tpu/codecs/flats.py partition_flats).  The wrapper routes by
device: CPU tensors take the plain version, CUDA tensors launch the
kernel, one block a read, its DP state in shared memory where it fits
(SMEM_MAX) and in scratch the wrapper allocates otherwise.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.flats import chunks, flats_partition_plain

_PARTITION = kernel("flats_partition", "flats.cu", "htt_flats_partition",
                    "pllpllpppppllp")

#: csrc/flats.cu SMEM_MAX: the shared memory a block's DP state may take
SMEM_MAX = 200 * 1024


def threads(m: int) -> int:
    """Threads a block for reads of up to m chunks: a wider block where
    a step has more (i, j) pairs than its reduction costs."""
    return 1024 if m > 8192 else 256


def state_bytes(m: int) -> int:
    """Shared memory for a read of m chunks (best int64 [m + 1], ranges
    u32 [m]), or 0 where it exceeds SMEM_MAX (scratch instead)."""
    b = 8 * (m + 1) + 4 * m
    return b if b <= SMEM_MAX else 0


def flats_partition(sig, n, step: int):
    """sig [B, L] int16, n [B] int32 (clamped to [0, L]), step >= 1 ->
    cut [B, ceil(L / step) + 1] u8 (see flats_partition_plain)."""
    if is_cpu(sig, n):
        return flats_partition_plain(sig, n, step)
    check(sig, "sig", (torch.int16,))
    if sig.dim() != 2:
        raise ValueError(f"sig: shape {tuple(sig.shape)} is not [B, L]")
    B, L = sig.shape
    check(n, "n", (torch.int32,), (B,))
    m = chunks(L, step)
    if step < 1 or m >= 1 << 24:
        raise ValueError(f"step {step} at L = {L}: m = {m} chunks is out of "
                         "range")
    dev = sig.device
    smem = state_bytes(m)
    cut = torch.zeros((B, m + 1), dtype=torch.uint8, device=dev)
    cmnx = torch.empty((B, max(m, 1)), dtype=torch.int32, device=dev)
    prev = torch.empty((B, m + 1), dtype=torch.int32, device=dev)
    g = 0 if smem else B  # the rows of global scratch
    smnx = torch.empty((g, max(m, 1)), dtype=torch.int32, device=dev)
    best = torch.empty((g, m + 1), dtype=torch.int64, device=dev)
    _PARTITION(sig.data_ptr(), B, L, n.data_ptr(), step, m, cmnx.data_ptr(),
               smnx.data_ptr(), best.data_ptr(), prev.data_ptr(),
               cut.data_ptr(), threads(m), smem, stream_ptr(dev))
    return cut
