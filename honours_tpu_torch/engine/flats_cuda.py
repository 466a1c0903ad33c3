"""Kernel K: flat_uint_submin's optimal step-aligned partition
(csrc/flats.cu), beside its plain version (engine/flats.py
flats_partition_plain).

No TPU kernel stands behind it: honours_tpu partitions on the host only
(honours_tpu/codecs/flats.py partition_flats).  The wrapper routes by
device: CPU tensors take the plain version, CUDA tensors launch the
kernel, one block a read, whose entry picks the block's design from the
tensor's chunks: each index's DP state in registers, in shared memory
where it fits (SMEM_MAX) or in scratch the wrapper allocates
(in_scratch).
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.flats import chunks, flats_partition_plain

_PARTITION = kernel("flats_partition", "flats.cu", "htt_flats_partition",
                    "pllpllppp")

#: csrc/flats.cu SMEM_MAX: the shared memory a block's DP state may take
SMEM_MAX = 200 * 1024


def in_scratch(m: int) -> bool:
    """Whether reads of up to m chunks keep kernel K's DP state in scratch
    the wrapper allocates: where the memory design's (4 B an index of the
    chunks, prev, the ranges and best + 3) passes SMEM_MAX.  The kernel's
    entry picks its design from m, and a register design's state (m <=
    1,024) always fits."""
    return 8 * (2 * m + 1) > SMEM_MAX


def cost_fits_u32(L: int, step: int) -> bool:
    """Whether the kernel's 32-bit costs hold every read of an L-wide
    row at step: a cost is at most 2 n + 6 bytes, and the bound kept is
    2 L + 3 (m + 1) < 2^32."""
    return 2 * L + 3 * (chunks(L, step) + 1) < 1 << 32


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
    if step < 1 or not cost_fits_u32(L, step):
        raise ValueError(f"step {step} at L = {L}: 2 L + 3 (m + 1) must be "
                         "below 2^32 with m = ceil(L / step) chunks")
    m = chunks(L, step)
    dev = sig.device
    cut = torch.empty((B, m + 1), dtype=torch.uint8, device=dev)
    scratch = torch.empty((B if in_scratch(m) else 0, 4 * m + 2),
                          dtype=torch.int32, device=dev)
    _PARTITION(sig.data_ptr(), B, L, n.data_ptr(), min(step, max(L, 1)), m,
               scratch.data_ptr() if scratch.numel() else 0, cut.data_ptr(),
               stream_ptr(dev))
    return cut
