"""Kernel L: uint_zsm's running mean (csrc/zsm.cu), beside its plain
version (engine/uint.py zsm_mean_plain).

No TPU kernel stands behind it: honours_tpu takes the mean on the host
only (honours_tpu/codecs/uintc.py UintZsmCodec._mean16).  The wrapper
routes by device: CPU tensors take the plain version, CUDA tensors
launch the kernel, a block a read: the read's exact sum settles its mean
unless the mean lies near a nonzero integer, and then the block's first
thread walks the float64 chain.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.uint import zsm_mean_plain

_MEAN = kernel("zsm_mean", "zsm.cu", "htt_zsm_mean", "pllppp")


def zsm_mean(sig, n):
    """sig [B, L] int16, n [B] int32 (clamped to [0, L]) -> [B] int64:
    each row's float64 running mean of its first n samples, truncated
    toward zero (0 for an empty row), bit for bit _mean16's."""
    if is_cpu(sig, n):
        return zsm_mean_plain(sig, n)
    check(sig, "sig", (torch.int16,))
    if sig.dim() != 2:
        raise ValueError(f"sig: shape {tuple(sig.shape)} is not [B, L]")
    B, L = sig.shape
    check(n, "n", (torch.int32,), (B,))
    out = torch.empty((B,), dtype=torch.int64, device=sig.device)
    _MEAN(sig.data_ptr(), B, L, n.data_ptr(), out.data_ptr(),
          stream_ptr(sig.device))
    return out
