"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device to run on: CUDA unless the caller asks for the CPU.

    Raises RuntimeError when CUDA is asked for (the default) and the
    machine has none; the CPU is never chosen silently."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise RuntimeError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
