"""Observability: phase timers and CUDA trace capture.

The port's copy of honours_tpu/utils/profiling.py: the reference's
three-phase clock() timing (press/test.h:8) as named, accumulating
scopes, and a torch.profiler capture in place of the jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating named timers (perf_counter).

    `phase(name, device)` times a region on the host clock.  When
    `device` is a CUDA device the region starts and ends with a
    torch.cuda.synchronize of that device, so its time includes the
    kernels it queued (and none queued before it); on the CPU, or with
    no device, nothing is synchronized."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}\t{self.totals[name]:.6f}s\t{self.counts[name]}x"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def cuda_trace(logdir: str):
    """Capture a torch.profiler trace of a region (host ops, and the
    card's kernels where CUDA is available) and write it as a Chrome
    trace, `logdir`/trace.json (view in chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
