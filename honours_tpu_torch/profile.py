"""Where one bucket's encode and decode spend their time on the card.

    python -m honours_tpu_torch.profile [codec]

Presses and depresses one bucket of 256 synthetic reads at L = 65536
(the main path's bucket shape; lengths uniform in (L/2, L], seed 0)
through the codec's batched engine (default drans_vbbe21_zd; any name
of engine.runner.ENGINE_CODECS) under torch.profiler, after a warm-up
pass, and prints for each direction: wall time (host clock ending in a
synchronize), device busy time (sum of kernel times), the device's idle
share, and the top kernels by device time.  Needs CUDA.
"""

from __future__ import annotations

import sys
import time

import torch


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _report(label: str, prof, wall_s: float) -> None:
    """wall_s is an unprofiled run's; busy time is the profiled run's."""
    from torch.autograd import DeviceType

    # device-side events only: each aten op's row repeats its kernels' time
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"{label}: wall {wall_s * 1e3:.3f} ms (unprofiled), kernel time "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / 1e3 / (wall_s * 1e3):.3f}")
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


B, L, TOP = 256, 1 << 16, 25


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    codec = args[0] if args else "drans_vbbe21_zd"
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from honours_tpu_torch.engine.runner import batch_engine
    from honours_tpu_torch.synth import synthesize_bucket

    dev = torch.device("cuda")
    emax = max(64, L // 16)
    press, depress = batch_engine(codec, dev)
    sig, n = (torch.from_numpy(a).to(dev) for a in synthesize_bucket(B, L))
    st, _ = press(sig, n, emax)
    depress(st, n, L, emax)
    torch.cuda.synchronize()

    def enc():
        return press(sig, n, emax)[0]

    def dec():
        return depress(st, n, L, emax)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    _, enc_s = _timed(enc)
    with profile(activities=acts) as prof:
        _timed(enc)
    _report(f"{codec} encode [{B}, {L}]", prof, enc_s)
    out, dec_s = _timed(dec)
    with profile(activities=acts) as prof:
        _timed(dec)
    _report(f"{codec} decode [{B}, {L}]", prof, dec_s)
    if not torch.equal(out, sig):
        print("profile: decode does not return the input", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
