"""Benchmark harness: round-trip the ported codecs over a SLOW5/BLOW5 file.

The port of honours_tpu/bench/harness.py's batched-engine route
(`--tpu`): one row a codec in the reference driver's TSV schema
(press/test.h:47-54),
  method  pressbound_bytes  press_bytes  press_ratio  depress_bytes
  pressbound_time  press_time  depress_time
with press_ratio = depress_bytes / press_bytes (press/test.c:40), totals
over all reads, and every read verified sample for sample (the lossless
check is the test, press/test.c:402-405).  pressbound_bytes is the host
codecs' bound (engine/bounds.py).  Reads run through
engine.runner.press_signals / depress_signals on the device.  The rows
are the 21 engine codecs by default; --methods takes any of the 106
ported codecs (the range-coder, per-read entropy, raw-sample, block and
byte-layer codecs too, which the JAX harness runs on the host only).

Usage:
  python -m honours_tpu_torch.bench.harness FILE.blow5 [--methods a,b,...]
      [--list] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from honours_tpu_torch.device import resolve_device
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound as bound_of
from honours_tpu_torch.io.blow5 import read_blow5

HDR = (
    "method\tpressbound_bytes\tpress_bytes\tpress_ratio\tdepress_bytes\t"
    "pressbound_time\tpress_time\tdepress_time"
)


def run_method_tpu(name: str, signals, out=None, device="cuda"):
    """One TSV row for a ported codec through the bucketed runner on
    `device` (named after the JAX harness's batched-engine route).

    press_time and depress_time are end-to-end wall times of the user
    path on the host clock: bucketing, uploads, the kernels, the
    one-row re-encodes of reads past the exception cap, and the copies
    back.  Each ends once the runner has handed its bytes or arrays to
    the host, so the card's work is inside it; first-use costs (a
    kernel build, the tables' upload) fall in the first codec's row."""
    out = out or sys.stdout
    raw = sum(s.size * 2 for s in signals)
    t0 = time.perf_counter()
    bound = sum(bound_of(name, s.size) for s in signals)
    t1 = time.perf_counter()
    streams = runner.press_signals(signals, name, device=device)
    t2 = time.perf_counter()
    back = runner.depress_signals(streams, [s.size for s in signals], name,
                                  device=device)
    t3 = time.perf_counter()
    for idx, (sig, dec) in enumerate(zip(signals, back)):
        if not np.array_equal(dec, sig):
            raise AssertionError(f"{name} [{device}]: lossless check failed "
                                 f"read {idx}")
    press = sum(len(s) for s in streams)
    print(
        f"{name}\t{bound:.1f}\t{press:.1f}\t{raw / press:.6f}\t{raw:.1f}\t"
        f"{t1 - t0:.6f}\t{t2 - t1:.6f}\t{t3 - t2:.6f}",
        file=out,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="honours_tpu_torch.bench.harness")
    ap.add_argument("file")
    ap.add_argument("--methods", default=None,
                    help="comma-separated ported codecs (default: the 21 "
                    "engine codecs)")
    ap.add_argument("--list", action="store_true",
                    help="print the engine codecs and stop")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(runner.engine_codec_names()))
        return 0
    dev = resolve_device(args.device)
    signals = [r.signal for r in read_blow5(args.file, device=dev).reads]
    methods = (args.methods.split(",") if args.methods
               else runner.engine_codec_names())
    print(HDR)
    for m in methods:
        run_method_tpu(m, signals, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
