"""Device memory a bucket slot takes, for each codec, on the card.

    python tools/bytes_a_slot.py [--B 16] [--L 1048576] [--rc] [--entropy]
        [--raw] [--block] [codec ...]

For each codec (the 21 engine codecs by default, the 25 range-coder
codecs with --rc, the 11 per-read entropy codecs with --entropy, the 16
raw-sample and bit-packing codecs with --raw, turbopfor, flac and none
with --block; a byte-layer codec takes its inner codec's bytes, as its
layer runs on the host)
presses and depresses one unsliced bucket of B synthetic reads (lengths
uniform in (L/2, L], synth.py, seed 0) through
engine.runner.press_bucket / depress_bucket with rows = B, and prints
one JSON line: the peak of torch.cuda.max_memory_allocated() above what
was allocated before, for the press and for the depress, and each over
the bucket's B * L slots.  engine.runner.BYTES_A_SLOT holds the larger
of the two, rounded up.  A range-coder or entropy codec's peak holds its
rows' coder state or tables too (engine.runner.ROW_BYTES), so for those
the line also gives the fit of a second bucket at L / 4: bytes a slot from the
difference of the two peaks, bytes a row from what is left
(fit_bytes_a_slot, fit_bytes_a_row).  The last line is the card's name
and power limit (nvidia-smi).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def measure(codec: str, sig: np.ndarray, n: np.ndarray) -> dict:
    from honours_tpu_torch.engine.runner import depress_bucket, press_bucket

    B, L = sig.shape
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    streams = press_bucket(sig, n, codec, rows=B)
    torch.cuda.synchronize()
    enc = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    out = depress_bucket(streams, n, L, codec, rows=B)
    torch.cuda.synchronize()
    dec = torch.cuda.max_memory_allocated() - base
    # uint11 keeps each sample's low 11 bits, as the host codec does
    want = sig & 0x7FF if codec == "uint11" else sig
    if not all(np.array_equal(out[j], want[j, : n[j]]) for j in range(B)):
        raise AssertionError(f"{codec}: a read did not round-trip")
    slots = B * L
    return {"codec": codec, "B": B, "L": L, "peak_press": enc,
            "peak_depress": dec, "press_bytes_a_slot": enc / slots,
            "depress_bytes_a_slot": dec / slots,
            "bytes_a_slot": math.ceil(max(enc, dec) / slots)}


def fit(codec: str, B: int, L: int, line: dict) -> dict:
    """line (measured at [B, L]) with the two-point fit against [B, L/4]:
    peak = a * B * L + r * B."""
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(B, L // 4, seed=0)
    small = measure(codec, sig, n)
    big = max(line["peak_press"], line["peak_depress"])
    little = max(small["peak_press"], small["peak_depress"])
    a = (big - little) / (B * (L - L // 4))
    return {**line, "fit_bytes_a_slot": a,
            "fit_bytes_a_row": (big - a * B * L) / B}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("codecs", nargs="*")
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--L", type=int, default=1 << 20)
    ap.add_argument("--rc", action="store_true",
                    help="the 25 range-coder codecs (runner.RC_CODECS)")
    ap.add_argument("--entropy", action="store_true",
                    help="the 11 per-read entropy codecs "
                    "(runner.ENTROPY_CODECS)")
    ap.add_argument("--raw", action="store_true",
                    help="the 16 raw-sample and bit-packing codecs "
                    "(runner.RAW_CODECS)")
    ap.add_argument("--block", action="store_true",
                    help="turbopfor, flac and none (runner.BLOCK_CODECS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bytes_a_slot: CUDA is not available", file=sys.stderr)
        return 2
    from honours_tpu_torch.engine.runner import (
        BLOCK_CODECS,
        ENGINE_CODECS,
        ENTROPY_CODECS,
        RAW_CODECS,
        RC_CODECS,
        engine_codec_names,
    )
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(args.B, args.L, seed=0)
    codecs = args.codecs or (sorted(RC_CODECS) if args.rc
                             else sorted(ENTROPY_CODECS) if args.entropy
                             else sorted(RAW_CODECS) if args.raw
                             else sorted(BLOCK_CODECS) if args.block
                             else engine_codec_names())
    for codec in codecs:
        line = measure(codec, sig, n)
        if codec not in {**ENGINE_CODECS, **RAW_CODECS, **BLOCK_CODECS}:
            line = fit(codec, args.B, args.L, line)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
