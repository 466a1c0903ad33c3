"""Every engine codec over the long-read set on the card, part by part.

    python tools/long_reads_probe.py [codec ...]

The parts: (e) one read of 262,145 samples, (d) 600,000 full-range
random samples (over the exception cap), (c) one read of 4,194,000,
(b8) 8 reads in (2^20, 2^21], (a16) 16 and (a256) 256 reads in
(2^19, 2^20] (synthetic, synth.py, seeded).  Each part is pressed and
depressed through engine.runner.press_signals / depress_signals on
the card, so each is one bucket (a256's overflow-free reads fill one
[256, 2^20] bucket).  Prints a JSON line a codec and part: round trip,
ratio, encode and decode seconds, the peak of
torch.cuda.max_memory_allocated() above what was allocated before, for
the press and the depress, each over the bucket's slots.  An out-of-memory error is recorded on its line and
the next part runs; any other error stops the probe.  Needs a CUDA
device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def reads_of(lens, seed):
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus(int(sum(lens)), seed=seed)
    return np.split(flat, np.cumsum(lens)[:-1])


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("long_reads_probe: CUDA is not available", file=sys.stderr)
        return 2
    from honours_tpu_torch import _build
    from honours_tpu_torch.engine.runner import (
        ENGINE_CODECS,
        depress_signals,
        press_signals,
    )

    def rec(**k):
        print(json.dumps(k), flush=True)

    t = time.perf_counter()
    _build.build()
    rec(build_s=time.perf_counter() - t)
    rng = np.random.default_rng(17)
    a = reads_of(rng.integers((1 << 19) + 1, (1 << 20) + 1, 256), 1)
    b = reads_of(rng.integers((1 << 20) + 1, (1 << 21) + 1, 8), 2)
    c = reads_of([4_194_000], 3)
    d = [rng.integers(-32768, 32768, 600_000).astype(np.int16)]
    e = reads_of([262_145], 4)
    parts = [("e", e), ("d", d), ("c", c), ("b8", b), ("a16", a[:16]),
             ("a256", a)]
    argv = sys.argv[1:] if argv is None else argv
    for codec in argv or list(ENGINE_CODECS):
        for name, reads in parts:
            torch.cuda.empty_cache()
            lens = [r.size for r in reads]
            L = 1 << int(np.ceil(np.log2(max(lens))))
            slots = len(reads) * L
            try:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                st = press_signals(reads, codec)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pk_e = torch.cuda.max_memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
                out = depress_signals(st, lens, codec)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                pk_d = torch.cuda.max_memory_allocated() - base
                rec(codec=codec, g=name, B=len(reads), L=L,
                    ok=all(np.array_equal(x, y) for x, y in zip(reads, out)),
                    ratio=2 * sum(lens) / sum(len(s) for s in st),
                    enc_s=t1 - t0, dec_s=t2 - t1, peak_enc=pk_e,
                    peak_dec=pk_d, bps_enc=pk_e / slots,
                    bps_dec=pk_d / slots)
            except torch.OutOfMemoryError as err:
                rec(codec=codec, g=name, B=len(reads), L=L,
                    oom=str(err)[:300])
    return 0


if __name__ == "__main__":
    sys.exit(main())
