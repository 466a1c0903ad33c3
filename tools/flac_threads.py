"""Time kernel N (honours_tpu_torch/csrc/flac.cu) at several block sizes
on one CUDA card, in turns, at the main path's bucket [256, 65536].

    python tools/flac_threads.py

Each variant is the kernel's source with THREADS (threads a block, a
thread a read) set to 1, 2, 4, 8, 16 or 32, compiled with the package's
nvcc flags into a temporary directory.  The bucket's flac streams come
from engine/flac.py's press of synthetic reads (synth.py, seed 0); every
variant's output must equal the committed kernel's, which must equal the
plain version and the reads (tolerance 0), or the run fails.  Prints one
line a variant: its ms on the card over 3 rounds (CUDA events around 3
calls after a checked call; the variants in order, then reversed, then
in order), then the card's name and power limit.  Exits non-zero without
CUDA.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZES = (1, 2, 4, 8, 16, 32)


def build(out_dir: Path) -> dict:
    """THREADS -> the C entry of flac.cu compiled with that block size."""
    from honours_tpu_torch import _build

    src = (_build.CSRC / "flac.cu").read_text()
    procs = []
    for t in SIZES:
        cu = out_dir / f"flac_t{t}.cu"
        cu.write_text(re.sub(r"constexpr int THREADS = \d+;",
                             f"constexpr int THREADS = {t};", src))
        so = out_dir / f"flac_t{t}.so"
        procs.append((t, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)])))
    entries = {}
    for t, so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for THREADS = {t}")
        fn = ctypes.CDLL(str(so)).htt_flac_decode
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[t] = fn
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("flac_threads: CUDA is not available", file=sys.stderr)
        return 2
    from honours_tpu_torch.engine import flac, flac_cuda
    from honours_tpu_torch.synth import synthesize_bucket

    dev = torch.device("cuda")
    sig, n = synthesize_bucket(256, 1 << 16, 0)
    sig = torch.from_numpy(sig).to(dev)
    n32 = torch.from_numpy(n).to(torch.int32).to(dev)
    st, _ = flac.press_flac_batch(sig, n32)
    st = st.contiguous()
    (B, M), L = st.shape, sig.shape[1]
    want = flac_cuda.flac_decode(st, n32, L)
    if not (torch.equal(want, flac_cuda.flac_decode_plain(st, n32, L))
            and torch.equal(want, sig)):
        raise AssertionError("flac_decode differs from its plain version")

    def run(fn):
        out = torch.empty((B, L), dtype=torch.int16, device=dev)
        err = fn(st.data_ptr(), B, M, n32.data_ptr(), L, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"htt_flac_decode: CUDA error {err}")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp))
        times = {t: [] for t in SIZES}
        for rnd in range(3):
            for t in (SIZES if rnd % 2 == 0 else SIZES[::-1]):
                if not torch.equal(run(entries[t]), want):
                    raise AssertionError(f"THREADS = {t}: output differs")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run(entries[t])
                end.record()
                torch.cuda.synchronize()
                times[t].append(start.elapsed_time(end) / 3)
    for t, ms in times.items():
        print(f"flac_decode THREADS={t}: "
              + ", ".join(f"{x:.4f}" for x in ms) + " ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
