"""Time kernel A (honours_tpu_torch/csrc/segment.cu) against variants of
itself on one CUDA card, in turns, at chip_smoke.py's four shapes.

    python tools/segment_variants.py

Each variant is the kernel's source with a few lines replaced (VARIANTS),
compiled with the package's nvcc flags; every variant's output must equal
the plain version (tolerance 0), or the run fails.  Prints the card, then
one line a shape: each variant's ms on the card (a replayed CUDA graph of
5 calls, chip_smoke.graph_ms), in the order kernel, variants, variants
reversed, kernel.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: name -> (old, new) replacements in segment.cu
VARIANTS = {
    "512 threads x 128": [("constexpr int THREADS = 256;",
                           "constexpr int THREADS = 512;"),
                          ("constexpr int CHUNK = 256;",
                           "constexpr int CHUNK = 128;"),
                          ("constexpr int GROUP = 8;",
                           "constexpr int GROUP = 16;")],
    "1024 threads x 64": [("constexpr int THREADS = 256;",
                           "constexpr int THREADS = 1024;"),
                          ("constexpr int CHUNK = 256;",
                           "constexpr int CHUNK = 64;"),
                          ("constexpr int GROUP = 8;",
                           "constexpr int GROUP = 32;")],
    "groups of 4": [("constexpr int GROUP = 8;", "constexpr int GROUP = 4;")],
    "no group steps": [("    if (j % GROUP == 0 && j + GROUP <= nch &&",
                        "    if (false && j + GROUP <= nch &&")],
    "no register cap": [("__launch_bounds__(THREADS, 2)",
                         "__launch_bounds__(THREADS)")],
}


def build(name: str, src: str, out: Path) -> subprocess.Popen:
    from honours_tpu_torch import _build

    path = out / f"{name.replace(' ', '_')}.cu"
    path.write_text(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(so: Path):
    from honours_tpu_torch import _build

    lib = ctypes.CDLL(str(so))
    fn = lib.htt_find_stall
    fn.argtypes = [_build._ARG[c] for c in "pplllpppp"]
    fn.restype = ctypes.c_int
    lib.htt_error_string.restype = ctypes.c_char_p
    lib.htt_error_string.argtypes = [ctypes.c_int]
    return fn, lib


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from honours_tpu_torch import _build
    from honours_tpu_torch.segment import segment_cuda as S

    src = (_build.CSRC / "segment.cu").read_text()
    out = Path(tempfile.mkdtemp(prefix="segment_variants_"))
    procs = {"kernel": build("kernel", src, out)}
    for name, subs in VARIANTS.items():
        v = src
        for old, new in subs:
            if v.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in segment.cu")
            v = v.replace(old, new)
        procs[name] = build(name, v, out)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fns[name] = entry(out / f"{name.replace(' ', '_')}.so")
    print(f"device: {torch.cuda.get_device_name(0)}; {C.nvidia_smi()}",
          flush=True)
    shapes = [("[256, 65536]", C.make_bucket(0)),
              ("[1, 262144]", C.make_bucket(0, B=1, L=1 << 18)),
              ("fixture reads", C.rows_on_card(C.fixture_reads())),
              ("stall set", C.rows_on_card(C.stall_set(0)))]
    order = list(fns) + list(fns)[::-1]
    for label, (sig, n) in shapes:
        n32 = n.to(torch.int32).contiguous()
        want = [t.cpu() for t in S.find_stall_plain(sig, n32)]
        ms = {}
        for name in order:
            S._FIND._fn, S._FIND._lib = fns[name]
            t, got = C.graph_ms(lambda: S.find_stall(sig, n32), 5)
            if C.max_abs_err([x.cpu() for x in got], want):
                raise AssertionError(f"{name} differs from plain at {label}")
            ms.setdefault(name, []).append(t)
        print(f"{label} {tuple(sig.shape)}: " + "; ".join(
            f"{k} {' '.join(f'{v:.4f}' for v in vs)}" for k, vs in ms.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
