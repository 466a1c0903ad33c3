"""Time variants of a kernel's CUDA source on the card, in turns.

    python3 tools/kernel_variants.py NAME VARIANT.cu [VARIANT.cu ...]

NAME is n4_decode, svb16_decode, svb16_decode_raw (zd off),
svb16_encode or svb16_encode_raw (zd off).  Each VARIANT.cu is an edited copy of the kernel's source
(honours_tpu_torch/csrc/*.cu) whose C entries keep their signatures.
Each is built with the package's nvcc flags (all in parallel), and its
entry stands in for the kernel's while it is timed.  At chip_smoke.py's
shapes, a bucket of [256, 65536] and one read of [1, 262144], every
variant is held against the plain version (max abs err printed) and
timed from a CUDA-graph replay, twice: in the order given, then in
reverse.  A svb16 variant may change DTILE or ETILE; the wrapper's tile
count then follows it.  Needs CUDA.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from honours_tpu_torch import _build  # noqa: E402
from honours_tpu_torch.engine import rans_n4_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import svb16_cuda as SV  # noqa: E402


def build(sources, out_dir: Path) -> dict:
    procs = []
    for src in sources:
        so = out_dir / (Path(src).stem + ".so")
        procs.append((src, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        libs[src] = ctypes.CDLL(str(so))
        libs[src].htt_error_string.restype = ctypes.c_char_p
        libs[src].htt_error_string.argtypes = [ctypes.c_int]
    return libs


def use(kernel, lib, src: str) -> None:
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = [_build._ARG[c] for c in kernel.signature]
    fn.restype = ctypes.c_int
    kernel._fn, kernel._lib = fn, lib
    text = Path(src).read_text()
    for const, attr in (("DTILE", "DECODE_TILE"), ("ETILE", "ENCODE_TILE")):
        m = re.search(r"constexpr int " + const + r" = (\d+);", text)
        if m:
            setattr(SV, attr, int(m.group(1)))


def cases(B: int, L: int) -> dict:
    """{name: (kernel call, plain call)} at one shape."""
    sig, n = cs.make_bucket(0, B=B, L=L)
    main, options, _ = cs.svb_n4_cases(sig, n)
    return {c[0].replace(" zd=False", "_raw"): (c[1], c[2])
            for c in main + options}


def main(argv) -> int:
    if len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    name, sources = argv[0], argv[1:]
    kernel = _build.KERNELS[name.removesuffix("_raw")]
    _build.build()
    print(cs.nvidia_smi(), flush=True)
    tiles = SV.DECODE_TILE, SV.ENCODE_TILE
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(sources, Path(tmp))
        for B, L in ((256, 1 << 16), (1, 1 << 18)):
            kern, plain = cases(B, L)[name]
            want = cs.flatten(plain())
            times = {s: [] for s in sources}
            for order in (sources, sources[::-1]):
                for src in order:
                    use(kernel, libs[src], src)
                    err = cs.max_abs_err(cs.flatten(kern()), want)
                    reps = 3 if name == "n4_decode" else 20
                    times[src].append(f"{cs.graph_ms(kern, reps)[0]:.4f} ms "
                                      f"(max abs err {err})")
                    SV.DECODE_TILE, SV.ENCODE_TILE = tiles
            for src in sources:
                print(f"[{B}, {L}] {name} {Path(src).name}: "
                      + "; ".join(times[src]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
