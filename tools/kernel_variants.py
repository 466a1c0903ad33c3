"""Time variants of a kernel's CUDA source on the card, in turns.

    python3 tools/kernel_variants.py NAME VARIANT.cu [VARIANT.cu ...]

NAME is n4_decode, svb16_decode, svb16_decode_raw (zd off),
svb16_encode, svb16_encode_raw (zd off), flac_decode, huffman_build,
rccdf_encode, rccdf_decode, zsm_mean, bitpack_msb, bitunpack_msb,
flats_partition, or rc_encode_MODEL /
rc_decode_MODEL (MODEL o0, o1 or cm).  Each VARIANT.cu is an edited copy
of the kernel's source (honours_tpu_torch/csrc/*.cu) whose C entries
keep their signatures.  Each is built with the package's nvcc flags (all
in parallel), and its entry stands in for the kernel's while it is
timed.  At chip_smoke.py's shapes, a bucket of [256, 65536] and one read
of [1, 262144], every variant is held against the plain version (max
abs err printed) and timed from a CUDA-graph replay, twice: in the order
given, then in reverse.  flac_decode (on flac's streams of the bucket)
and huffman_build (on the histograms of its residual bytes) run at the
bucket only, chip_smoke.py's cases of them; rccdf_encode and
rccdf_decode at the bucket (rccdf_vbbe21_zd's residual bytes) and on
chip_smoke.rc_rows' [24, 4096] edge rows; zsm_mean at the bucket, on
chip_smoke.zsm_cases' edge and banded reads and on the bucket with every
read flagged; bitpack_msb on uint_zd's fields of the bucket and on the
rows turbopfor's and flat_uint_submin's presses of it give the kernel,
bitunpack_msb on its packed rows and on the rows their depresses give
it; flats_partition on the bucket at step 64, on
chip_smoke.flats_bucket_cases' wider buckets (m = 2,048, 4,096 and
8,192) and on chip_smoke.flats_scratch_cases' reads (m = 32,768 and
65,536).
The range
coder runs at the bucket only (chip_smoke.rc_bucket's rows), held
against the tree's own kernel: its streams for rc_encode, the rows for
rc_decode (the plain cm coder takes minutes a row there; chip_smoke.py
holds the kernel to it).  A svb16
variant may change DTILE or ETILE; the wrapper's tile count then
follows it.  Needs CUDA.
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
from honours_tpu_torch.engine import bitpack_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import flac_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import flats_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import huffman  # noqa: E402,F401
from honours_tpu_torch.engine import rangecoder_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import rans_n4_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import rccdf_cuda  # noqa: E402,F401
from honours_tpu_torch.engine import svb16_cuda as SV  # noqa: E402
from honours_tpu_torch.engine import zsm_cuda  # noqa: E402,F401


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


#: kernels timed on chip_smoke.py's cases of them (phases 11-13)
SMOKE_CASES = ("flac_decode", "huffman_build", "rccdf_encode",
               "rccdf_decode", "zsm_mean", "bitpack_msb", "bitunpack_msb",
               "flats_partition")
#: the kernels of chip_smoke.raw_cases
RAW = ("zsm_mean", "bitpack_msb", "bitunpack_msb", "flats_partition")


def smoke_cases(name: str) -> list:
    """[(shape, kernel call, plain call)] of a SMOKE_CASES kernel: on the
    bucket [256, 65536] as chip_smoke.py's phases 13, 11 and 12 make
    them (bitpack_msb and bitunpack_msb also on turbopfor's and flats'
    rows of it, the options of raw_cases), for rccdf_encode and
    rccdf_decode also on chip_smoke.py's rc_rows (rccdf_row_cases), for
    zsm_mean on its rows of it (zsm_cases) and for flats_partition on
    the wider buckets of flats_bucket_cases and the reads of
    flats_scratch_cases."""
    sig, n = cs.make_bucket(0)
    bucket = (cs.block_cases(sig, n)[0] if name == "flac_decode"
              else sum(cs.raw_cases(sig, n), []) if name in RAW
              else cs.entropy_cases(sig, n))
    found = [("[256, 65536]" + c[0][len(name):], c) for c in bucket] + (
        cs.zsm_cases(sig, n) if name == "zsm_mean"
        else cs.rccdf_row_cases(sig.device) if name.startswith("rccdf")
        else cs.flats_bucket_cases(sig.device)
        + cs.flats_scratch_cases(sig.device) if name == "flats_partition"
        else [])
    return [(shape, c[1], c[2]) for shape, c in found
            if c[0].split()[0] == name]


def rc_cases() -> dict:
    """{rc_encode_MODEL / rc_decode_MODEL: (kernel call, the tree's
    kernel's output)} on chip_smoke.rc_bucket's rows, computed before any
    variant stands in."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC
    from honours_tpu_torch.engine.rc import vb_zd_parts

    sig, n = cs.make_bucket(0)
    _, _, data, dlen = vb_zd_parts(sig, n, "vbbe21", sig.shape[1])
    data, dlen = data.contiguous(), dlen.to(torch.int32).contiguous()
    zero = torch.zeros_like(dlen)
    out = {}
    for m in ("o0", "o1", "cm"):
        enc = RC.rc_encode(data, dlen, m)
        out[f"rc_encode_{m}"] = (
            lambda m=m: RC.rc_encode_launch(data, dlen, m), lambda e=enc: e)
        out[f"rc_decode_{m}"] = (
            lambda m=m, s=enc[0]: RC.rc_decode(s, zero, dlen, data.shape[1],
                                               m),
            lambda: data)
    return out


def main(argv) -> int:
    if len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    name, sources = argv[0], argv[1:]
    rc = name.startswith("rc_")
    kernel = _build.KERNELS[name[:9] if rc else name.removesuffix("_raw")]
    _build.build()
    print(cs.nvidia_smi(), flush=True)
    tiles = SV.DECODE_TILE, SV.ENCODE_TILE
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build(sources, Path(tmp))
        shapes = ([("[256, 65536]", *rc_cases()[name])] if rc
                  else smoke_cases(name) if name in SMOKE_CASES
                  else [(f"[{B}, {L}]", *cases(B, L)[name])
                        for B, L in ((256, 1 << 16), (1, 1 << 18))])
        for shape, kern, plain in shapes:
            want = cs.flatten(plain())
            times = {s: [] for s in sources}
            for order in (sources, sources[::-1]):
                for src in order:
                    use(kernel, libs[src], src)
                    err = cs.max_abs_err(cs.flatten(kern()), want)
                    reps = (2 if rc else 3 if name in ("n4_decode",
                                                       "flac_decode")
                            else 20)
                    times[src].append(f"{cs.graph_ms(kern, reps)[0]:.4f} ms "
                                      f"(max abs err {err})")
                    SV.DECODE_TILE, SV.ENCODE_TILE = tiles
            for src in sources:
                print(f"{shape} {name} {Path(src).name}: "
                      + "; ".join(times[src]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
