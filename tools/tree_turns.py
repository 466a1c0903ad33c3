"""Time kernels and codec paths of two trees of the port on the card, in
turns.

    python3 tools/tree_turns.py PARENT CHANGE [--order pccp]
        [--kernels zsm_mean,rccdf_encode,rccdf_decode]
        [--codecs uint_zsm,rccdf_vbbe21_zd] [--passes 2]

PARENT and CHANGE are directories that each hold a tree of this repo
(for example a `git archive` of a commit unpacked under build/).  Each
turn of --order (p the parent, c the change) is a process of its own
whose honours_tpu_torch is that tree's (its kernels built there) and
which loads this repo's chip_smoke.py by path.  A turn holds each kernel
of --kernels against its plain version and times it on chip_smoke.py's
cases of it (time_case, log_case: the bucket [256, 65536] of phases 11
and 12 with their options, such as kernel I on turbopfor's and flats'
rows, "bitpack_msb turbopfor", which the kernel's name selects too,
kernel L's rows of zsm_cases, F's and G's of rccdf_row_cases and, for
flats_partition, K's wider buckets of flats_bucket_cases and reads of
flats_scratch_cases), then
runs each codec of
--codecs over chip_smoke.read_set(0), the main path's 1,028 reads,
--passes times (rc_path: every read back bit for bit, ratio, encode and
decode MB/s).  Every line a turn prints starts with its tree and turn.
Prints the card's name and power limit first.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def smoke():
    """This repo's chip_smoke.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def turn(tag: str, kernels: list, codecs: list, passes: int) -> None:
    """One turn, in a process whose honours_tpu_torch is its tree's."""
    cs = smoke()
    from honours_tpu_torch import _build

    cs.log = lambda *a: print(tag, *a, flush=True)
    _build.build()
    smi = cs.nvidia_smi()
    if kernels:
        sig, n = cs.make_bucket(0)
        found = [("[256, 65536]", c) for c in cs.entropy_cases(sig, n)
                 + sum(cs.raw_cases(sig, n), [])] + cs.zsm_cases(sig, n) \
            + cs.rccdf_row_cases(sig.device)
        if "flats_partition" in kernels:
            found += cs.flats_bucket_cases(sig.device) \
                + cs.flats_scratch_cases(sig.device)
        for shape, case in found:
            if case[0] in kernels or case[0].split()[0] in kernels:
                cs.log_case(f"{shape} ({smi})", cs.time_case(*case))
    if codecs:
        reads = cs.read_set(0)
        for _ in range(passes):
            for codec in codecs:
                cs.rc_path(codec, reads, smi, want=set(), tag="path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--kernels", default="")
    ap.add_argument("--codecs", default="")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    codecs = [c for c in args.codecs.split(",") if c]
    if args.turn:
        turn(args.turn, kernels, codecs, args.passes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tree_turns: CUDA is not available", file=sys.stderr)
        return 2
    print(smoke().nvidia_smi(), flush=True)
    trees = {"p": args.parent.resolve(), "c": args.change.resolve()}
    for i, side in enumerate(args.order):
        tree = trees[side]
        env = dict(os.environ, PYTHONPATH=str(tree))
        rc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), str(trees["p"]),
             str(trees["c"]), "--kernels", args.kernels, "--codecs",
             args.codecs, "--passes", str(args.passes), "--turn",
             f"[{side}{i + 1} {tree.name}]"], cwd=tree, env=env).returncode
        if rc:
            print(f"tree_turns: turn {side}{i + 1} exited {rc}",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
