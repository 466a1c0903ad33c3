"""Command-line interface of the port.

  python -m honours_tpu_torch press   IN.blow5 OUT.blow5 [--codec NAME]
                                      [--device cuda|cpu]
  python -m honours_tpu_torch depress IN.blow5 OUT.blow5 [--device cuda|cpu]
  python -m honours_tpu_torch bench   IN.blow5 [--methods a,b] [--list]
                                      [--device cuda|cpu]
  python -m honours_tpu_torch analyze IN.blow5 [--per-read]
                                      [--device cuda|cpu]
  python -m honours_tpu_torch codecs

`press` rewrites a SLOW5/BLOW5 file with the signal field compressed by
a ported codec (default drans_vbbe21_zd; any of the 106 of
engine.runner.CODECS) through the bucketed runner;
`depress` restores a stock BLOW5 (svb-zd signal, zlib records).  The
files are byte-identical to `python -m honours_tpu press --tpu` /
`depress --tpu`.  `bench` round-trips every read through each engine
codec (default the 21; --methods takes any ported codec) and prints the
reference driver's TSV, one row a codec (bench/harness.py; `python -m
honours_tpu bench --tpu`'s rows);
`analyze` prints the signal statistics report (analysis.py) as JSON, the
aggregate or, with --per-read, the whole report, as
`python -m honours_tpu analyze` does.  All four run on the CUDA card and
raise without one unless `--device cpu` is given.  `codecs` lists the 106
ported codecs; any other name raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="honours_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("press", help="compress the signal field with a codec")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--codec", default="drans_vbbe21_zd")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    d = sub.add_parser("depress", help="restore stock BLOW5")
    d.add_argument("infile")
    d.add_argument("outfile")
    d.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    b = sub.add_parser("bench", help="round-trip benchmark (reference TSV)")
    b.add_argument("file")
    b.add_argument("--methods", default=None)
    b.add_argument("--list", action="store_true")
    b.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    a = sub.add_parser("analyze", help="signal statistics report (viz/ role)")
    a.add_argument("file")
    a.add_argument("--per-read", action="store_true")
    a.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    sub.add_parser("codecs", help="list the ported codecs")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        from honours_tpu_torch.bench import harness

        forward = [args.file, "--device", args.device]
        if args.methods:
            forward += ["--methods", args.methods]
        if args.list:
            forward += ["--list"]
        return harness.main(forward)

    from honours_tpu_torch.engine import runner

    if args.cmd == "codecs":
        for name in runner.codec_names():
            print(name)
        return 0

    from honours_tpu_torch.device import resolve_device
    from honours_tpu_torch.io import blow5

    dev = resolve_device(args.device)
    if args.cmd == "analyze":
        import json

        from honours_tpu_torch import analysis

        rep = analysis.analyze_reads(
            [r.signal for r in blow5.read_blow5(args.file, device=dev).reads],
            device=dev)
        if not args.per_read:
            rep = rep["aggregate"]
        print(json.dumps(rep, indent=1))
        return 0
    if args.cmd == "press":
        runner.engine_kind(args.codec)  # NotImplementedError if unknown
        f5 = blow5.read_blow5(args.infile, device=dev)
        streams = runner.press_signals([r.signal for r in f5.reads],
                                       args.codec, device=dev)
        blow5.write_blow5(args.outfile, f5, signal_codec=args.codec,
                          signal_streams=streams)
    else:
        f5 = blow5.read_blow5(args.infile, device=dev)
        f5.signal_press = blow5.SIGNAL_PRESS_SVB_ZD
        blow5.write_blow5(args.outfile, f5)
    print(f"{args.infile} ({os.path.getsize(args.infile)} B) -> "
          f"{args.outfile} ({os.path.getsize(args.outfile)} B)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
