"""Drive honours_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

1. Prints the card, builds the CUDA kernels (csrc/) and times the build.
2. Holds every kernel against its plain PyTorch version at the main
   paths' shapes (a bucket of 256 synthetic reads at L = 65536): the
   outputs are integers and must be equal.  Times each with CUDA events,
   beside its plain version, a one-call PyTorch yardstick where one
   exists, and its bound (bytes over 3.35 TB/s or integer operations
   over 67 Tops/s, whichever is larger).
3. Presses and depresses ~1,028 reads (1,024 synthetic reads with
   log-uniform lengths in [4,000, 250,000] samples plus edge reads, two
   of which overflow the exception cap) through
   honours_tpu_torch.engine.runner on the card, once per codec
   (drans_vbbe21_zd, svb12_zd, svb12, srans3_vbbe21_zd).  Each path
   starts with every launch count at 0; it asserts every read comes back
   bit for bit, that its own kernels were launched and that the
   overflow reads took the one-row path, prints its ratio and encode and
   decode rates, and checks the card's streams of a few reads against
   the CPU path's.  Every kernel must be launched by some path.
4. Prints one {"kernels": [...]} line, then {"ok": true, "device": ...}.

Exits non-zero, with no result line, when CUDA is unavailable or any
check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # CUDA-core rate (the data sheet's non-tensor fp32)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        "nvidia-smi failed: " + r.stderr.strip())


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                           .abs().max()) if x.numel() else 0)
    return err


def make_bucket(seed: int, B: int = 256, L: int = 1 << 16):
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(B, L, seed)
    return torch.from_numpy(sig).cuda(), torch.from_numpy(n).cuda()


def kernel_cases(seed: int):
    """(name, kernel call, plain call, bytes, ops, library call) at the
    main path's shapes, from one bucket run through the port's stages,
    and the untimed (name, kernel call, plain call) checks of options the
    timed cases leave out."""
    from honours_tpu_torch.engine import drans as D
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine import rans_encode_cuda as E
    from honours_tpu_torch.engine import rans_n4_cuda as N4
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine import svb16_cuda as SV
    from honours_tpu_torch.engine.bits import read_u32le
    from honours_tpu_torch.engine.entropy_o1 import _lane_grid, _rd_states
    from honours_tpu_torch.engine.pipeline import (
        _zd_parts,
        canned_o1_device_tables,
        canned_o1n_device_tables,
        press_srans3_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import (
        vbbe21_parse_batch,
        vbbe21_parts_batch,
        wrap_i32,
    )
    from honours_tpu_torch.kernels.rans import K_SHARED as K
    from honours_tpu_torch.tables.drans import PREFIX_DEN

    sig, n = make_bucket(seed)
    B, L = sig.shape
    emax = max(64, L // 16)
    Smax = L // K
    dev = sig.device
    tabs = canned_o1_device_tables(dev)
    n64 = n.to(torch.int64)
    _, rest = _zd_parts(sig, n64)
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < (n64 - 1)[:, None]
    ex = (rest > 255) & valid
    plain = valid & ~ex
    data_u8 = torch.where(plain, rest & 0xFF, 0).to(torch.uint8)
    comb = torch.where(ex, pos | ((rest.to(torch.int64) - 256) << 16), 0)
    comb = (comb - ((comb >> 31) << 32)).to(torch.int32)
    parts = vbbe21_parts_batch(rest, n64 - 1, emax)
    data, dlen = parts["data"], parts["data_len"]
    S_b = -torch.div(-dlen, K, rounding_mode="floor")
    j = pos
    lg_valid = j < dlen[:, None]
    lg_shift = torch.where(lg_valid, (j // S_b.clamp(min=1)[:, None])
                           * (Smax - S_b[:, None]), 0).to(torch.int32)
    g3, ctx3, act3, S_b = _lane_grid(data, dlen, K, Smax)
    sym = g3.reshape(B, -1).to(torch.int32)
    ctx = ctx3.reshape(B, -1).contiguous()
    fc3 = O.o1_fc(sym, ctx, tabs["cmap"], tabs["fc"]).reshape(B, K, Smax)
    fc = torch.where(act3, fc3, 0).transpose(1, 2).reshape(B, Smax * K)
    fc = fc.contiguous()

    stream, _ = D.press_drans_batch(sig, n, tabs, emax)
    d = D.decode_setup(stream, n64, L, emax)
    T1 = -(-Smax // PREFIX_DEN)
    T2 = Smax - T1
    zeros = torch.zeros_like(d["S_b"])
    cl0 = tabs["cmap"][256].expand(B, K).contiguous()
    args1 = (stream, d["states"], d["dlen"], d["S_b"], tabs["cmap"],
             tabs["cum"], T1, zeros, d["T0_b"], cl0, d["body_off"])
    grid1, fst, fptr = O.o1_decode(*args1)
    include = d["parsed"]["nex"] <= emax
    fit = D.fit_tables_device(D.prefix_counts(grid1, d, include))
    cl2 = D.phase2_setup(grid1, d, fit)
    args2 = (stream, fst, d["dlen"], d["S_b"], fit["cmap"], fit["cum"], T2,
             d["T0_b"], d["S_b"], cl2, fptr)
    _, _, fptr2 = O.o1_decode(*args2)
    consumed = int((fptr2.to(torch.int64)
                    - d["body_off"].to(torch.int64)).sum())

    # ex values and targets placed by the parse: the i32 expansion
    ex_cnt = ex.sum(1)
    eidx = torch.arange(emax, device=dev)[None, :]
    ex_valid = eidx < ex_cnt[:, None]
    ex_pos, _ = P.compact(pos.expand(B, L).to(torch.int32).contiguous(), ex)
    ex_pos = ex_pos[:, :emax].to(torch.int64)
    ex_vals = torch.where(ex_valid, eidx + 300, 0).to(torch.int32)
    ex_shift = torch.where(ex_valid, ex_pos - eidx, 0).to(torch.int32)

    # svb16 on the raw bucket; srans3's v4 body, parsed for kernel 8
    svb, svb_len = SV.svb16_encode(sig, n, True)
    ntabs = canned_o1n_device_tables(dev)
    nt = (ntabs["cmap"], ntabs["lo_assign"], ntabs["fcH"], ntabs["fcL"])
    st3, sl3 = press_srans3_batch(sig, n, ntabs, emax)
    p3 = vbbe21_parse_batch(st3, torch.full_like(n64, 2), n64 - 1, L, emax)
    off3 = p3["end_off"]
    args8 = (st3, _rd_states(st3, off3, K),
             (n64 - 1 - p3["nex"]).to(torch.int32),
             wrap_i32(read_u32le(st3, off3)).to(torch.int32),
             (off3 + 4 + 4 * K).to(torch.int32), *nt)
    body3 = int((sl3 - off3 - 4 - 4 * K).sum())

    BL = B * L
    nsum = int(n64.sum())
    flat_fc = tabs["fc"][tabs["cmap"].to(torch.int64)].reshape(-1)
    flat_idx = ctx.to(torch.int64) * 256 + sym
    cases = [
        ("monotone_compact_u8", lambda: P.compact(data_u8, plain),
         lambda: P.compact_plain(data_u8, plain), 3 * BL, 2 * BL, None),
        ("monotone_compact_i32", lambda: P.compact(comb, ex),
         lambda: P.compact_plain(comb, ex), 9 * BL, 2 * BL, None),
        ("compaction_shifts", lambda: P.compaction_shifts(plain),
         lambda: P.compaction_shifts_plain(plain), 5 * BL, 2 * BL, None),
        ("monotone_expand_u8",
         lambda: P.expand(data, lg_shift, lg_valid, K * Smax),
         lambda: P.expand_plain(data, lg_shift, lg_valid, K * Smax),
         6 * BL + 2 * B * K * Smax, 2 * BL, None),
        ("monotone_expand_i32",
         lambda: P.expand(ex_vals, ex_shift, ex_valid, L),
         lambda: P.expand_plain(ex_vals, ex_shift, ex_valid, L),
         9 * B * emax + 5 * BL, 2 * B * emax, None),
        ("o1_fc", lambda: O.o1_fc(sym, ctx, tabs["cmap"], tabs["fc"]),
         lambda: O.o1_fc_plain(sym, ctx, tabs["cmap"], tabs["fc"]),
         12 * sym.numel(), 4 * sym.numel(),
         lambda: torch.take(flat_fc, flat_idx)),
        ("rans_encode", lambda: E.encode_core(fc, Smax, K),
         lambda: E.encode_core_plain(fc, Smax, K),
         4 * fc.numel() + 4 * fc.numel() + 4 * B * K, 30 * fc.numel(), None),
        ("o1_decode", lambda: (O.o1_decode(*args1), O.o1_decode(*args2)),
         lambda: (O.o1_decode_plain(*args1), O.o1_decode_plain(*args2)),
         consumed + B * K * (T1 + T2) + 4 * 4 * B * K,
         40 * B * K * (T1 + T2), None),
        # samples < n read (2 B), the whole stream row written
        ("svb16_encode", lambda: SV.svb16_encode(sig, n, True),
         lambda: SV.svb16_encode_plain(sig, n, True),
         2 * nsum + svb.numel() + 8 * B, 12 * nsum, None),
        # each row's stream up to its length read, [B, L] int16 written
        ("svb16_decode", lambda: SV.svb16_decode(svb, n, L, True),
         lambda: SV.svb16_decode_plain(svb, n, L, True),
         int(svb_len.sum()) + 2 * BL + 4 * B, 16 * nsum, None),
        ("o1n_fc", lambda: N4.o1n_fc(sym, ctx, *nt),
         lambda: N4.o1n_fc_plain(sym, ctx, *nt),
         16 * sym.numel(), 8 * sym.numel(), None),
        # the v4 bodies consumed, states in, the lane grid out
        ("n4_decode", lambda: N4.n4_decode(*args8, Smax),
         lambda: N4.n4_decode_plain(*args8, Smax),
         body3 + 4 * B * K + 12 * B + B * K * Smax,
         60 * B * K * Smax, None),
    ]
    svb_raw, _ = SV.svb16_encode(sig, n, False)
    untimed = [
        ("svb16_encode zd=False", lambda: SV.svb16_encode(sig, n, False),
         lambda: SV.svb16_encode_plain(sig, n, False)),
        ("svb16_decode zd=False", lambda: SV.svb16_decode(svb_raw, n, L, False),
         lambda: SV.svb16_decode_plain(svb_raw, n, L, False)),
    ]
    return cases, untimed


def flatten(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flatten(y)]
    return [x]


REPLACES = {
    "monotone_compact_u8": "honours_tpu/engine/permute_pallas.py:138",
    "monotone_compact_i32": "honours_tpu/engine/permute_pallas.py:138",
    "compaction_shifts": "honours_tpu/engine/permute_pallas.py:138",
    "monotone_expand_u8": "honours_tpu/engine/permute_pallas.py:138",
    "monotone_expand_i32": "honours_tpu/engine/permute_pallas.py:138",
    "o1_fc": "honours_tpu/engine/rans_o1_pallas.py:147",
    "rans_encode": "honours_tpu/engine/rans_encode_pallas.py:118",
    "o1_decode": "honours_tpu/engine/rans_o1_pallas.py:447",
    "svb16_encode": "honours_tpu/engine/svb16_fused.py:153",
    "svb16_decode": "honours_tpu/engine/svb16_fused.py:266",
    "o1n_fc": "honours_tpu/engine/rans_n4_pallas.py:77",
    "n4_decode": "honours_tpu/engine/rans_n4_pallas.py:245",
}

#: kernels each main path must launch
KERNEL_1 = {"monotone_compact_u8", "monotone_compact_i32",
            "compaction_shifts", "monotone_expand_u8", "monotone_expand_i32"}
PATHS = {
    "drans_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode"},
    "svb12_zd": {"svb16_encode", "svb16_decode"},
    "svb12": {"svb16_encode", "svb16_decode"},
    "srans3_vbbe21_zd": KERNEL_1 | {"rans_encode", "o1n_fc", "n4_decode"},
}


def check_kernels(seed: int) -> dict:
    from honours_tpu_torch._build import KERNELS

    cases, untimed = kernel_cases(seed)
    for name, kern, plain in untimed:
        err = max_abs_err(flatten(kern()), flatten(plain()))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        log(f"kernel {name}: equal to plain (max abs err {err})")
    results = {}
    for name, kern, plain, nbytes, ops, library in cases:
        kern()  # warm-up
        torch.cuda.synchronize()
        got = flatten(kern())
        want, plain_ms = timed_once(plain)
        err = max_abs_err(got, flatten(want))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        reps = 3 if name in ("rans_encode", "o1_decode", "n4_decode") else 20
        ms = cuda_ms(kern, reps)
        library_ms = None
        if library is not None:
            library()
            library_ms = cuda_ms(library, reps)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        results[name] = {
            "name": name, "route": "cuda",
            "source": "honours_tpu_torch/csrc/" + KERNELS[name].source,
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "matches_plain": True, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"kernel {name}: equal to plain (max abs err {err}); "
            f"{ms:.4f} ms vs plain {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({results[name]['bound_by']})"
            + (f", library {library_ms:.4f} ms" if library_ms else ""))
    return results


def read_set(seed: int):
    from honours_tpu_torch.synth import synthesize_corpus

    rng = np.random.default_rng(seed + 1)
    lens = np.exp(rng.uniform(np.log(4000), np.log(250000), 1024))
    lens = lens.astype(np.int64)
    flat = synthesize_corpus(int(lens.sum()), seed=seed + 2)
    reads, off = [], 0
    for m in lens:
        reads.append(flat[off: off + m])
        off += m
    reads += [
        flat[:1].copy(),
        flat[1:8].copy(),
        np.tile(np.array([0, 30000], np.int16), 300),  # overflows emax
        rng.integers(-32768, 32768, 100_000).astype(np.int16),  # overflows
    ]
    return reads


def main_path(codec: str, reads) -> dict:
    """Press and depress `reads` through the runner with `codec`; returns
    this path's launch counts."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        ENGINE_CODECS,
        _emax,
        _nex_overflowed,
        depress_signals,
        press_signals,
    )
    from honours_tpu_torch.io.batching import bucket_reads

    lens = [r.size for r in reads]
    raw = sum(2 * r.size for r in reads)
    warm = reads[:4] + reads[-4:]
    depress_signals(press_signals(warm, codec), [r.size for r in warm], codec)
    torch.cuda.synchronize()

    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    streams = press_signals(reads, codec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = depress_signals(streams, lens, codec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: k.launches for name, k in KERNELS.items()}

    bad = [i for i, (a, b) in enumerate(zip(reads, out))
           if not np.array_equal(a, b)]
    if bad:
        raise AssertionError(f"{codec}: reads {bad[:8]} did not round-trip")
    idle = sorted(k for k in PATHS[codec] if launches[k] == 0)
    if idle:
        raise AssertionError(f"{codec}: kernels not launched: {idle}")
    kind = ENGINE_CODECS[codec]
    if kind in ("drans", "srans3"):
        # the two overflow reads are the last two: their streams carry
        # more exceptions than their bucket's cap, so they were pressed
        # (and decoded) by the one-row path, and they round-tripped
        L_of = {int(i): b.L for b in bucket_reads(reads, max_b=256)
                for i in b.indices}
        i = len(reads) - 2
        if not all(_nex_overflowed(streams[j], kind, _emax(L_of[j]))
                   for j in (i, i + 1)):
            raise AssertionError(f"{codec}: the overflow reads did not "
                                 "overflow the exception cap")
    comp = sum(len(s) for s in streams)
    enc_s, dec_s = t1 - t0, t2 - t1
    log(f"{codec}: all {len(reads)} reads round-trip bit for bit")
    log(f"{codec}: ratio {raw / comp:.6f}")
    log(f"{codec}: encode {enc_s:.3f} s, {raw / enc_s / 1e6:.1f} MB/s")
    log(f"{codec}: decode {dec_s:.3f} s, {raw / dec_s / 1e6:.1f} MB/s")
    log(f"{codec}: launches {launches}")

    # reference on a small input: the CPU path's bytes for a few reads
    small = [reads[i] for i in np.argsort(lens)[:6]]
    if press_signals(small, codec) != press_signals(small, codec,
                                                    device="cpu"):
        raise AssertionError(f"{codec}: card and CPU streams differ on "
                             "small reads")
    log(f"{codec}: card streams equal the CPU path's on {len(small)} "
        "small reads")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from honours_tpu_torch import _build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    t = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t:.1f} s")

    results = check_kernels(args.seed)
    reads = read_set(args.seed)
    log(f"main path: {len(reads)} reads, {sum(r.size for r in reads)} "
        f"samples, {sum(2 * r.size for r in reads) / 1e6:.1f} MB int16")
    for codec in PATHS:
        for k, c in main_path(codec, reads).items():
            results[k]["launches"] += c
    idle = [k for k, r in results.items() if r["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    log(smi)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
