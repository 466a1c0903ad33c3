"""Drive honours_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

1. Prints the card, builds the CUDA kernels (csrc/) and times the build.
2. Holds every kernel against its plain PyTorch version at the main
   paths' shapes (a bucket of 256 synthetic reads at L = 65536): the
   outputs are integers and must be equal.  Times each on the card (CUDA
   events around the replay of a CUDA graph of 20 calls, 3 for the
   walks) and from the host (events around the same calls made one by
   one, which include the wrapper's Python), beside its plain version, a
   one-call PyTorch yardstick where one exists (timed as the kernel),
   and its bound (bytes over 3.35 TB/s or integer operations
   over 67 Tops/s, whichever is larger).  The output the graph's last
   call left after its replays must equal the plain version too, so a
   race that shows only under load fails the run.  svb16 encode and
   decode with zd off are held and timed the same way, on log lines of
   their own, and so are kernel 1 on svb_zd's operands of that bucket
   (the encode's compaction of [256, 278528] bytes, the decode's
   expansion to [256, 262144]) and svb16 with zd off on vbsse21's
   exception values ([256, 4096], each row's n its exception count).
   Kernel A (the stall segmenter, find_stall), kernel B (rice_decode,
   on rice_vbbe21_zd's residual streams of the bucket) and kernel C
   (huffman_decode, on shuffman_vbbe21_zd's bit streams of the bucket)
   are held and timed the same way, and so are phase 11's kernels F
   (rccdf_encode) and G (rccdf_decode) on rccdf_vbbe21_zd's residual
   bytes of the bucket, each beside its chain floor (the longest row's
   lane steps at RCCDF_STEP_CYCLES), and on rc_rows' [24, 4096] edge rows
   on log lines of their own, H (huffman_build) on their
   histograms beside its chain floor (HUFFBUILD_CYCLES) and C2
   (huffman_decode_rows) on huffman_vbbe21_zd's bodies of them, and
   phase 12's kernels I (bitpack_msb) on uint_zd's fields of
   the bucket (and, on log lines of their own, on turbopfor's and
   flat_uint_submin's rows of it; every output buffer made outside the
   timed calls), J (bitunpack_msb) on I's packed rows (and, on log lines
   of their own, on the rows turbopfor's and flat_uint_submin's depresses
   give it), K (flats_partition)
   on the samples at step 64 and L (zsm_mean) on the samples, K and L
   each beside its chain floor (FLATS_STEP_CYCLES; ZSM_STEP_CYCLES over
   the longest read L flags for its float64 chain, its flagged reads
   counted), L also on its edge reads and reads with means k and k +-
   j / n and on the bucket with every read's mean moved to an integer
   (every read flagged), on log lines of their own, and phase 13's
   kernels M (hdrwalk, the segment-header walk) on turbopfor's streams
   of the bucket and, on a log line of its own, on flat_uint_submin's,
   and N (flac_decode) on flac's streams of the bucket, each beside its
   chain floor (HDRWALK_STEP_CYCLES, FLAC_BLOCK_CYCLES), their plain
   versions on the card.  Then does the
   same for
   kernel 1's five entries, o1_fc, rans_encode, o1_decode (both drans phases),
   o0_decode, svb16_encode and svb16_decode (zd on and off), n4_decode,
   find_stall, rice_decode and huffman_decode on one read of L = 262144
   (the one-row shape; each plain version runs once there), for
   huffman_decode on a row of 2,000 x symbol 255 (the longest code, 22
   bits), for rice_decode and huffman_decode on the adversarial rows of
   their chunked decode (tests/chunked_rows.py: unary runs across chunk
   ends, chunk ends at every bit offset of a code, two tiles, counts
   mid-chunk and past the codes, all-0xFF rows, the zero window's tail,
   a window no code starts before and after the count, cut streams,
   wild offsets and counts), for the drans
   decode's phase-grid merge
   (expand_u8 at [B*K, Smax] = [8192, 2048]), and for find_stall on the
   three fixture reads (tests/data/three-reads.blow5) and on the stall
   set (16 reads: 500 random samples, a stall of 30,000 at 460 +- 4, a
   60,000-step random walk), on log lines of their own.  For kernels B
   and C at each shape it logs, counted on the host, the tiles, chunks,
   chunk entries whose first guess was wrong and fix-point rounds of
   the longest row's chunked decode (chunk_sync), and for C the steps
   of its walk (walk_steps); for kernel A at each shape, counted on the
   host by the numpy model of its phases (tests/stall_rows.py), the
   composer's group and chunk steps, walked chunks and table misses, the
   run machine's tiles, attempts ended (jumps) and ends kept, and its
   chain floor (log_stall_work).
3. Presses and depresses ~1,028 reads (1,024 synthetic reads with
   log-uniform lengths in [4,000, 250,000] samples plus edge reads, two
   of which overflow the exception cap) through
   honours_tpu_torch.engine.runner on the card, once per codec (the 21
   of PATHS).  Each path starts with every launch count at 0; it asserts
   every read comes back bit for bit, that its own kernels were launched
   and, for the capped codecs, that the overflow reads took the one-row
   path, prints its ratio, encode and decode rates and, for the two
   dstall codecs, its split rows (flag byte 1), and checks the card's
   streams of a few reads against the CPU path's.  Every kernel must be
   launched by some path.
4. The stall phase: dstall_srans2 and dstall_drans press and depress the
   fixture reads and the stall set through the runner on the card, every
   read back bit for bit, with their split rows printed; dstall_drans
   must split some row of the stall set.  dstall_srans2's canned model
   gains nothing from a split there, so its split path is driven by
   hand: split streams of the stall set built from press_srans2_batch's
   streams on the card ([1][start:u16][length:u16][stall_len:u32][stall
   blob][ns_len:u32][nonstall blob]) must decode through
   depress_dstall_batch on the card.
5. The CLI: writes a BLOW5 (zlib records, svb-zd signals) of 64 of those
   reads plus the four edge reads, runs `python -m honours_tpu_torch
   press` on it (through honours_tpu_torch.cli.main) with the default
   codec, with srans_vbbe21_zd, hasgam_vbsse21_zdq and
   shuffman_vbbe21_zd, then
   `depress` on each result, and asserts every signal comes back and
   each pressed file names its codec; prints the file sizes.
6. Bench and analyze: `python -m honours_tpu_torch bench` (all 21
   codecs) and `analyze --per-read` through honours_tpu_torch.cli.main
   on the card, over a BLOW5 of the CLI phase's 68 reads, each run with
   every launch count at 0 just before it and read just after.  Every
   TSV row is lossless (the harness asserts it) and must have the CPU
   route's press_bytes and ratio; analyze must launch kernel A and report what
   `analyze --device cpu` reports (ints and bools exactly, floats within
   1e-9 relative).  The CPU routes run in 7 worker processes.  Logs the
   TSV rows, the analyze wall time and its split (the file's read, then
   a warm analyze_reads) beside the card's name and power limit.
7. Multi-GPU: `python -m honours_tpu_torch.shard.dryrun` (through its
   `launch`) at the bucket's width: 256 synthetic reads at L = 65536
   sharded over the ranks for srans2, drans and dstall_drans, and the
   stall set for dstall_drans (its rows reordered, if need be, so that
   some rank holds a split row and some none), every rank's streams
   equal to the unsharded engine's over the whole batch on the card and
   every row back.  Worlds: 4 gloo ranks sharing the card (gloo stages
   the few reduced tensors through the host; the data and the engines
   stay on the card), an NCCL world of 1, and NCCL with a card a rank
   where there are several.  Logs each world and each rank's wall,
   collectives and their bytes; every rank must launch the path's
   kernels, and their launches count toward the kernels line.
8. The bench: `python -m honours_tpu_torch.bench` (bench/driver.py)
   in-process through its `main` on the card, with HTPU_SYNTH_BATCHES=3
   and every launch count at 0 just before it.  Its JSON line must parse,
   skip nothing but the VBZ ratio where `zstandard` does not import, and
   have every *_lossless and *_host_parity true; the stream lengths
   behind its fixture ratios (srans2, drans, the tiled drans fit,
   held-out srans2, srans, srans3, dstall, dstall_drans) must be the CPU
   route's on the same rows.  Logs the line, its wall, and each ratio
   that differs from BENCH_r04.json's or BENCH_r05.json's.
9. Long reads: the long-read configuration (long_set: 256 reads of
   (2^19, 2^20] samples, one full bucket at L = 2^20; 8 reads of
   (2^20, 2^21]; one of 4,194,000, one row at L = 2^22; 600,000
   full-range random samples on the one-row path at emax = L = 2^20; one
   of 262,145) through all 21 codecs on the card, each with every launch
   count at 0 just before it: every read back bit for bit, the path's
   kernels launched, its ratio, rates and peak memory logged; the card's
   streams of the 262,145-sample read equal to the CPU route's.  Every
   kernel held against its plain version and timed on the
   4,194,000-sample read ([1, 2^22]); the walks' plain versions (rans
   encode, o1, o0 and n4 decode: a Python loop pass a step) run on the
   host, as do the CPU routes, in 4 worker processes beside the card's
   work.  Then a full [256, 2^21]
   bucket (each read two neighbours of the first part end to end) of
   rice_vbbe21_zd, shuffman_vbbe21_zd, drans_vbbe21_zd and dstall_drans
   through runner.press_bucket / depress_bucket in the slices the
   runner's rule gives (more than one), its peak memory logged; on the
   [256, 2^20] bucket, which fits unsliced, streams in slices of that
   size must equal the unsliced ones, and both decodes give the reads
   back (encode and decode times of both logged).
10. The range-coder codecs (engine.runner.RC_CODECS) and their kernels D
   (rc_encode) and E (rc_decode), which replace the host's C coder.
   Before phase 3, for each byte model (o0, o1, cm): D and E timed at
   the main path's [256, 65536] (rccm_vbbe21_zd's residual bytes of the
   bucket) beside their bound and chain floor (RC_CHAIN_CYCLES) and the
   cycles a coded bit of the longest row, every row decoded back
   (rc_bucket); the
   share of the bucket's bytes whose model rows the kernels'
   shared-memory slots held rather than fetched, counted on the host
   from the data (rc_reuse); the bucket's 4 longest rows (about 65,000
   bytes each) coded alone and timed, their streams equal to the bucket
   call's rows and held to the plain encode (cm: the plain decode too,
   for its time); D and E held against their plain versions at
   [24, 4096] on edge rows (empty, one byte, 255s, zeros, a ramp,
   random bytes, residual-like rows, and rows whose model-row keys
   repeat: a run, ABAB, ABCABC, cycles of 5, 9, 17 and 33 bytes,
   residual-like runs; rc_rows), also after timed graph replays and in
   one-row calls.  The plain versions run on the host in 3 worker
   processes beside phases 3-9.  After phase 9:
   rccm_vbbe21_zd, dstall_fz and the 16 other codecs that press a
   bucket a container (rc_bucketed) over all ~1,028 reads, the 7 that
   press a read at a time over the four edge reads and the 60 shortest
   reads, and rccm_svbbe21_zd and dstall_fz over the stall set, each
   with every launch count at 0 just before (every read back, D and E
   launched, kernel A for the stall codecs; ratio, split rows, and
   rates for the 1,028-read runs only); a BLOW5 through the CLI with
   the two headline
   codecs; the card's streams of four reads (rc_check_reads, a stall
   read among them) equal to the CPU route's for all 25.
11. The per-read entropy codecs (engine.runner.ENTROPY_CODECS: rccdf,
   huffman and shuffman over the vb containers) over every main-path
   read, each with every launch count at 0 just before: every read back
   bit for bit, its kernels launched (F and G for rccdf, H and C2 for
   huffman, C for shuffman; kernel 1's five entries; svb16's two for
   vbsse21), its ratio and encode and decode rates logged; the card's
   streams of rc_check_reads equal to the CPU route's for all 11, which
   run in phase 10's worker processes.
12. The raw-sample and bit-packing codecs (engine.runner.RAW_CODECS:
   vb1e2, vbe21, vbbe21, vbsbe21, vbsse21, svb and svb0124 over the
   samples as uint16, svb12_nosimd and svb12_zd_nosimd, the uint family
   and flat_uint_submin) over every main-path read, each with every
   launch count at 0 just before: its kernels launched (I and J for the
   uint family and flats, K for flats, L for uint_zsm; kernel 1, svb16),
   ratio and rates logged; every read back bit for bit, except uint11's
   (11 bits a sample, lossy by design), whose streams and decode equal
   the CPU route's for all ~1,028 reads (run in phase 10's worker
   processes) and whose reads that do not round-trip are counted; the
   card's streams of rc_check_reads equal the CPU route's for all 16.
   flat_uint_submin's decode launches M.  Phase 9 also runs uint_zd and
   flat_uint_submin over the long set.
13. The last 33 codecs (engine.runner.BLOCK_CODECS, LAYER_CODECS):
   turbopfor and flac over every main-path read, each with every launch
   count at 0 just before: every read back bit for bit, M, I and J
   (turbopfor) and N (flac) launched, ratio and rates logged; none and
   the 30 byte layers (the inner codec on the card, the layer on the
   host) over the four edge reads and the 60 shortest reads, every read
   back, the 13 zstd codecs only where `zstandard` imports (a log line
   names them where it does not); the card's streams of rc_check_reads
   equal the CPU route's for every codec run, computed in phase 10's
   worker processes.
14. Prints one {"kernels": [...]} line (D and E with cm on the bucket's
   4 longest rows, the [256, 65536] times beside them; F, G, H, K, L, M
   and N with their chain floors), then {"ok": true, "device": ...}.

`--kernels-only` stops after step 2 and phase 10's timing of D and E
at the bucket (rc_bucket), and prints no result line: it times the
kernels of whichever honours_tpu_torch is imported, e.g. an older
tree's, with

    cd OLD_TREE && python3 -c "import runpy, sys; sys.argv = ['x',
        '--kernels-only']; runpy.run_path('NEW_TREE/chip_smoke.py',
        run_name='__main__')"

Exits non-zero, with no result line, when CUDA is unavailable or any
check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # CUDA-core rate (the data sheet's non-tensor fp32)


def log(*a):
    print(*a, flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
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


def graph_ms(fn, reps: int):
    """Device time of one call: `reps` calls captured in a CUDA graph and
    replayed, so the host's Python between launches is not timed; and the
    output the last captured call holds after the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


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


def rows_on_card(reads, L: int = None):
    """Reads padded to [B, L] int16 (L the longest read by default) and
    their lengths, on the card."""
    L = L or max(r.size for r in reads)
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    n = np.array([r.size for r in reads], np.int32)
    return torch.from_numpy(sig).cuda(), torch.from_numpy(n).cuda()


def fixture_reads():
    """The three reads of tests/data/three-reads.blow5."""
    from honours_tpu_torch.io import blow5

    path = Path(__file__).resolve().parent / "tests/data/three-reads.blow5"
    return [r.signal for r in blow5.read_blow5(str(path), device="cpu").reads]


def stall_case(sig, n, label: str):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    A on the rows [B, L]: each sample below n read once (2 B), n read and
    the three outputs written (13 B a row); about 15 operations a sample,
    the C's (two sums, a square, two compares, a step of the machine).
    Logs the kernel's host-counted work on these rows and its chain floor,
    a model of the longest dependent chains of one read (log_stall_work):
    its composer steps x 40 cycles + its walked chunks x 1,024 (256
    dependent adds) + its run-machine tiles x 5,760 (two passes of 256
    samples at 10 cycles, two scans of 8 levels at 40), at 1.98 GHz."""
    from honours_tpu_torch.segment import segment_cuda as S

    n32 = n.to(torch.int32).contiguous()
    nsum = int(n32.to(torch.int64).clamp(0, sig.shape[1]).sum())
    log_stall_work(label, sig, n32)
    return ("find_stall", lambda: S.find_stall(sig, n32),
            lambda: S.find_stall_plain(sig, n32),
            2 * nsum + 13 * sig.shape[0], 15 * nsum, None)


def load_tests_module(name: str):
    """tests/<name>.py, loaded by its path (the tests directory is no
    package)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: cycles of the chain-floor model of kernel A (csrc/segment.cu): a
#: composer step (a compare, selects and an add on s), a walked chunk
#: (CHUNK dependent float adds of 4 cycles) and a tile of the run machine
#: (two passes of a lane over its CHUNK samples at about 10 cycles a
#: sample, and two block scans of 8 levels at about 40)
FLOOR_CYCLES = {"step": 40, "walked": 4 * 256,
                "tile": 2 * 256 * 10 + 2 * 8 * 40}
SM_HZ = 1.98e9


def log_stall_work(label: str, sig, n) -> None:
    """Kernel A's work on each row, counted on the host by the numpy model
    of its phases (tests/stall_rows.py, at segment_cuda's constants):
    composer steps (group and chunk), walked chunks and of them the table
    misses, tiles of the run machine, attempts ended (jumps) and ends kept
    for the segments; and the chain-floor model of the row whose chains
    are longest (FLOOR_CYCLES at 1.98 GHz)."""
    from honours_tpu_torch.segment import segment_cuda as S

    if not hasattr(S, "GROUP"):
        return  # a tree whose kernel A walks each read with one thread
    model = load_tests_module("stall_rows")
    rows = sig.cpu().numpy()
    lens = n.to(torch.int64).clamp(0, sig.shape[1]).tolist()
    tot, worst, floor = {}, None, -1.0
    for row, m in zip(rows, lens):
        st = {}
        model.model_find_stall(row[:m], st)
        for k, v in st.items():
            tot[k] = tot.get(k, 0) + v
        cyc = (FLOOR_CYCLES["step"] * sum(st.get(f"sum{i}_{k}", 0)
                                          for i in (1, 2)
                                          for k in ("group", "chunk"))
               + FLOOR_CYCLES["walked"] * (st.get("sum1_walked", 0)
                                           + st.get("sum2_walked", 0))
               + FLOOR_CYCLES["tile"] * st.get("tiles", 0))
        if cyc > floor:
            worst, floor = (m, st), cyc
    m, st = worst

    def work(d):
        both = {k: d.get(f"sum1_{k}", 0) + d.get(f"sum2_{k}", 0)
                for k in ("group", "chunk", "misses")}
        return (f"composer steps {both['group']} group + {both['chunk']} "
                f"chunk, walked chunks {d.get('sum1_walked', 0)} + "
                f"{d.get('sum2_walked', 0)} (table misses {both['misses']}), "
                f"tiles {d.get('tiles', 0)}, attempts ended (jumps) "
                f"{d.get('jumps', 0)}, ends kept for the segments "
                f"{d.get('kept', 0)}")

    log(f"kernel A on {label}: all rows: {work(tot)} (host count)")
    log(f"kernel A on {label}: the row of the longest chains (n = {m}): "
        f"{work(st)}; chain floor (model) {floor / SM_HZ * 1e3:.4f} ms")


def rice_case(sig, n):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    B on rice_vbbe21_zd's residual streams of the bucket [B, L], parsed
    as its decode parses them: each row's stream from its offset to its
    end read, [B, L] bytes and the offsets and counts written or read;
    about 12 operations a value."""
    from honours_tpu_torch.engine import rice_cuda as R
    from honours_tpu_torch.engine.rice import press_rice_vb_zd_batch
    from honours_tpu_torch.engine.vb_batch import parse_exblock_batch

    B, L = sig.shape
    emax = max(64, L // 16)
    n64 = n.to(torch.int64)
    stream, slen = press_rice_vb_zd_batch(sig, n, "vbbe21", emax)
    p = parse_exblock_batch("vbbe21", stream, torch.full_like(n64, 2),
                            n64 - 1, L, emax)
    off = p["end_off"].clamp(0, stream.shape[1]).to(torch.int32)
    cnt = (n64 - 1 - p["nex"]).clamp(0, L).to(torch.int32)
    body = int((slen - off.to(torch.int64)).sum())
    log_sync("B", f"[{B}, {L}]", "rice", stream, off, cnt)
    return ("rice_decode", lambda: R.rice_decode(stream, off, cnt, L),
            lambda: R.rice_decode_plain(stream, off, cnt, L),
            body + B * L + 8 * B, 12 * int(cnt.sum()), None)


def huffman_case(sig, n):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    C on shuffman_vbbe21_zd's bit streams of the rows [B, L], in rows as
    wide as the longest stream (as the runner's) and parsed as its decode
    parses them: each row's bits from their offset to the stream's end
    read, [B, L] bytes out, the offsets, counts and decoded counts; about
    10 operations a symbol."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine.bits import read_u32be
    from honours_tpu_torch.engine.pipeline import (
        canned_huffman_tables,
        press_shuff_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parse_batch

    B, L = sig.shape
    emax = max(64, L // 16)
    n64 = n.to(torch.int64)
    tabs = canned_huffman_tables(sig.device)
    stream, slen = press_shuff_batch(sig, n, tabs, emax)
    stream = stream[:, : int(slen.max())].contiguous()
    p = vbbe21_parse_batch(stream, torch.full_like(n64, 2), n64 - 1, L, emax)
    cnt = torch.minimum(read_u32be(stream, p["end_off"]),
                        (n64 - 1 - p["nex"]).clamp(min=0)).to(torch.int32)
    off = (p["end_off"] + 4).clamp(0, stream.shape[1]).to(torch.int32)
    bits = int((slen - off).clamp(min=0).sum())
    b = int(cnt.argmax())
    steps, longs = walk_steps(stream[b, int(off[b]):], int(cnt[b]), tabs)
    log(f"kernel C on [{B}, {L}]: its longest row, {int(cnt[b])} symbols, "
        f"takes {steps} steps ({steps / max(int(cnt[b]), 1):.4f} a symbol), "
        f"{longs} of them through the 22-bit table")
    log_sync("C", f"[{B}, {L}]", "huffman", stream, off, cnt, tabs)
    return ("huffman_decode", lambda: H.huffman_decode(stream, off, cnt, L,
                                                       tabs),
            lambda: H.huffman_decode_plain(stream, off, cnt, L, tabs),
            bits + B * L + 12 * B, 10 * int(cnt.sum()), None)


#: a lane step's dependent cycles in the chain-floor model of kernels F
#: and G (csrc/rccdf.cu): what stays serial in the encode is the state's
#: path through a step, two compares, a select of the renormalised
#: state, a multiply-high by the symbol's reciprocal, a shift, a mask
#: and a multiply-add (the symbol and its table entry come from shared
#: memory two steps ahead, the emitted bytes go to a ring in shared
#: memory off the chain); in the decode (32-bit states) the
#: slot's mask and its entry's address (about 4 each), the one shared
#: load of the slot's (f, slot - lo) (about 30), the multiply-add (4),
#: the two compares and the refill's byte count (about 9) and a funnel
#: shift of the state and the register window (4), about 55, counted as
#: 60 (the refill bytes' loads, the symbol's load and the tile's byte
#: store are off the chain; the decode's earlier design, a warp a row,
#: was modelled at 100: two dependent table loads, 64-bit arithmetic and
#: a refill byte from L1)
RCCDF_STEP_CYCLES = {"rccdf_encode": 40, "rccdf_decode": 60}


#: the chain-floor model of kernel H (csrc/huffbuild.cu, a block a row):
#: what stays serial in a row is the sort (a warp's 256 iterations of a
#: broadcast shared load, two compares and an add, about 4 cycles
#: each), the merge chain on thread 0 (a merge's two takes, each a shared
#: load of the next leaf and of the next internal node and a compare,
#: then the node's stores: about 60 dependent cycles) and the codes'
#: pointer-jumping rounds (shared loads, a 64-bit shift and two barriers:
#: about 200 cycles a round, ceil(log2(P - 1)) rounds)
HUFFBUILD_CYCLES = {"sort": 1024, "merge": 60, "round": 200}


def huffbuild_floor_ms(hist):
    """Kernel H's chain floor on the rows of hist [B, 256]: the row with
    the most present symbols P, HUFFBUILD_CYCLES' sort, P - 1 merges and
    ceil(log2(P - 1)) rounds; None where no row has two symbols."""
    P = int((hist > 0).sum(dim=1).max()) if hist.shape[0] else 0
    if P <= 1:
        return None
    rounds = max(P - 2, 0).bit_length()
    c = HUFFBUILD_CYCLES
    return ((c["sort"] + (P - 1) * c["merge"] + rounds * c["round"])
            / SM_HZ * 1e3)


def entropy_cases(sig, n):
    """(name, kernel call, plain call, bytes, ops, library call[, chain
    floor ms]) of kernels F, G, H and C2 on the bucket [B, L]: F and G on
    rccdf_vbbe21_zd's residual bytes (the data read and the body written,
    or the body read and [B, L] bytes written, and the tables), H on
    their histograms (counts read, the table written; a heap's 2 P log2
    P comparisons a row; chain floor huffbuild_floor_ms), C2 on
    huffman_vbbe21_zd's bodies of those bytes, in rows as wide as the
    longest (the bits read, [B, L] bytes written, the tables; 10
    operations a symbol, as C).  F: 12 operations a coded byte, G: 10;
    their chain floors, the longest row's ceil(n / 16) lane steps at
    RCCDF_STEP_CYCLES.  Each plain version runs on the card."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine import huffman as Hf
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC
    from honours_tpu_torch.engine.permute import rowwise_concat
    from honours_tpu_torch.engine.rc import vb_zd_parts

    B, L = sig.shape
    _, _, data, dlen = vb_zd_parts(sig, n, "vbbe21", L)
    data, dlen = data.contiguous(), dlen.to(torch.int32).contiguous()
    nsum, longest = int(dlen.sum()), int(dlen.max())
    floor = {k: -(-longest // 16) * c / SM_HZ * 1e3
             for k, c in RCCDF_STEP_CYCLES.items()}
    hist = R.byte_histogram(data, dlen)
    freqs = R.fit_freqs_batch(hist).to(torch.int32)
    cum = R.cum_of(freqs).to(torch.int32)
    body, blen = RC.rccdf_encode(data, dlen, freqs, cum)
    zero = torch.zeros_like(dlen)
    segs, W = Hf.encode_huffman_batch(data, dlen)
    st, slen = rowwise_concat(segs, W)
    st = st[:, : int(slen.max())].contiguous()
    t = Hf.parse_tables_batch(st, zero.to(torch.int64))
    end = t["end"].to(torch.int32)
    cnt = torch.minimum(t["data_bytes"], dlen.to(torch.int64)).to(
        torch.int32)
    P = (hist > 0).sum(dim=1).to(torch.float64)
    heap_ops = int((2 * P * torch.log2(P.clamp(min=2)).ceil()).sum())
    log(f"phase 11 rows [{B}, {L}]: {nsum} residual bytes, longest row "
        f"{longest}; rccdf bodies {int(blen.sum())} bytes, huffman bodies "
        f"{int(slen.sum())} bytes, longest code "
        f"{int(t['lengths'].max())} bits")
    table = 256 * 8 * B
    return [
        ("rccdf_encode", lambda: RC.rccdf_encode(data, dlen, freqs, cum),
         lambda: R.rccdf_encode_plain(data, dlen, freqs, cum),
         nsum + int(blen.sum()) + table + 8 * B, 12 * nsum, None,
         floor["rccdf_encode"]),
        ("rccdf_decode",
         lambda: RC.rccdf_decode(body, zero, dlen, freqs, L),
         lambda: R.rccdf_decode_plain(body, zero, dlen, freqs, L),
         int(blen.sum()) + B * L + table // 2 + 8 * B, 10 * nsum, None,
         floor["rccdf_decode"]),
        ("huffman_build", lambda: Hf.huffman_build(hist),
         lambda: Hf.huffman_build_plain(hist), (8 + 12) * 256 * B,
         heap_ops, None, huffbuild_floor_ms(hist)),
        ("huffman_decode_rows",
         lambda: H.huffman_decode_rows(st, end, cnt, L, t["lengths"],
                                       t["codes"]),
         lambda: H.huffman_decode_rows_plain(st, end, cnt, L, t["lengths"],
                                             t["codes"]),
         int((slen - t["end"]).clamp(min=0).sum()) + B * L + 12 * 256 * B
         + 12 * B, 10 * int(cnt.sum()), None),
    ] if longest else []


def rccdf_row_cases(dev):
    """(shape, case) of kernels F and G on rc_rows' [24, 4096] edge rows
    (empty, one byte, 255s, zeros, a ramp, random bytes, residual-like
    rows and rows of repeating bytes): F's input and body bytes or G's,
    the tables and 8 B a row; 12 and 10 operations a coded byte."""
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC

    data, dlen = (torch.from_numpy(a).to(dev) for a in rc_rows(19))
    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen)).to(torch.int32)
    cum = R.cum_of(freqs).to(torch.int32)
    body, blen = RC.rccdf_encode(data, dlen, freqs, cum)
    zero = torch.zeros_like(dlen)
    B, N = data.shape
    nsum, coded, table = int(dlen.sum()), int(blen.sum()), 256 * 8 * B
    shape = f"[{B}, {N}] (rc_rows)"
    return [
        (shape, ("rccdf_encode", lambda: RC.rccdf_encode(data, dlen, freqs,
                                                         cum),
                 lambda: R.rccdf_encode_plain(data, dlen, freqs, cum),
                 nsum + coded + table + 8 * B, 12 * nsum, None)),
        (shape, ("rccdf_decode",
                 lambda: RC.rccdf_decode(body, zero, dlen, freqs, N),
                 lambda: R.rccdf_decode_plain(body, zero, dlen, freqs, N),
                 coded + B * N + table // 2 + 8 * B, 10 * nsum, None)),
    ]


def flats_scratch_cases(dev):
    """(shape, case) of kernel K on the reads whose DP state passes its
    shared memory (tests/test_torch_gpu.py
    test_flats_kernel_state_in_scratch: a synthetic read of L samples and
    one of 5,000, [2, 2^19] at step 16 and [2, 2^22] at step 64, m =
    32,768 and 65,536 chunks): 2 B a sample read, the cuts written, 12
    operations an (i, j) pair.  For the tools' parent-change turns;
    chip_smoke.py's own run leaves them to that test."""
    from honours_tpu_torch.engine import flats as Fl
    from honours_tpu_torch.engine import flats_cuda as FC
    from honours_tpu_torch.synth import synthesize_corpus

    out = []
    for L, step in ((1 << 19, 16), (1 << 22, 64)):
        flat = synthesize_corpus(L + 5000, seed=23)
        sig = torch.zeros((2, L), dtype=torch.int16)
        sig[0] = torch.from_numpy(flat[:L])
        sig[1, :5000] = torch.from_numpy(flat[L:])
        sig = sig.to(dev)
        n = torch.tensor([L, 5000], dtype=torch.int32, device=dev)
        m = torch.tensor([L, 5000]) // step
        out.append((f"[2, {L}] step {step} (scratch)", (
            "flats_partition", lambda s=sig, k=n, t=step:
            FC.flats_partition(s, k, t),
            lambda s=sig, k=n, t=step: Fl.flats_partition_plain(s, k, t),
            2 * (L + 5000) + 2 * (L // step + 1),
            12 * int((m * (m + 1) // 2).sum()), None)))
    return out


def flats_bucket_cases(dev):
    """(shape, case) of kernel K at FLATS_STEP on the main path's buckets
    wider than phase 12's: read_set(0)'s lengths that bucket to L =
    131,072 and 262,144 (175 and 162 reads, m = 2,048 and 4,096 chunks),
    each read a window of one synthetic corpus, and one read of 262,145
    samples at L = 524,288 (long_set's part e, m = 8,192): 2 B a sample
    read, the cuts written, 12 operations an (i, j) pair.  For the tools'
    turns over K's designs."""
    from honours_tpu_torch.engine import flats as Fl
    from honours_tpu_torch.engine import flats_cuda as FC
    from honours_tpu_torch.io.batching import bucket_reads
    from honours_tpu_torch.synth import synthesize_corpus

    lens = read_lengths(np.random.default_rng(1))
    flat = synthesize_corpus(1 << 20, seed=29)
    at = np.random.default_rng(31).integers(0, flat.size - lens.max(),
                                            lens.size)
    reads = [flat[a: a + k] for a, k in zip(at, lens) if k > 1 << 16]
    reads.append(synthesize_corpus(262_145, seed=37))
    out = []
    for b in bucket_reads(reads):
        sig = torch.from_numpy(b.sig).to(dev)
        n = torch.from_numpy(b.n).to(dev)
        k = b.n.astype(np.int64)
        m = (k + FLATS_STEP - 1) // FLATS_STEP
        out.append((f"[{b.n.size}, {b.L}] step {FLATS_STEP}", (
            "flats_partition",
            lambda s=sig, c=n: FC.flats_partition(s, c, FLATS_STEP),
            lambda s=sig, c=n: Fl.flats_partition_plain(s, c, FLATS_STEP),
            2 * int(k.sum()) + b.n.size * (b.L // FLATS_STEP + 1),
            12 * int((m * (m + 1) // 2).sum()), None)))
    return out


#: dependent cycles a step in the chain-floor models of kernels K and L:
#: K (csrc/flats.cu, 128 threads a read at the bucket) runs its steps in
#: rounds of 4, whose serial path is the round's chunk loads (about 30
#: cycles), a warp's two dependent __reduce_min_sync (about 60), a shared
#: store, the barrier and a shared load (about 80), the warps' pairs' two
#: reductions (about 60), the tail's chain of an add and a compare a
#: candidate (about 60) and the round's indices entering their slots
#: (about 30): about 320 cycles a round, 80 a step; the slots' evaluations
#: are off that path (they are what the kernel's time adds to it). L's
#: (csrc/zsm.cu) a step of the float64 chain that only a flagged read
#: walks (the others are settled from their exact sums): an fp64
#: subtract and add (about 8 each) and a correctly rounded fp64 divide
#: (about 50)
FLATS_STEP_CYCLES = 80
ZSM_STEP_CYCLES = 66
#: flat_uint_submin's step in phase 12's kernel case (the default)
FLATS_STEP = 64


def pack_args(module, press, *args):
    """The arguments press(*args) gives kernel I through module.pack_msb
    (its values, val_off, count, width and out_off, and the size of its
    out), captured on the call."""
    seen = []
    real = module.pack_msb

    def record(values, val_off, count, width, out, out_off):
        seen.append((values, val_off, count, width, out.numel(), out_off))
        return real(values, val_off, count, width, out, out_off)

    module.pack_msb = record
    try:
        press(*args)
    finally:
        module.pack_msb = real
    return seen[0]


def pack_case(name: str, values, val_off, count, width, O: int, out_off):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    I on its rows: 4 B a field read, the packed bytes written, 32 B a row
    of offsets, count and width; 8 operations a field.  The kernel and the
    plain version each write into an output of O bytes made here, outside
    the timed calls."""
    from honours_tpu_torch.engine import bitpack as BP
    from honours_tpu_torch.engine import bitpack_cuda as BC

    c, b = count.to(torch.int64).clamp(min=0), width.to(torch.int64)
    fields = int(torch.where(b > 0, c, 0).sum())
    pbytes = int(((c * b.clamp(0, 16) + 7) // 8).sum())
    mine, theirs = (torch.zeros(O, dtype=torch.uint8, device=values.device)
                    for _ in range(2))
    return (name,
            lambda: BC.pack_msb(values, val_off, count, width, mine, out_off),
            lambda: BP.pack_msb_plain(values, val_off, count, width, theirs,
                                      out_off),
            4 * fields + pbytes + 32 * val_off.numel(), 8 * fields, None)


def unpack_args(module, depress, *args):
    """The arguments depress(*args) gives kernel J through
    module.unpack_msb (its stream, in_off, in_len, count, width and
    out_off, and the size of its out), captured on the call."""
    seen = []
    real = module.unpack_msb

    def record(stream, in_off, in_len, count, width, out, out_off):
        seen.append((stream, in_off, in_len, count, width, out.numel(),
                     out_off))
        return real(stream, in_off, in_len, count, width, out, out_off)

    module.unpack_msb = record
    try:
        depress(*args)
    finally:
        module.unpack_msb = real
    return seen[0]


def unpack_case(name: str, stream, in_off, in_len, count, width, O: int,
                out_off):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    J on its rows: the packed bytes read, 4 B a field written, 40 B a row
    of in_off, in_len, count, width and out_off (the group prefix the
    wrapper builds is the design's, not the function's); 8 operations a
    field.  The kernel and the plain version each write into an output
    of O int32 made here, outside the timed calls."""
    from honours_tpu_torch.engine import bitpack as BP
    from honours_tpu_torch.engine import bitpack_cuda as BC

    c, b = count.to(torch.int64).clamp(min=0), width.to(torch.int64)
    fields = int(c.sum())
    pbytes = int(((c * b.clamp(0, 16) + 7) // 8).sum())
    mine, theirs = (torch.zeros(O, dtype=torch.int32, device=stream.device)
                    for _ in range(2))
    return (name,
            lambda: BC.unpack_msb(stream, in_off, in_len, count, width, mine,
                                  out_off),
            lambda: BP.unpack_msb_plain(stream, in_off, in_len, count, width,
                                        theirs, out_off),
            pbytes + 4 * fields + 40 * in_off.numel(), 8 * fields, None)


def raw_cases(sig, n):
    """(cases, options), each (name, kernel call, plain call, bytes, ops,
    library call[, chain floor ms]), of kernels I, J, K and L on the
    bucket [B, L]: I on uint_zd's fields (its zigzag deltas; pack_case),
    J on I's rows (unpack_case: the packed bytes read, 4 B a field
    written), K on the
    samples at FLATS_STEP (2 B a sample read, the cuts written; 12
    operations an (i, j) pair; chain floor the longest read's chunks at
    FLATS_STEP_CYCLES), L on the samples (zsm_case: 2 B a sample read, 8
    B a row written; 3 float64 operations a sample; chain floor the
    longest flagged read's samples at ZSM_STEP_CYCLES, 0 where none is
    flagged); the options I on the rows turbopfor's and flat_uint_submin's
    presses of the bucket give it (named "bitpack_msb turbopfor" and
    "bitpack_msb flats") and J on the rows their depresses give it
    ("bitunpack_msb turbopfor", "bitunpack_msb flats"; unpack_case).
    Each output buffer is made outside the timed calls.  Each plain
    version runs on the card."""
    from honours_tpu_torch.engine import bitpack_cuda as BC
    from honours_tpu_torch.engine import flats as Fl
    from honours_tpu_torch.engine import flats_cuda as FC
    from honours_tpu_torch.engine import pfor
    from honours_tpu_torch.engine import uint as U

    B, L = sig.shape
    dev = sig.device
    n32 = n.to(torch.int32).contiguous()
    _, v, cnt, b = U.fields(sig, n32, "zd")
    vals = v.to(torch.int32).reshape(-1).contiguous()
    rows = torch.arange(B, device=dev)
    voff, ooff = rows * L, rows * 2 * L
    nb = (cnt * b + 7) // 8
    packed = BC.pack_msb(vals, voff, cnt, b, torch.zeros(
        2 * B * L, dtype=torch.uint8, device=dev), ooff)
    fields, pbytes = int(cnt.sum()), int(nb.sum())
    nsum = int(n32.to(torch.int64).sum())
    m = (n32.to(torch.int64) + FLATS_STEP - 1) // FLATS_STEP
    pairs, mmax, nmax = int((m * (m + 1) // 2).sum()), int(m.max()), int(
        n32.max())
    callers = {"turbopfor": pack_args(pfor, pfor.press_pfor_batch, sig, n32),
               "flats": pack_args(Fl, Fl.press_flats_batch, sig, n32,
                                  FLATS_STEP)}
    depressers = {
        "turbopfor": unpack_args(pfor, pfor.depress_pfor_batch,
                                 pfor.press_pfor_batch(sig, n32)[0], n32, L),
        "flats": unpack_args(Fl, Fl.depress_flats_batch,
                             Fl.press_flats_batch(sig, n32, FLATS_STEP)[0],
                             n32, L)}
    log(f"phase 12 rows [{B}, {L}]: uint_zd {fields} fields of "
        f"{int(b.min())}-{int(b.max())} bits, {pbytes} packed bytes; flats "
        f"at step {FLATS_STEP}: up to {mmax} chunks a read, {pairs} (i, j) "
        f"pairs; zsm: up to {nmax} samples a read, "
        + zsm_flag_log(sig, n32) + "; I's rows from turbopfor and flats: "
        + ", ".join(f"{k} {a[2].numel()} rows, {int(a[2].sum())} fields"
                    for k, a in callers.items())
        + "; J's rows from their depresses: "
        + ", ".join(f"{k} {a[3].numel()} rows, {int(a[3].sum())} fields"
                    for k, a in depressers.items()))
    cases = [
        pack_case("bitpack_msb", vals, voff, cnt, b, 2 * B * L, ooff),
        unpack_case("bitunpack_msb", packed, ooff, nb, cnt, b, B * L, voff),
        ("flats_partition", lambda: FC.flats_partition(sig, n32, FLATS_STEP),
         lambda: Fl.flats_partition_plain(sig, n32, FLATS_STEP),
         2 * nsum + B * (-(-L // FLATS_STEP) + 1), 12 * pairs, None,
         mmax * FLATS_STEP_CYCLES / SM_HZ * 1e3),
        zsm_case("zsm_mean", sig, n32),
    ]
    options = [pack_case(f"bitpack_msb {k}", *a) for k, a in callers.items()]
    options += [unpack_case(f"bitunpack_msb {k}", *a)
                for k, a in depressers.items()]
    return cases, options


def zsm_longest_flagged(sig, n) -> tuple[int, int]:
    """(the reads of [B, L] int16 (first n valid) that kernel L walks, by
    tests/raw_rows.py's model of its settled rule on their exact sums,
    and the longest one's samples; 0 where none)."""
    zsm_model = load_tests_module("raw_rows").zsm_model
    L = sig.shape[1]
    m = n.to(torch.int64).clamp(0, L)
    col = torch.arange(L, device=sig.device)[None, :]
    S = torch.where(col < m[:, None], sig.to(torch.int64), 0).sum(dim=1)
    walked = [k for s, k in zip(S.tolist(), m.tolist())
              if zsm_model(s, k) is None]
    return len(walked), max(walked, default=0)


def zsm_flag_log(sig, n) -> str:
    count, longest = zsm_longest_flagged(sig, n)
    return (f"{count} of {sig.shape[0]} flagged (the float64 chain), the "
            f"longest of {longest} samples")


def zsm_case(name: str, sig, n):
    """Kernel L's case on [B, L] int16 (first n valid): 2 B a sample read,
    8 B a row written, 3 float64 operations a sample; chain floor the
    longest flagged read's samples at ZSM_STEP_CYCLES (0 where none)."""
    from honours_tpu_torch.engine import uint as U
    from honours_tpu_torch.engine import zsm_cuda as Z

    nsum = int(n.to(torch.int64).sum())
    floor = zsm_longest_flagged(sig, n)[1] * ZSM_STEP_CYCLES / SM_HZ * 1e3
    return (name, lambda: Z.zsm_mean(sig, n), lambda: U.zsm_mean_plain(sig, n),
            2 * nsum + 8 * sig.shape[0], 3 * nsum, None, floor)


def zsm_cases(sig, n, seed: int = 0):
    """(shape, case) of kernel L on its edge reads (tests/raw_rows.py
    zsm_reads) with reads of 4,097 and 65,536 samples whose exact means
    are k and k +- j / n (banded_reads), and the bucket [B, L] with every
    read's exact mean moved to an integer (integer_mean_rows: every read
    flagged, the chain's worst case), each held to the plain version on
    the card; their flagged counts logged."""
    rows = load_tests_module("raw_rows")
    reads = (rows.zsm_reads() + rows.banded_reads(seed, 4097)
             + rows.banded_reads(seed + 1, 1 << 16, ks=(-517, -1, 0, 450),
                                 js=(0, 1)))
    edge = tuple(torch.from_numpy(a).to(sig.device)
                 for a in rows.pad_rows(reads))
    worst = torch.from_numpy(rows.integer_mean_rows(
        sig.cpu().numpy(), n.cpu().numpy())).to(sig.device)
    out = []
    for label, (s, k) in (("edge and banded reads", edge),
                          ("every read flagged",
                           (worst, n.to(torch.int32).contiguous()))):
        shape = f"[{s.shape[0]}, {s.shape[1]}] ({label})"
        log(f"zsm_mean {shape}: " + zsm_flag_log(s, k))
        out.append((shape, zsm_case("zsm_mean", s, k)))
    return out


#: phase 13's kernel M's dependent cycles a step on the H100
#: (csrc/hdrwalk.cu): a header byte's load from device memory (each header
#: lies on a line the thread has not read) and a multiply-add
HDRWALK_STEP_CYCLES = 600
#: the chain-floor model of kernel N (csrc/flac.cu, a block of threads a
#: read): what stays serial is the read's flac blocks, and in a block its
#: header (a dependent load from device memory, about 600 cycles), the
#: tile's staging (one round trip, about 600), two walks of a chunk (the
#: speculation and the emit: FLAC_CHUNK_BITS / the bucket's mean code
#: bits codes, a step about 40 dependent cycles: a shared load, __ffs,
#: shifts and masks), one fix-point round (a barrier and a short walk,
#: about 300) and up to five block scans (the counts' and four
#: integrations', about 200 each)
FLAC_BLOCK_CYCLES = {"header": 600, "stage": 600, "step": 40, "round": 300,
                     "scan": 200}
FLAC_CHUNK_BITS = 64  # csrc/flac.cu CHUNK


def flac_floor_ms(blocks: int, code_bits: float) -> float:
    """Kernel N's chain floor: `blocks` flac blocks of the longest read,
    each at FLAC_BLOCK_CYCLES with codes of code_bits bits on average."""
    c = FLAC_BLOCK_CYCLES
    walk = 2 * FLAC_CHUNK_BITS / max(code_bits, 1.0) * c["step"]
    block = c["header"] + c["stage"] + walk + c["round"] + 5 * c["scan"]
    return blocks * block / SM_HZ * 1e3


def block_cases(sig, n):
    """(cases, options) of kernels M and N on the bucket [B, L], each
    (name, kernel call, plain call, bytes, ops, library call, chain floor
    ms): M on turbopfor's streams of the bucket (2 header bytes and 8 B of
    count read a block, 8 B of offset written a column of [B, S], 16 B a
    row; 6 operations a block; chain floor the longest read's blocks at
    HDRWALK_STEP_CYCLES) and, as an option, on flat_uint_submin's at
    FLATS_STEP (1 header byte a segment); N on flac's streams of the
    bucket (the streams' bytes read, 2 B a sample written, 4 B a row; 20
    operations a sample; chain floor flac_floor_ms over the longest read's
    blocks, at the bucket's mean bits a sample).  Each plain version runs
    on the card."""
    from honours_tpu_torch.engine import flac, flats, pfor
    from honours_tpu_torch.engine import flac_cuda as N
    from honours_tpu_torch.engine import hdrwalk_cuda as M

    B, L = sig.shape
    n32 = n.to(torch.int32).contiguous()
    n64 = n32.to(torch.int64)
    pst, psl = pfor.press_pfor_batch(sig, n32)
    pst = pst.contiguous()
    blen = pfor.block_lengths(n64, L)[1].contiguous()
    nblk = (n64 + pfor.BLOCK - 1) // pfor.BLOCK
    zero = torch.zeros_like(n64)
    fst, _ = flats.press_flats_batch(sig, n32, FLATS_STEP)
    fst = fst.contiguous()
    first, nseg, lens = flats.walk_args(fst, n64)
    cst, csl = flac.press_flac_batch(sig, n32)
    cst = cst.contiguous()
    blocks, segs, nsum = int(nblk.sum()), int(nseg.sum()), int(n64.sum())
    log(f"phase 13 rows [{B}, {L}]: turbopfor {blocks} blocks, "
        f"{int(psl.sum())} bytes; flats {segs} segments at step "
        f"{FLATS_STEP}; flac {int(csl.sum())} bytes, "
        f"{int(((n64 + flac.BLOCK - 1) // flac.BLOCK).sum())} blocks")
    cases = [
        ("hdrwalk", lambda: M.hdrwalk(pst, zero, nblk, blen, M.TURBOPFOR),
         lambda: M.hdrwalk_plain(pst, zero, nblk, blen, M.TURBOPFOR),
         8 * blen.numel() + 10 * blocks + 16 * B, 6 * blocks, None,
         int(nblk.max()) * HDRWALK_STEP_CYCLES / SM_HZ * 1e3),
        ("flac_decode", lambda: N.flac_decode(cst, n32, L),
         lambda: N.flac_decode_plain(cst, n32, L),
         int(csl.sum()) + 2 * B * L + 4 * B, 20 * nsum, None,
         flac_floor_ms(-(-int(n64.max()) // flac.BLOCK),
                       8 * int(csl.sum()) / max(nsum, 1))),
    ]
    options = [
        ("hdrwalk flats", lambda: M.hdrwalk(fst, first, nseg, lens, M.FLATS),
         lambda: M.hdrwalk_plain(fst, first, nseg, lens, M.FLATS),
         8 * lens.numel() + 9 * segs + 16 * B, 6 * segs, None,
         int(nseg.max()) * HDRWALK_STEP_CYCLES / SM_HZ * 1e3),
    ]
    return cases, options


def walk_steps(row, count: int, tabs) -> tuple[int, int]:
    """The steps kernel C's walk takes over one stream (its first-level
    lookups: a step emits two symbols where l1 holds two), and those of
    them that read the 22-bit table in device memory, counted on the
    host from the same tables."""
    row = np.concatenate([row.cpu().numpy(), np.zeros(8, np.uint8)])
    bits = np.unpackbits(row, bitorder="little").astype(np.int64)
    weights = 1 << np.arange(22)
    l1, lut = tabs["l1"].cpu().numpy(), tabs["lut"].cpu().numpy()
    p = i = steps = longs = 0
    while i < count:
        w = int(bits[p: p + 22] @ weights)
        e = int(l1[w & 0xFFF])
        n, ln = 1, e >> 8 & 31
        if ln == 0:
            ln, longs = int(lut[w]) >> 8, longs + 1
        elif e >> 24 and i + 1 < count:
            n, ln = 2, e >> 24
        p, i, steps = p + ln, i + n, steps + 1
    return steps, longs


def chunk_sync(nxt, first: int, E: int, count: int):
    """The fix-point of kernels B and C's chunked decode (csrc/common.cuh
    htt_chunked) over one row, counted on the host: (tiles, chunks,
    chunks whose first guess of an entry was wrong, fix-point rounds,
    chain: over the tiles, the most codes one chunk walks in its
    speculation and its emit).  nxt(p) is the position after the code at
    bit p (None at a stop); E the bits up to the stream's last nonzero
    byte."""
    from honours_tpu_torch.engine.rice_cuda import CHUNK_BITS, THREADS

    tile = THREADS * CHUNK_BITS
    tiles = chunks = wrong = rounds = chain = 0
    entry, S = first, 0
    while entry is not None and entry < E and S < count:
        tb = entry - entry % tile
        cs = [tb + j * CHUNK_BITS for j in range(THREADS)]
        live = [c for c in cs if c < E]

        def walk(j, e):  # -> (exit, codes) of chunk j from e
            end, n = min(cs[j] + CHUNK_BITS, E), 0
            while e is not None and e < end:
                e, n = nxt(e), n + 1
            return e, n

        guess = [max(c, entry) for c in live]
        ent = list(guess)
        ex = [walk(j, e) for j, e in enumerate(ent)]
        spec = [n for _, n in ex]
        while True:  # each round reads the exits of the round before
            rounds += 1
            new = [ex[0]] + [walk(j, ex[j - 1][0]) if ex[j - 1][0] != ent[j]
                             else ex[j] for j in range(1, len(live))]
            ent = [ent[0]] + [x[0] for x in ex[:-1]]
            moved = any(a[0] != b[0] for a, b in zip(new, ex))
            ex = new
            if not moved:
                break
        tiles += 1
        chunks += len(live)
        wrong += sum(a != b for a, b in zip(ent, guess))
        chain += max(a + n for a, (_, n) in zip(spec, ex))
        S += sum(n for _, n in ex)
        entry = ex[-1][0]
    return tiles, chunks, wrong, rounds, chain


def row_sync(kind: str, row, off: int, count: int, tabs=None):
    """chunk_sync of one row of kernel B ("rice") or C ("huffman")."""
    start = min(max(off, 0), row.size)
    body = row[start:]
    nz = np.flatnonzero(body)
    E = 8 * (int(nz[-1]) + 1) if nz.size else 0
    bits = np.unpackbits(np.concatenate([body, np.zeros(8, np.uint8)]),
                         bitorder="little")
    if kind == "rice":
        k = int(bits[0]) << 2 | int(bits[1]) << 1 | int(bits[2])
        zero_at = np.where(bits == 0, np.arange(bits.size), bits.size)
        next_zero = np.minimum.accumulate(zero_at[::-1])[::-1]
        return chunk_sync(lambda p: int(next_zero[p]) + 1 + k, 3, E, count)
    lut = tabs["lut"].cpu().numpy().astype(np.int64) >> 8
    limit = 8 * body.size
    w = sum(bits[j: j + max(E, 1)].astype(np.int64) << j for j in range(22))

    def nxt(p):
        n = int(lut[w[p]])
        return p + n if n and p + n <= limit else None

    return chunk_sync(nxt, 0, E, count)


def log_sync(kernel: str, shape: str, kind: str, stream, off, cnt,
             tabs=None) -> None:
    from honours_tpu_torch.engine import rice_cuda

    if not hasattr(rice_cuda, "CHUNK_BITS"):
        return  # a tree whose kernels B and C walk each row whole
    b = int(cnt.argmax())
    t, c, wrong, r, chain = row_sync(kind, stream[b].cpu().numpy(),
                                     int(off[b]), int(cnt[b]), tabs)
    log(f"kernel {kernel} on {shape}: its longest row, {int(cnt[b])} "
        f"codes: {t} tiles, {c} chunks, {wrong} first guesses of a chunk's "
        f"entry wrong, {r} fix-point rounds, a chain of {chain} codes "
        "(host count)")


def adversarial_cases(dev):
    """(shape, case) of kernels B and C on tests/chunked_rows.py's rows
    for the chunked decode (runs across chunk ends, chunk ends at every
    bit offset, two tiles, counts mid-chunk and past the codes, all-0xFF
    rows, the zero window's tail, a window no code starts, cut streams,
    wild offsets and counts); bytes: the rows from their offsets, the
    output and the offsets and counts; about 12 (B) and 10 (C)
    operations a code."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine import rice_cuda as R

    rows = load_tests_module("chunked_rows")
    out = []
    for name, (st, off, cnt, N) in rows.rice_cases().items():
        st, off, cnt = (torch.from_numpy(x).to(dev) for x in (st, off, cnt))
        body = int((st.shape[1] - off.clamp(0, st.shape[1])).sum())
        c = int(cnt.clamp(0, N).sum())
        log_sync("B", f"[{st.shape[0]}, {st.shape[1]}] ({name})", "rice", st,
                 off, cnt.clamp(0, N))
        out.append((f"[{st.shape[0]}, {st.shape[1]}] ({name})", (
            "rice_decode",
            lambda st=st, off=off, cnt=cnt, N=N: R.rice_decode(st, off, cnt,
                                                               N),
            lambda st=st, off=off, cnt=cnt, N=N: R.rice_decode_plain(
                st, off, cnt, N),
            body + st.shape[0] * (N + 8), 12 * c, None)))
    for name, (st, off, cnt, N, tabs) in rows.huffman_cases().items():
        st, off, cnt = (torch.from_numpy(x).to(dev) for x in (st, off, cnt))
        tabs = {k: v.to(dev) for k, v in tabs.items()}
        body = int((st.shape[1] - off.clamp(0, st.shape[1])).sum())
        c = int(cnt.clamp(0, N).sum())
        log_sync("C", f"[{st.shape[0]}, {st.shape[1]}] ({name})", "huffman",
                 st, off, cnt.clamp(0, N), tabs)
        out.append((f"[{st.shape[0]}, {st.shape[1]}] ({name})", (
            "huffman_decode",
            lambda st=st, off=off, cnt=cnt, N=N, t=tabs: H.huffman_decode(
                st, off, cnt, N, t),
            lambda st=st, off=off, cnt=cnt, N=N, t=tabs:
                H.huffman_decode_plain(st, off, cnt, N, t),
            body + st.shape[0] * (N + 12), 10 * c, None)))
    return out


def longest_code_case(dev):
    """Kernel C on one row of 2,000 x symbol 255, whose code is the
    longest (22 bits): every step takes the LUT in device memory."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine.entropy import shuff_encode_batch
    from honours_tpu_torch.engine.pipeline import canned_huffman_tables

    m = 2000
    tabs = canned_huffman_tables(dev)
    cnt = torch.tensor([m], dtype=torch.int32, device=dev)
    blob, blen = shuff_encode_batch(
        torch.full((1, m), 255, dtype=torch.uint8, device=dev), cnt, tabs)
    blob = blob[:, : int(blen[0])].contiguous()
    off = torch.full((1,), 4, dtype=torch.int32, device=dev)
    log_sync("C", "[1, 2000] (2,000 x symbol 255)", "huffman", blob, off,
             cnt, tabs)
    return ("huffman_decode",
            lambda: H.huffman_decode(blob, off, cnt, m, tabs),
            lambda: H.huffman_decode_plain(blob, off, cnt, m, tabs),
            int(blen[0]) - 4 + m + 12, 10 * m, None)


def to_cpu(x):
    """Tensors, in tuples and lists too, copied to the host."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(y) for y in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


class Call:
    """A plain version's call, fn(*args): picklable where fn is a
    module-level function, so that a worker process can run it on the
    host (on_cpu)."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __call__(self):
        return self.fn(*self.args)

    def on_cpu(self) -> "Call":
        return Call(self.fn, *to_cpu(self.args))


def o1_decode_phases_plain(args1, args2):
    """Both drans phases of kernel 4's plain version."""
    from honours_tpu_torch.engine import rans_o1_cuda as O

    return O.o1_decode_plain(*args1), O.o1_decode_plain(*args2)


def walk_cases(sig, n, g, tabs):
    """(name, kernel call, plain call, bytes, ops, library call) of the
    three walks on one bucket [B, L] with the inputs the main paths give
    them: rans_encode on drans's lane grid `g` (from permute_fc_cases),
    o1_decode's two drans phases, o0_decode on srans's v2 bodies; and
    the drans decode's phase grids for the merge case."""
    from honours_tpu_torch.engine import drans as D
    from honours_tpu_torch.engine import rans_encode_cuda as E
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.entropy_o1 import read_states
    from honours_tpu_torch.engine.pipeline import (
        canned_rans_tables,
        press_srans_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parse_batch
    from honours_tpu_torch.kernels.rans import K_SHARED as K
    from honours_tpu_torch.tables.drans import PREFIX_DEN

    B, L = sig.shape
    emax = max(64, L // 16)
    Smax = L // K
    dev = sig.device
    n64 = n.to(torch.int64)
    fc3 = O.o1_fc(g["sym"], g["ctx"], tabs["cmap"],
                  tabs["fc"]).reshape(B, K, Smax)
    fc = torch.where(g["act3"], fc3, 0).transpose(1, 2).reshape(B, Smax * K)
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
    grid2, _, fptr2 = O.o1_decode(*args2)
    consumed = int((fptr2.to(torch.int64)
                    - d["body_off"].to(torch.int64)).sum())

    # srans's v2 body, parsed for kernel 4b
    tabs0 = canned_rans_tables(dev)
    st0, sl0 = press_srans_batch(sig, n, tabs0, emax)
    p0 = vbbe21_parse_batch(st0, torch.full_like(n64, 2), n64 - 1, L, emax)
    off0 = p0["end_off"]
    dlen0 = (n64 - 1 - p0["nex"]).to(torch.int32)
    args4b = (st0, read_states(st0, off0, K), dlen0, tabs0["cum"], L,
              (off0 + 4 * K).to(torch.int32))
    body0 = int((sl0 - off0 - 4 * K).sum())

    # operations: those of the lane-steps that code a symbol in this data
    cases = [
        ("rans_encode", lambda: E.encode_core(fc, Smax, K),
         Call(E.encode_core_plain, fc, Smax, K),
         4 * fc.numel() + 4 * fc.numel() + 4 * B * K,
         30 * int((fc > 0).sum()), None),
        # the bodies consumed, states in and out, the lane grid out
        ("o1_decode", lambda: (O.o1_decode(*args1), O.o1_decode(*args2)),
         Call(o1_decode_phases_plain, args1, args2),
         consumed + B * K * (T1 + T2) + 4 * 4 * B * K,
         40 * int(d["dlen"].to(torch.int64).sum()), None),
        # the v2 bodies consumed, states in, [B, L] bytes out
        ("o0_decode", lambda: O.o0_decode(*args4b),
         Call(O.o0_decode_plain, *args4b),
         body0 + B * L + 4 * B * K, 40 * int(dlen0.sum()), None),
    ]
    return cases, {"d": d, "grid2": grid2, "T2": T2}


def kernel_cases(seed: int):
    """(name, kernel call, plain call, bytes, ops, library call) at the
    main path's shapes, from one bucket run through the port's stages,
    the same of options those cases leave out (named "kernel option"),
    and (shape, case) of kernel 1 and svb16 at svb_zd's and vbsse21's
    shapes (vb_cases) and of kernel L on its own rows (zsm_cases)."""
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
    from honours_tpu_torch.kernels.rans import K_SHARED as K

    sig, n = make_bucket(seed)
    B, L = sig.shape
    Smax = L // K
    dev = sig.device
    tabs = canned_o1_device_tables(dev)
    perm_cases, g = permute_fc_cases(sig, n, tabs)
    sym, ctx = g["sym"], g["ctx"]
    walks, w = walk_cases(sig, n, g, tabs)
    # the phase-grid merge of the drans decode (engine/drans.py
    # _merge_grids): an expansion of [B*K, Smax] u8 rows
    d, T2 = w["d"], w["T2"]
    r2 = torch.nn.functional.pad(w["grid2"].reshape(B * K, T2),
                                 (0, Smax - T2))
    m_shift = d["T0_b"].repeat_interleave(K)[:, None].expand(B * K, Smax)
    m_shift = m_shift.to(torch.int32).contiguous()
    cols = torch.arange(Smax, device=dev)[None, :]
    m_valid = cols < (d["S_b"] - d["T0_b"]).repeat_interleave(K)[:, None]
    merge = ("monotone_expand_u8",
             lambda: P.expand(r2, m_shift, m_valid, Smax),
             lambda: P.expand_plain(r2, m_shift, m_valid, Smax),
             expand_bytes(r2, m_shift, m_valid, Smax), 2 * B * K * Smax, None)

    svb_n4, options, nt = svb_n4_cases(sig, n)
    blocks, block_options = block_cases(sig, n)
    raws, raw_options = raw_cases(sig, n)
    options = options + raw_options + block_options
    cases = perm_cases + walks + svb_n4 + [
        o1n_case(sym, ctx, nt),
        stall_case(sig, n, f"[{B}, {L}]"),
        rice_case(sig, n),
        huffman_case(sig, n),
    ] + entropy_cases(sig, n) + raws + blocks
    shapes = (f"[{B}, {L}]", f"[{B * K}, {Smax}] (drans phase-grid merge)")
    return (cases, options, merge, shapes,
            vb_cases(sig, n) + zsm_cases(sig, n, seed)
            + rccdf_row_cases(dev))


def o1n_case(sym, ctx, nt):
    """(name, kernel call, plain call, bytes, ops, library call) of kernel
    7 on a lane grid's symbols and contexts against the canned nibble
    tables `nt`."""
    from honours_tpu_torch.engine import rans_n4_cuda as N4

    return ("o1n_fc", lambda: N4.o1n_fc(sym, ctx, *nt),
            lambda: N4.o1n_fc_plain(sym, ctx, *nt),
            16 * sym.numel(), 8 * sym.numel(), None)


def row_cases(sig, n):
    """(name, kernel call, plain call, bytes, ops, library call) of every
    kernel and its options on the rows [B, L] on the card, with the
    inputs the main paths give them: kernel 1's five entries, o1_fc, the
    walks, svb16 (zd on and off), o1n_fc, find_stall, rice_decode and
    huffman_decode."""
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    tabs = canned_o1_device_tables(sig.device)
    perm, g = permute_fc_cases(sig, n, tabs)
    svb_n4, options, nt = svb_n4_cases(sig, n)
    label = f"[{sig.shape[0]}, {sig.shape[1]}]"
    return (perm + walk_cases(sig, n, g, tabs)[0] + svb_n4 + options
            + [o1n_case(g["sym"], g["ctx"], nt), stall_case(sig, n, label),
               rice_case(sig, n), huffman_case(sig, n)])


def svb_n4_cases(sig, n):
    """(name, kernel call, plain call, bytes, ops, library call) of svb16
    encode and decode (zd) on the raw bucket [B, L], and of kernel 8 on
    srans3's v4 bodies of it, parsed as the srans3 decode parses them;
    the same of svb16 encode and decode with zd off; and the canned
    nibble tables."""
    from honours_tpu_torch.engine import rans_n4_cuda as N4
    from honours_tpu_torch.engine import svb16_cuda as SV
    from honours_tpu_torch.engine.bits import read_u32le
    from honours_tpu_torch.engine.entropy_o1 import _rd_states
    from honours_tpu_torch.engine.pipeline import (
        canned_o1n_device_tables,
        press_srans3_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parse_batch, wrap_i32
    from honours_tpu_torch.kernels.rans import K_SHARED as K

    B, L = sig.shape
    emax = max(64, L // 16)
    Smax = L // K
    n64 = n.to(torch.int64)
    svb, svb_len = SV.svb16_encode(sig, n, True)
    raw, raw_len = SV.svb16_encode(sig, n, False)
    ntabs = canned_o1n_device_tables(sig.device)
    nt = (ntabs["cmap"], ntabs["lo_assign"], ntabs["fcH"], ntabs["fcL"])
    st3, sl3 = press_srans3_batch(sig, n, ntabs, emax)
    p3 = vbbe21_parse_batch(st3, torch.full_like(n64, 2), n64 - 1, L, emax)
    off3 = p3["end_off"]
    dlen3 = (n64 - 1 - p3["nex"]).to(torch.int32)
    args8 = (st3, _rd_states(st3, off3, K), dlen3,
             wrap_i32(read_u32le(st3, off3)).to(torch.int32),
             (off3 + 4 + 4 * K).to(torch.int32), *nt)
    body3 = int((sl3 - off3 - 4 - 4 * K).sum())
    nsum = int(n64.sum())
    cases = [
        # samples < n read (2 B), the whole stream row written
        ("svb16_encode", lambda: SV.svb16_encode(sig, n, True),
         lambda: SV.svb16_encode_plain(sig, n, True),
         2 * nsum + svb.numel() + 8 * B, 12 * nsum, None),
        # each row's stream up to its length read, [B, L] int16 written
        ("svb16_decode", lambda: SV.svb16_decode(svb, n, L, True),
         lambda: SV.svb16_decode_plain(svb, n, L, True),
         int(svb_len.sum()) + 2 * B * L + 4 * B, 16 * nsum, None),
        # the v4 bodies consumed, states in, the lane grid out; operations
        # of the lane-steps that code a byte (two nibble steps each)
        ("n4_decode", lambda: N4.n4_decode(*args8, Smax),
         Call(N4.n4_decode_plain, *args8, Smax),
         body3 + 4 * B * K + 12 * B + B * K * Smax,
         60 * int(dlen3.sum()), None),
    ]
    options = [
        ("svb16_encode zd=False", lambda: SV.svb16_encode(sig, n, False),
         lambda: SV.svb16_encode_plain(sig, n, False),
         2 * nsum + raw.numel() + 8 * B, 4 * nsum, None),
        ("svb16_decode zd=False", lambda: SV.svb16_decode(raw, n, L, False),
         lambda: SV.svb16_decode_plain(raw, n, L, False),
         int(raw_len.sum()) + 2 * B * L + 4 * B, 8 * nsum, None),
    ]
    return cases, options, nt


def vb_cases(sig, n):
    """(shape, (name, kernel call, plain call, bytes, ops, library call))
    of kernel 1 on svb_zd's operands of the bucket [B, L] (the encode's
    compaction of [B, L/4 + 4L] bytes, the decode's expansion to
    [B, 4L]) and of svb16 with zd off on vbsse21's exception values
    ([B, round8(emax)], each row's n its exception count)."""
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine import svb16_cuda as SV
    from honours_tpu_torch.engine import svb32
    from honours_tpu_torch.engine.pipeline import _zd_parts
    from honours_tpu_torch.engine.vb_batch import _ex_parts, _svb16_values
    from honours_tpu_torch.transforms.core import zigdelta

    B, L = sig.shape
    emax = max(64, L // 16)
    cat, keep = svb32._encode_operands(zigdelta(sig), n, "1234")
    st, _ = P.compact(cat, keep)
    data, shift, validc, _ = svb32._decode_operands(st, n, L, "1234")

    n64 = n.to(torch.int64)
    p = _ex_parts(_zd_parts(sig, n64)[1], n64 - 1, emax)
    v16 = _svb16_values((p["ex_val"] - 256) & 0xFFFF, emax).contiguous()
    e8 = v16.shape[1]
    nex = p["nex"].to(torch.int32)
    enc, enc_len = SV.svb16_encode(v16, nex, False)
    nsum = int(nex.clamp(max=e8).sum())
    log(f"vbsse21 exception values [{B}, {e8}]: n per row mean "
        f"{nsum / B:.1f}, max {int(nex.max())}")
    return [
        # the mask, each kept byte read, every output byte and the counts
        (f"[{B}, {cat.shape[1]}] (svb_zd encode)",
         ("monotone_compact_u8", lambda: P.compact(cat, keep),
          lambda: P.compact_plain(cat, keep), compact_bytes(keep, 1, 1),
          2 * cat.numel(), None)),
        (f"[{B}, {4 * L}] (svb_zd decode)",
         ("monotone_expand_u8", lambda: P.expand(data, shift, validc, 4 * L),
          lambda: P.expand_plain(data, shift, validc, 4 * L),
          expand_bytes(data, shift, validc, 4 * L), 2 * data.numel(), None)),
        (f"[{B}, {e8}] (vbsse21 values)",
         ("svb16_encode zd=False", lambda: SV.svb16_encode(v16, nex, False),
          lambda: SV.svb16_encode_plain(v16, nex, False),
          2 * nsum + enc.numel() + 8 * B, 4 * nsum, None)),
        (f"[{B}, {e8}] (vbsse21 values)",
         ("svb16_decode zd=False", lambda: SV.svb16_decode(enc, nex, e8, False),
          lambda: SV.svb16_decode_plain(enc, nex, e8, False),
          int(enc_len.sum()) + 2 * B * e8 + 4 * B, 8 * nsum, None)),
    ]


def compact_bytes(keep, read: int, write: int) -> int:
    """Bytes a compaction of [B, N] must move: the mask, `read` bytes of
    payload for each kept element, `write` bytes for each output element
    and the counts."""
    B, N = keep.shape
    return B * N * (1 + write) + read * int(keep.sum()) + 4 * B


def expand_bytes(values, shift, valid, width: int) -> int:
    """Bytes an expansion must move: the mask, the shift of each valid
    element, the value of each one whose target lies in [0, width), and
    out and covered [B, width]."""
    B, N = values.shape
    tgt = torch.arange(N, device=shift.device)[None, :] + shift
    inside = valid & (tgt >= 0) & (tgt < width)
    p = values.element_size()
    return (B * N + 4 * int(valid.sum()) + p * int(inside.sum())
            + (p + 1) * B * width)


def permute_fc_cases(sig, n, tabs):
    """(name, kernel call, plain call, bytes, ops, library call) of the
    five kernel 1 entries and o1_fc on one bucket [B, L], with the inputs
    the drans path gives them, and the lane grid {sym, ctx, act3}."""
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.entropy_o1 import _lane_grid
    from honours_tpu_torch.engine.pipeline import _zd_parts
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parts_batch
    from honours_tpu_torch.kernels.rans import K_SHARED as K

    B, L = sig.shape
    emax = max(64, L // 16)
    Smax = L // K
    dev = sig.device
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
    lg_valid = pos < dlen[:, None]
    lg_shift = torch.where(lg_valid, (pos // S_b.clamp(min=1)[:, None])
                           * (Smax - S_b[:, None]), 0).to(torch.int32)
    g3, ctx3, act3, S_b = _lane_grid(data, dlen, K, Smax)
    sym = g3.reshape(B, -1).to(torch.int32)
    ctx = ctx3.reshape(B, -1).contiguous()

    # ex values and targets placed by the parse: the i32 expansion
    ex_cnt = ex.sum(1)
    eidx = torch.arange(emax, device=dev)[None, :]
    ex_valid = eidx < ex_cnt[:, None]
    ex_pos, _ = P.compact(pos.expand(B, L).to(torch.int32).contiguous(), ex)
    ex_pos = ex_pos[:, :emax].to(torch.int64)
    ex_vals = torch.where(ex_valid, eidx + 300, 0).to(torch.int32)
    ex_shift = torch.where(ex_valid, ex_pos - eidx, 0).to(torch.int32)

    BL = B * L
    flat_fc = tabs["fc"][tabs["cmap"].to(torch.int64)].reshape(-1)
    flat_idx = ctx.to(torch.int64) * 256 + sym
    cases = [
        ("monotone_compact_u8", lambda: P.compact(data_u8, plain),
         lambda: P.compact_plain(data_u8, plain),
         compact_bytes(plain, 1, 1), 2 * BL, None),
        ("monotone_compact_i32", lambda: P.compact(comb, ex),
         lambda: P.compact_plain(comb, ex), compact_bytes(ex, 4, 4),
         2 * BL, None),
        ("compaction_shifts", lambda: P.compaction_shifts(plain),
         lambda: P.compaction_shifts_plain(plain),
         compact_bytes(plain, 0, 4), 2 * BL, None),
        ("monotone_expand_u8",
         lambda: P.expand(data, lg_shift, lg_valid, K * Smax),
         lambda: P.expand_plain(data, lg_shift, lg_valid, K * Smax),
         expand_bytes(data, lg_shift, lg_valid, K * Smax), 2 * BL, None),
        ("monotone_expand_i32",
         lambda: P.expand(ex_vals, ex_shift, ex_valid, L),
         lambda: P.expand_plain(ex_vals, ex_shift, ex_valid, L),
         expand_bytes(ex_vals, ex_shift, ex_valid, L), 2 * B * emax, None),
        ("o1_fc", lambda: O.o1_fc(sym, ctx, tabs["cmap"], tabs["fc"]),
         lambda: O.o1_fc_plain(sym, ctx, tabs["cmap"], tabs["fc"]),
         12 * sym.numel(), 4 * sym.numel(),
         lambda: torch.take(flat_fc, flat_idx)),
    ]
    return cases, {"sym": sym, "ctx": ctx, "act3": act3}


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
    "o0_decode": "honours_tpu/engine/rans_o1_pallas.py:561",
    "svb16_encode": "honours_tpu/engine/svb16_fused.py:153",
    "svb16_decode": "honours_tpu/engine/svb16_fused.py:266",
    "o1n_fc": "honours_tpu/engine/rans_n4_pallas.py:77",
    "n4_decode": "honours_tpu/engine/rans_n4_pallas.py:245",
    # no TPU kernel: the segmenter's lax.scan, and the host rice and
    # static-Huffman decodes
    "find_stall": "honours_tpu/segment/__init__.py:132",
    "rice_decode": "honours_tpu/codecs/rice.py:66",
    "huffman_decode": "honours_tpu/native/huffdec.c:13",
}
#: phase 11's kernels: no TPU kernel either, the host's rccdf coder,
#: Huffman table build and per-read Huffman decode; and phase 12's: the
#: host's bit packer, flats partition and uint_zsm mean.  Like phase
#: 10's (RC_REPLACES) they are held by GPU tests of their own (I to L on
#: rows of up to 2^22 samples), not by row_cases, whose kernels REPLACES
#: lists.
PHASE_REPLACES = {
    "rccdf_encode": "honours_tpu/kernels/rans.py:67",
    "rccdf_decode": "honours_tpu/kernels/rans.py:126",
    "huffman_build": "honours_tpu/tables/huffman.py:55",
    "huffman_decode_rows": "honours_tpu/kernels/huffman_np.py:56",
    "bitpack_msb": "honours_tpu/kernels/bitpack.py:26",
    "bitunpack_msb": "honours_tpu/kernels/bitpack.py:38",
    "flats_partition": "honours_tpu/codecs/flats.py:57",
    "zsm_mean": "honours_tpu/codecs/uintc.py:128",
    "hdrwalk": "honours_tpu/codecs/pfor.py:60",
    "flac_decode": "honours_tpu/codecs/flac.py:132",
}

#: kernels each main path must launch
KERNEL_1 = {"monotone_compact_u8", "monotone_compact_i32",
            "compaction_shifts", "monotone_expand_u8", "monotone_expand_i32"}
#: kernel 1's entries on the svb32 paths
SVB32 = {"monotone_compact_u8", "compaction_shifts", "monotone_expand_u8"}
RICE = KERNEL_1 | {"rice_decode"}
DSTALL = KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode", "find_stall"}
PATHS = {
    "drans_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode"},
    "svb12_zd": {"svb16_encode", "svb16_decode"},
    "svb12": {"svb16_encode", "svb16_decode"},
    "srans_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o0_decode"},
    "srans2_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode"},
    "srans3_vbbe21_zd": KERNEL_1 | {"rans_encode", "o1n_fc", "n4_decode"},
    "shuffman_vbbe21_zd": KERNEL_1 | {"huffman_decode"},
    "vb1e2_zd": KERNEL_1,
    "vbe21_zd": KERNEL_1,
    "vbbe21_zd": KERNEL_1,
    "vbsbe21_zd": KERNEL_1,
    "vbsse21_zd": KERNEL_1 | {"svb16_encode", "svb16_decode"},
    "svb_zd": SVB32,
    "svb0124_zd": SVB32,
    "hasgam_vbsse21_zdq": KERNEL_1,
    "rice_vbe21_zd": RICE,
    "rice_vbbe21_zd": RICE,
    "rice_vbsbe21_zd": RICE,
    "rice_vbsse21_zd": RICE | {"svb16_encode", "svb16_decode"},
    "dstall_srans2": DSTALL,
    "dstall_drans": DSTALL,
}


SLOW = ("rans_encode", "o1_decode", "o0_decode", "n4_decode", "find_stall",
        "rice_decode", "huffman_decode", "huffman_decode_rows",
        "flac_decode")


def time_case(name, kern, plain, nbytes, ops, library,
              floor_ms: float = None) -> dict:
    """Hold one kernel call against its plain version (tolerance 0), also
    after the timed graph's replays, and time it, its plain version and
    its library yardstick; its bound from the bytes and operations of
    this call, and its chain floor where the case gives one.  `name` is
    the kernel's, or "kernel option"."""
    from honours_tpu_torch._build import KERNELS

    kernel = name.split()[0]
    kern()  # warm-up
    torch.cuda.synchronize()
    got = flatten(kern())
    want, plain_ms = timed_once(plain)
    want = flatten(want)
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    reps = 3 if kernel in SLOW else 20
    ms, replayed = graph_ms(kern, reps)
    replay_err = max_abs_err(flatten(replayed), want)
    if replay_err != 0:
        raise AssertionError(f"{name}: output after {reps} graph replays "
                             f"differs from the plain version (max abs err "
                             f"{replay_err})")
    call_ms = cuda_ms(kern, reps)
    library_ms = None
    if library is not None:
        library()
        library_ms = graph_ms(library, reps)[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    floor = {} if floor_ms is None else {"chain_floor_ms": floor_ms}
    return {
        "name": name, "route": "cuda",
        "source": "honours_tpu_torch/csrc/" + KERNELS[kernel].source,
        "replaces": {**REPLACES, **PHASE_REPLACES}[kernel], "launches": 0,
        "max_abs_err": err,
        "matches_plain": True, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "call_ms": call_ms, **floor,
    }


def log_case(shape: str, r: dict) -> None:
    log(f"kernel {r['name']} {shape}: equal to plain (max abs err "
        f"{r['max_abs_err']}, also after the replays); {r['ms']:.4f} ms on "
        "the card "
        f"({r['call_ms']:.4f} ms a call from the host) vs plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})"
        + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] else "")
        + (f", chain floor {r['chain_floor_ms']:.4f} ms"
           + (f", {r['ms'] / r['chain_floor_ms']:.2f}x the floor"
              if r["chain_floor_ms"] else "")
           if "chain_floor_ms" in r else ""))


def check_kernels(seed: int) -> dict:
    """Every kernel at the main path's bucket shape, then kernel 1, o1_fc,
    the walks and kernels A, B and C at the one-row shape, kernel C on
    the longest-code row, kernels B and C on their adversarial rows and
    the drans phase-grid merge, then kernel A on reads with stalls;
    returns the bucket-shape results by kernel."""
    from honours_tpu_torch.synth import stall_set

    cases, options, merge, (bucket, merged), vb = kernel_cases(seed)
    results = {}
    for case in cases:
        results[case[0]] = r = time_case(*case)
        log_case(bucket, r)
    for case in options:
        log_case(bucket, time_case(*case))
    for shape, case in vb:
        log_case(shape, time_case(*case))
    # B = 1, L = 262144: one read on the runner's one-row path, where one
    # read's chain is a walk's whole launch
    sig, n = make_bucket(seed, B=1, L=1 << 18)
    for case in row_cases(sig, n):
        log_case(f"[1, {sig.shape[1]}]", time_case(*case))
    log_case("[1, 2000] (2,000 x symbol 255)",
             time_case(*longest_code_case(sig.device)))
    for shape, case in adversarial_cases(sig.device):
        log_case(shape, time_case(*case))
    log_case(merged, time_case(*merge))
    # kernel A on reads with stalls: the fixture reads and the stall set
    for label, reads in (("fixture reads", fixture_reads()),
                         ("stall set", stall_set(seed))):
        sig, n = rows_on_card(reads)
        shape = f"[{sig.shape[0]}, {sig.shape[1]}] ({label})"
        case = stall_case(sig, n, shape)
        found = case[1]()[0]
        log_case(shape, time_case(*case))
        log(f"find_stall on the {label}: a stall in {int(found.sum())} of "
            f"{len(reads)} reads")
    return results


def read_lengths(rng):
    """read_set's 1,024 read lengths, log-uniform in [4,000, 250,000]."""
    return np.exp(rng.uniform(np.log(4000), np.log(250000),
                              1024)).astype(np.int64)


def read_set(seed: int):
    from honours_tpu_torch.synth import synthesize_corpus

    rng = np.random.default_rng(seed + 1)
    lens = read_lengths(rng)
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


def split_rows(streams) -> int:
    """Rows of a dstall codec's streams that took the split (flag 1)."""
    return sum(s[0] == 1 for s in streams)


def main_path(codec: str, reads) -> dict:
    """Press and depress `reads` through the runner with `codec`; returns
    this path's launch counts."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        _NEX_AT,
        ENGINE_CODECS,
        _emax,
        _nex_overflowed,
        depress_signals,
        press_signals,
    )
    from honours_tpu_torch.io.batching import bucket_reads

    kind = ENGINE_CODECS[codec]
    lens = [r.size for r in reads]
    raw = sum(2 * r.size for r in reads)
    warm = reads[:4] + reads[-4:]
    st = press_signals(warm, codec)
    depress_signals(st, [r.size for r in warm], codec)
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
    if kind.partition(":")[0] in _NEX_AT:
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
    if codec.startswith("dstall"):
        log(f"{codec}: split rows {split_rows(streams)} of {len(reads)}")
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


def stall_phase(seed: int) -> None:
    """dstall_srans2 and dstall_drans through the runner on the card over
    the fixture reads and the stall set; dstall_srans2's split streams
    built by hand from press_srans2_batch on the card, decoded by
    depress_dstall_batch on the card."""
    from honours_tpu_torch.engine.dstall import (
        _split_batch,
        depress_dstall_batch,
    )
    from honours_tpu_torch.engine.pipeline import (
        canned_o1_device_tables,
        press_srans2_batch,
    )
    from honours_tpu_torch.engine.runner import depress_signals, press_signals
    from honours_tpu_torch.synth import stall_set

    stalls = stall_set(seed)
    for label, reads in (("fixture reads", fixture_reads()),
                         ("stall set", stalls)):
        lens = [r.size for r in reads]
        for codec in ("dstall_srans2", "dstall_drans"):
            streams = press_signals(reads, codec)
            out = depress_signals(streams, lens, codec)
            if not all(np.array_equal(a, b) for a, b in zip(reads, out)):
                raise AssertionError(f"{codec}: the {label} did not "
                                     "round-trip")
            k = split_rows(streams)
            log(f"{codec} on the {label}: every read back, split rows {k} "
                f"of {len(reads)}, ratio "
                f"{sum(2 * m for m in lens) / sum(map(len, streams)):.6f}")
            if codec == "dstall_drans" and label == "stall set" and k == 0:
                raise AssertionError("dstall_drans split no row of the "
                                     "stall set")

    # dstall_srans2's split path, its streams built by hand for the reads
    # of the stall set that have a split
    sig, n = rows_on_card(stalls)
    L = sig.shape[1]
    tabs = canned_o1_device_tables(sig.device)
    ok, start, length = _split_batch(sig, n)
    rows = torch.nonzero(ok).flatten().tolist()
    if not rows:
        raise AssertionError("no read of the stall set has a split")
    stalls = [stalls[i] for i in rows]
    n = n[rows]
    start, length = start[rows].tolist(), length[rows].tolist()
    stall = [r[a: a + m] for r, a, m in zip(stalls, start, length)]
    rest = [np.concatenate([r[:a], r[a + m:]])
            for r, a, m in zip(stalls, start, length)]
    blobs = []
    for part in (stall, rest):
        st, sl = press_srans2_batch(*rows_on_card(part, L), tabs, L)
        blobs.append([st[i, : int(sl[i])].cpu().numpy().tobytes()
                      for i in range(len(part))])
    streams = [b"\x01" + struct.pack("<HHI", a, m, len(s)) + s
               + struct.pack("<I", len(ns)) + ns
               for a, m, s, ns in zip(start, length, *blobs)]
    W = -(-max(map(len, streams)) // 128) * 128
    buf = np.zeros((len(streams), W), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    out = depress_dstall_batch(torch.from_numpy(buf).to(sig.device), n,
                               tabs, L, L).cpu().numpy()
    if not all(np.array_equal(out[i, : r.size], r)
               for i, r in enumerate(stalls)):
        raise AssertionError("dstall_srans2: hand-built split streams did "
                             "not decode")
    log(f"dstall_srans2: {len(streams)} hand-built split streams of the "
        "stall set decode through depress_dstall_batch on the card")


def cli_file(reads, path: Path) -> list:
    """Writes the CLI phases' BLOW5 (zlib records, svb-zd signals) to
    `path`: the first 64 of `reads` and the four edge reads (68 reads);
    returns them."""
    from honours_tpu_torch.io import blow5

    sel = reads[:64] + reads[-4:]
    blow5.write_blow5(str(path), blow5.Blow5File(
        version=(0, 2, 0), record_press=blow5.RECORD_PRESS_ZLIB,
        signal_press=blow5.SIGNAL_PRESS_SVB_ZD, num_read_groups=1,
        header=b"@run_id\tchip_smoke\n",
        reads=[blow5.Blow5Read(
            read_id=f"read{i}", read_group=0, digitisation=2048.0,
            offset=0.0, range=1.0, sampling_rate=4000.0, signal=s)
            for i, s in enumerate(sel)]))
    return sel


def build_tmp():
    """A temporary directory under the checkout's build/ (gitignored)."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=build)


def cli_phase(reads) -> None:
    """press and depress a BLOW5 file through the port's CLI on the card,
    with the default codec, srans_vbbe21_zd, hasgam_vbsse21_zdq and
    shuffman_vbbe21_zd."""
    from honours_tpu_torch import cli
    from honours_tpu_torch.io import blow5

    with build_tmp() as tmp:
        src = Path(tmp) / "src.blow5"
        sel = cli_file(reads, src)
        log(f"cli: {src.name} {len(sel)} reads, "
            f"{sum(2 * s.size for s in sel)} B int16, "
            f"{src.stat().st_size} B as svb-zd/zlib BLOW5")
        for codec in ("drans_vbbe21_zd", "srans_vbbe21_zd",
                      "hasgam_vbsse21_zdq", "shuffman_vbbe21_zd"):
            pressed = Path(tmp) / f"{codec}.blow5"
            back = Path(tmp) / f"{codec}.depressed.blow5"
            opt = [] if codec == "drans_vbbe21_zd" else ["--codec", codec]
            t0 = time.perf_counter()
            if cli.main(["press", str(src), str(pressed), *opt]) != 0:
                raise AssertionError(f"cli press {codec} failed")
            t1 = time.perf_counter()
            if cli.main(["depress", str(pressed), str(back)]) != 0:
                raise AssertionError(f"cli depress {codec} failed")
            t2 = time.perf_counter()
            tag = blow5.htpu_codec_name(blow5.read_blow5(
                str(pressed), decode_signal=False).header)
            if tag != codec:
                raise AssertionError(f"cli press wrote codec {tag}, not "
                                     f"{codec}")
            got = blow5.read_blow5(str(back)).reads
            if len(got) != len(sel) or not all(
                    np.array_equal(r.signal, s) for r, s in zip(got, sel)):
                raise AssertionError(f"cli {codec}: signals differ after "
                                     "press and depress")
            log(f"cli {codec}: press {pressed.stat().st_size} B in "
                f"{t1 - t0:.3f} s, depress {back.stat().st_size} B in "
                f"{t2 - t1:.3f} s, every signal back")


def cpu_press_bytes(path: str, codec: str) -> int:
    """The CPU route's press_bytes of a BLOW5 file with `codec` (the
    runner's press on the CPU), in a worker process on one intra-op
    thread."""
    from honours_tpu_torch.engine.runner import press_signals
    from honours_tpu_torch.io import blow5

    torch.set_num_threads(1)
    sigs = [r.signal for r in blow5.read_blow5(path, device="cpu").reads]
    return sum(map(len, press_signals(sigs, codec, device="cpu")))


def cpu_analyze(path: str) -> dict:
    """`analyze --per-read --device cpu`'s report of a BLOW5 file, in a
    worker process on one intra-op thread."""
    torch.set_num_threads(1)
    return json.loads(cli_stdout(["analyze", path, "--per-read", "--device",
                                  "cpu"]))


def cli_stdout(argv) -> str:
    """What a command of the port's CLI prints; raises if it fails."""
    import contextlib
    import io

    from honours_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli {' '.join(argv[:1])} failed")
    return out.getvalue()


def same_report(ours, theirs, where="report") -> None:
    """Equal keys, lists and Python types; ints and bools exactly, floats
    within 1e-9 relative."""
    if type(ours) is not type(theirs):
        raise AssertionError(f"{where}: {ours!r} vs {theirs!r}")
    if isinstance(ours, dict):
        if list(ours) != list(theirs):
            raise AssertionError(f"{where}: keys {list(ours)} vs "
                                 f"{list(theirs)}")
        for k in ours:
            same_report(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(ours, list):
        if len(ours) != len(theirs):
            raise AssertionError(f"{where}: {len(ours)} vs {len(theirs)}")
        for i, (a, b) in enumerate(zip(ours, theirs)):
            same_report(a, b, f"{where}[{i}]")
    elif not (math.isclose(ours, theirs, rel_tol=1e-9)
              if isinstance(ours, float) else ours == theirs):
        raise AssertionError(f"{where}: {ours!r} vs {theirs!r}")


def bench_analyze_phase(reads, smi: str) -> dict:
    """`bench` (all 21 codecs) and `analyze --per-read` through the CLI
    on the card over the CLI phase's BLOW5 (68 reads), each with every
    launch count at 0 just before it and read just after.  Every bench
    row is lossless (the harness asserts it), and its press_bytes and
    ratio must equal the CPU route's (the runner's press on the CPU, in
    worker processes); analyze must launch kernel A, and its report must equal
    `analyze --device cpu`'s (ints and bools exactly, floats within 1e-9
    relative).  Logs the TSV rows, the analyze wall time and its split
    (read_blow5, then a warm analyze_reads).  Returns the launches of
    both runs."""
    import collections
    import multiprocessing

    from concurrent.futures import ProcessPoolExecutor

    from honours_tpu_torch import analysis
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.bench.harness import HDR
    from honours_tpu_torch.engine.runner import engine_codec_names
    from honours_tpu_torch.io import blow5

    def counted(argv):
        for k in KERNELS.values():
            k.launches = 0
        t = time.perf_counter()
        out = cli_stdout(argv)
        wall = time.perf_counter() - t
        return out, wall, {name: k.launches for name, k in KERNELS.items()}

    total = collections.Counter()
    with build_tmp() as tmp:
        src = str(Path(tmp) / "src.blow5")
        raw = sum(2 * s.size for s in cli_file(reads, src))
        tsv, bench_s, launches = counted(["bench", src])
        total.update(launches)
        lines = tsv.strip().splitlines()
        rows = [line.split("\t") for line in lines[1:]]
        if lines[0] != HDR or [r[0] for r in rows] != engine_codec_names():
            raise AssertionError(f"bench printed {lines[:2]} ...")
        log(f"bench: 21 codecs over {src.rsplit('/', 1)[-1]} (68 reads, "
            f"{raw} B int16) in {bench_s:.3f} s through the CLI on the "
            f"card ({smi}); the harness's rows (end-to-end wall times on "
            "the host clock, first-use costs in the first row):")
        for line in lines:
            log("bench | " + line)
        out, analyze_s, launches = counted(["analyze", src, "--per-read"])
        total.update(launches)
        card = json.loads(out)
        if launches["find_stall"] == 0:
            raise AssertionError("analyze launched no find_stall")
        log(f"analyze --per-read: {analyze_s:.3f} s on the card ({smi}), "
            f"find_stall launched {launches['find_stall']} times, stalls "
            f"in {sum(r['stall'] for r in card['reads'])} of "
            f"{card['aggregate']['n_reads']} reads; aggregate "
            f"{json.dumps(card['aggregate'])}")
        # where the CLI's analyze wall goes, outside the counted run
        t = time.perf_counter()
        sigs = [r.signal for r in blow5.read_blow5(src, device="cuda").reads]
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        analysis.analyze_reads(sigs, device="cuda")
        warm_s = time.perf_counter() - t
        log(f"analyze split ({smi}): read_blow5 {read_s:.4f} s, then "
            f"analyze_reads {warm_s:.4f} s warm "
            f"({warm_s / len(sigs) * 1e3:.3f} ms a read)")

        t = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=7, mp_context=ctx) as pool:
            rep = pool.submit(cpu_analyze, src)
            press = {r[0]: pool.submit(cpu_press_bytes, src, r[0])
                     for r in rows}
            press = {m: f.result() for m, f in press.items()}
            same_report(card, rep.result())
        # each row's round trip is held by the harness's own lossless
        # assert (its depress_bytes column is the raw size, as in the JAX
        # harness)
        for m, pb, ratio in ((r[0], r[2], r[3]) for r in rows):
            if (pb, ratio) != (f"{press[m]:.1f}", f"{raw / press[m]:.6f}"):
                raise AssertionError(f"bench {m}: press_bytes {pb}, ratio "
                                     f"{ratio}; the CPU route's "
                                     f"{press[m]}")
        log(f"bench and analyze: every row lossless (the harness's "
            "assert), press_bytes and ratio the CPU route's, the analyze "
            "report the "
            f"CPU route's (CPU routes in 7 worker processes, "
            f"{time.perf_counter() - t:.1f} s)")
    return total


def shard_phase(seed: int) -> dict:
    """honours_tpu_torch.shard.dryrun at the bucket's width ([256, 65536]
    and the stall set) in each world this machine can hold: 4 gloo ranks
    sharing the card, an NCCL world of 1, and NCCL with a card a rank
    where there are several.  Logs each world's backend, size, cards and
    wall, and each rank's rows, wall over its sharded calls, collectives
    and the bytes each moved, and split rows; every rank must launch the
    path's kernels.  Returns the launches summed over every rank."""
    import collections

    from honours_tpu_torch.shard import dryrun

    cards = torch.cuda.device_count()
    worlds = [("gloo", 4), ("nccl", 1)]
    if cards >= 2:
        worlds.append(("nccl", min(4, cards)))
    total = collections.Counter()
    for backend, world in worlds:
        t = time.perf_counter()
        _, reps = dryrun.launch(world, backend, "cuda", seed=seed,
                                pg_timeout_s=120, timeout_s=400)
        log(f"shard {backend} x{world}: {cards} card(s), ranks on "
            f"{sorted({r['device'] for r in reps})}, "
            f"{time.perf_counter() - t:.1f} s with start-up"
            + ("; gloo stages the reduced tensors through the host, every "
               "tensor of the data stays on the card"
               if backend == "gloo" else ""))
        for r in reps:
            log(f"shard {backend} x{world} rank {r['rank']}: rows "
                f"{r['rows']}, {r['wall_s']:.3f} s over its sharded calls, "
                f"{sum(r['collectives'].values())} collectives "
                f"{r['collectives']}, bytes each (label: count) "
                f"{r['collective_bytes']}, split rows {r['split_rows']}")
            # srans2, drans and dstall_drans: dstall_drans's kernels
            idle = sorted(k for k in DSTALL if r["launches"][k] == 0)
            if idle:
                raise AssertionError(f"shard {backend} x{world} rank "
                                     f"{r['rank']}: kernels not launched: "
                                     f"{idle}")
            total.update(r["launches"])
        log(reps[0]["summary"])
    return total


#: the bench's ratios as BENCH_r04.json and BENCH_r05.json record them
#: (None: not recorded); r04's synthetic ratios are over 3 batches
RECORDED = {
    "srans2_ratio": (3.013, 3.013), "drans_ratio": (2.9952, 2.9951),
    "drans_ratio_tiled": (2.9731, None), "srans_ratio": (None, 2.9415),
    "srans3_ratio": (None, 3.0033), "dstall_ratio": (3.0127, 3.0127),
    "heldout_ratio_srans2": (2.922, 2.922), "vbz_ratio": (2.925, 2.925),
    "synth_srans2_ratio": (3.1214, None), "synth_drans_ratio": (3.1422, None),
}
#: the kernels the bench's sections launch
BENCH = KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode", "o0_decode",
                    "svb16_encode", "svb16_decode", "o1n_fc", "n4_decode",
                    "find_stall"}


def bench_cpu_lengths(b) -> dict:
    """The CPU route's stream lengths behind the bench's fixture ratios,
    on the bench's own rows: the unique chunks, the unique batch that
    drans and dstall_drans pad to 8 rows, and the tiled batch of the
    drans fit."""
    from honours_tpu_torch.engine import pipeline as P
    from honours_tpu_torch.engine.drans import press_drans_batch
    from honours_tpu_torch.engine.dstall import press_dstall_batch
    from honours_tpu_torch.engine.dstall_drans import press_dstall_drans_batch
    from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
    from honours_tpu_torch.tables.o1 import heldout_o1_freqs

    cpu = torch.device("cpu")
    k, E = b.n_unique, b.emax
    u, nu = b.sig[:k].cpu(), b.n[:k].cpu()
    sj, nj = (t.cpu() for t in b.unique_batch())
    o1 = P.canned_o1_device_tables(cpu)
    lens = {
        "srans2": P.press_srans2_batch(u, nu, o1, E),
        "heldout": P.press_srans2_batch(
            u, nu, make_o1_tables(heldout_o1_freqs(), cpu), E),
        "srans": P.press_srans_batch(u, nu, P.canned_rans_tables(cpu), E),
        "srans3": P.press_srans3_batch(u, nu, P.canned_o1n_device_tables(cpu),
                                       E),
        "dstall": press_dstall_batch(u, nu, o1, E),
        "drans": press_drans_batch(sj, nj, o1, E),
        "dstall_drans": press_dstall_drans_batch(sj, nj, o1, E),
        "drans_tiled": press_drans_batch(b.sig.cpu(), b.n.cpu(), o1, E),
    }
    return {name: sl[:k].tolist() for name, (_, sl) in lens.items()}


def bench_phase(smi: str) -> dict:
    """`python -m honours_tpu_torch.bench` through its main on the card,
    HTPU_SYNTH_BATCHES=3, every launch count at 0 just before it and read
    just after.  Its line must parse, skip nothing but the VBZ ratio
    where zstandard is missing, and have every lossless and host-parity
    flag true; the stream lengths behind its fixture ratios must be the
    CPU route's.  Returns the launches."""
    import contextlib
    import io
    import os

    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.bench import driver

    for k in KERNELS.values():
        k.launches = 0
    out = io.StringIO()
    synth = os.environ.get("HTPU_SYNTH_BATCHES")
    os.environ["HTPU_SYNTH_BATCHES"] = "3"
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            b = driver.main([])
    finally:
        if synth is None:
            del os.environ["HTPU_SYNTH_BATCHES"]
        else:
            os.environ["HTPU_SYNTH_BATCHES"] = synth
    wall = time.perf_counter() - t
    launches = {name: k.launches for name, k in KERNELS.items()}
    text = out.getvalue().strip().splitlines()[-1]
    log(f"bench line ({smi}): {text}")
    x = json.loads(text)["extra"]
    used = {k: v for k, v in launches.items() if v}
    log(f"bench: {wall:.1f} s through driver.main on the card ({smi}), "
        f"the kernels' build already done; launches {used}")
    bad = [s for s in x["skipped"] if not (
        s["section"] == "vbz_ratio" and "zstandard" in s["reason"])]
    if bad:
        raise AssertionError(f"bench skipped {bad}")
    flags = {k: v for k, v in x.items()
             if k.endswith(("_lossless", "_host_parity"))}
    if len(flags) != 12 or not all(v is True for v in flags.values()):
        raise AssertionError(f"bench flags {flags}")
    idle = sorted(k for k in BENCH if launches[k] == 0)
    if idle:
        raise AssertionError(f"bench: kernels not launched: {idle}")
    t = time.perf_counter()
    cpu = bench_cpu_lengths(b)
    for name, want in cpu.items():
        if b.lengths[name] != want:
            raise AssertionError(f"bench {name}: the card's lengths "
                                 f"{b.lengths[name]}, the CPU route's {want}")
    log("bench: the stream lengths behind its fixture ratios are the CPU "
        f"route's ({time.perf_counter() - t:.1f} s on the CPU): "
        + "; ".join(f"{k} {v} ({b.unique_bytes / sum(v)!r})"
                    for k, v in cpu.items()))
    for key, (r04, r05) in RECORDED.items():
        if key in x and x[key] not in (r04, r05):
            log(f"bench: {key} {x[key]} (BENCH_r04 {r04}, BENCH_r05 {r05})")
    return launches


#: the codecs whose full [256, 2^21] bucket phase 9 codes in slices
FULL_BUCKET = ("rice_vbbe21_zd", "shuffman_vbbe21_zd", "drans_vbbe21_zd",
               "dstall_drans")


def long_set(seed: int) -> dict:
    """The long-read configuration, synthetic signal (synth.py) from
    `seed`: (a) 256 reads with lengths uniform in (2^19, 2^20], one full
    bucket at L = 2^20; (b) 8 reads in (2^20, 2^21]; (c) one read of
    4,194,000 samples, one row at L = 2^22; (d) 600,000 full-range
    random samples, which overflow the exception cap and take the
    one-row path at emax = L = 2^20; (e) one read of 262,145 samples,
    the first past L = 2^18.  Returns {part: [reads]}."""
    from honours_tpu_torch.synth import synthesize_corpus

    rng = np.random.default_rng(seed + 17)
    lens = np.concatenate([rng.integers((1 << 19) + 1, (1 << 20) + 1, 256),
                           rng.integers((1 << 20) + 1, (1 << 21) + 1, 8),
                           [4_194_000, 262_145]])
    flat = synthesize_corpus(int(lens.sum()), seed=seed + 18)
    reads = np.split(flat, np.cumsum(lens)[:-1])
    return {"a": reads[:256], "b": reads[256:264], "c": [reads[264]],
            "d": [rng.integers(-32768, 32768, 600_000).astype(np.int16)],
            "e": [reads[265]]}


def cpu_plain(call: Call):
    """A plain version's output and its milliseconds, run on the host in
    a worker process on one intra-op thread."""
    torch.set_num_threads(1)
    t = time.perf_counter()
    out = call()
    return out, (time.perf_counter() - t) * 1e3


def long_kernels(c_read, pool, smi: str) -> list:
    """Every kernel on the long set's read (c), [1, 2^22], held against
    its plain version and timed (time_case), the launches not counted.
    The walks' plain versions step a read's lanes one step a Python loop
    pass (131,072 steps here, minutes of small launches on the card), so
    they run on the host in `pool`, beside the rest of the phase: their
    kernels are timed here, and the futures come back as (name, output,
    ms, bound ms, replayed output, future) for long_kernels_held."""
    sig, n = rows_on_card([c_read], 1 << 22)
    label = f"[1, {1 << 22}] (read (c), {smi})"
    pending = []
    for case in row_cases(sig, n):
        name, kern, plain = case[:3]
        if not isinstance(plain, Call):
            log_case(label, time_case(*case))
            continue
        future = pool.submit(cpu_plain, plain.on_cpu())
        kern()
        torch.cuda.synchronize()
        got = to_cpu(flatten(kern()))
        ms, replayed = graph_ms(kern, 3)
        bound = max(case[3] / HBM_BYTES_PER_S, case[4] / INT_OPS_PER_S) * 1e3
        pending.append((name, got, ms, bound, to_cpu(flatten(replayed)),
                        future))
    return pending


def long_kernels_held(pending, smi: str) -> None:
    """The walks' outputs at [1, 2^22] against their plain versions' from
    the host (tolerance 0), also after the timed graph's replays."""
    for name, got, ms, bound, replayed, future in pending:
        want, plain_ms = future.result()
        err = max(max_abs_err(got, flatten(want)),
                  max_abs_err(replayed, flatten(want)))
        if err:
            raise AssertionError(f"{name} [1, 2^22]: kernel differs from "
                                 f"its plain version (max abs err {err})")
        log(f"kernel {name} [1, {1 << 22}] (read (c), {smi}): equal to "
            f"plain (max abs err 0, also after the replays); {ms:.4f} ms on "
            f"the card vs plain {plain_ms:.1f} ms on the host (one thread "
            f"of a worker process), bound {bound:.4f} ms")


def long_path(codec: str, reads, smi: str):
    """Press and depress the long set through the runner on the card,
    every launch count at 0 just before; every read back bit for bit and
    the path's kernels launched.  Logs the ratio, the rates and the peak
    memory of the press and the depress.  Returns (launches, streams)."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        depress_signals,
        press_signals,
    )

    lens = [r.size for r in reads]
    raw = 2 * sum(lens)
    torch.cuda.empty_cache()
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = press_signals(reads, codec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_press = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = depress_signals(streams, lens, codec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak_depress = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    bad = [i for i, (a, b) in enumerate(zip(reads, out))
           if not np.array_equal(a, b)]
    if bad:
        raise AssertionError(f"{codec}: long reads {bad[:8]} did not "
                             "round-trip")
    idle = sorted(k for k in {**PATHS, **RAW_PATHS}[codec]
                  if launches[k] == 0)
    if idle:
        raise AssertionError(f"{codec}: kernels not launched on the long "
                             f"set: {idle}")
    comp = sum(len(s) for s in streams)
    log(f"long {codec}: all {len(reads)} reads round-trip bit for bit; "
        f"ratio {raw / comp:.6f}; encode {t1 - t0:.3f} s "
        f"{raw / (t1 - t0) / 1e6:.1f} MB/s, decode {t2 - t1:.3f} s "
        f"{raw / (t2 - t1) / 1e6:.1f} MB/s; peak memory press "
        f"{peak_press / 1e9:.3f} GB, depress {peak_depress / 1e9:.3f} GB "
        f"({smi})")
    return launches, streams


def cpu_press_read(read, codec: str) -> bytes:
    """The CPU route's stream of one read, in a worker process on one
    intra-op thread."""
    from honours_tpu_torch.engine.runner import press_signals

    torch.set_num_threads(1)
    return press_signals([read], codec, device="cpu")[0]


def full_bucket(codec: str, a_reads, smi: str) -> dict:
    """A full [256, 2^21] bucket, each read two neighbours of the long
    set's (a) end to end (lengths in (2^20, 2^21]), through
    runner.press_bucket / depress_bucket on the card in the slices the
    rule gives (more than one), every read back; its peak memory logged.
    Then (a)'s [256, 2^20] bucket, which fits unsliced, in slices of that
    size and unsliced: the streams must be equal, and both decodes give
    the reads back.  Returns the launches of the [256, 2^21] run."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        depress_bucket,
        press_bucket,
        slice_rows,
    )
    from honours_tpu_torch.io.batching import bucket_reads

    big = [np.concatenate([a_reads[i], a_reads[(i + 1) % len(a_reads)]])
           for i in range(len(a_reads))]
    (b,) = bucket_reads(big, max_b=256)
    del big
    B = b.sig.shape[0]
    rows = slice_rows(codec, b.L, torch.device("cuda"))
    if rows >= B:
        raise AssertionError(f"{codec}: bucket {b.sig.shape}, {rows} rows "
                             "a slice: not coded in slices")
    torch.cuda.empty_cache()
    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = press_bucket(b.sig, b.n, codec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak_press = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = depress_bucket(streams, b.n, b.L, codec)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak_depress = torch.cuda.max_memory_allocated()
    launches = {name: k.launches for name, k in KERNELS.items()}
    if not all(np.array_equal(out[j], b.sig[j, : b.n[j]])
               for j in range(B)):
        raise AssertionError(f"{codec}: the [{B}, {b.L}] bucket did not "
                             "round-trip")
    raw = 2 * int(b.n.astype(np.int64).sum())
    log(f"full bucket {codec} [{B}, {b.L}]: {-(-B // rows)} slices of "
        f"{rows} rows; round-trips; ratio "
        f"{raw / sum(map(len, streams)):.6f}; encode {t1 - t0:.3f} s, "
        f"decode {t2 - t1:.3f} s; peak memory press "
        f"{peak_press / 1e9:.3f} GB, depress {peak_depress / 1e9:.3f} GB "
        f"({smi})")
    del out, streams, b

    (a,) = bucket_reads(a_reads, max_b=256)
    torch.cuda.empty_cache()
    secs = {}
    for r in (B, rows, rows, B):
        t = time.perf_counter()
        st = press_bucket(a.sig, a.n, codec, rows=r)
        t1 = time.perf_counter()
        out = depress_bucket(st, a.n, a.L, codec, rows=r)
        secs.setdefault(r, []).append((t1 - t, time.perf_counter() - t1))
        if r == B:
            whole = st
        elif st != whole:
            raise AssertionError(f"{codec}: sliced streams differ from the "
                                 f"unsliced bucket's on [{B}, {a.L}]")
        if not all(np.array_equal(out[j], a.sig[j, : a.n[j]])
                   for j in range(B)):
            raise AssertionError(f"{codec}: [{B}, {a.L}] in slices of {r} "
                                 "rows did not decode")
    log(f"full bucket {codec} [{B}, {a.L}]: streams in slices of {rows} "
        "rows equal the unsliced ones byte for byte; both decodes give the "
        "reads back; encode, decode s (unsliced, sliced, sliced, "
        f"unsliced): {secs[B][0]}, {secs[rows][0]}, {secs[rows][1]}, "
        f"{secs[B][1]} ({smi})")
    return launches


#: phase 12's codecs that phase 9 also runs over the long set
LONG_RAW = ("uint_zd", "flat_uint_submin")


def long_phase(seed: int, smi: str) -> dict:
    """Phase 9: every kernel at [1, 2^22] (long_kernels), the long-read
    configuration (long_set) through all 21 codecs and LONG_RAW on the
    card (long_path), full [256, 2^21] buckets in slices (full_bucket),
    and the card's streams of read (e) held to the CPU route's.  The CPU
    routes and the walks' plain versions run in 4 worker processes
    beside the card's work.  Returns the launches of the long set's and
    the full buckets' runs."""
    import collections
    import multiprocessing

    from concurrent.futures import ProcessPoolExecutor

    t = time.perf_counter()
    parts = long_set(seed)
    reads = [r for k in "abcde" for r in parts[k]]
    log(f"long set: {len(reads)} reads, {sum(r.size for r in reads)} "
        f"samples, {sum(2 * r.size for r in reads) / 1e6:.1f} MB int16, "
        f"made in {time.perf_counter() - t:.1f} s")
    e_read = parts["e"][0]
    total = collections.Counter()
    ctx = multiprocessing.get_context("spawn")
    # 4 workers of the host's 8 cores, so that the card's runs keep cores
    # for their own host work
    with ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
        pending = long_kernels(parts["c"][0], pool, smi)
        cpu = {c: pool.submit(cpu_press_read, e_read, c)
               for c in (*PATHS, *LONG_RAW)}
        card = {}
        for codec in cpu:
            launches, streams = long_path(codec, reads, smi)
            total.update(launches)
            card[codec] = streams[-1]
        for codec in FULL_BUCKET:
            total.update(full_bucket(codec, parts["a"], smi))
        t = time.perf_counter()
        for codec, f in cpu.items():
            if f.result() != card[codec]:
                raise AssertionError(f"{codec}: the card's stream of read "
                                     "(e) differs from the CPU route's")
        long_kernels_held(pending, smi)
    log(f"long set: the card's streams of read (e) ({e_read.size} samples) "
        f"equal the CPU route's for all {len(cpu)} codecs (then waited "
        f"{time.perf_counter() - t:.1f} s for the host's plain versions and "
        "CPU routes)")
    log(f"long phase launches: {dict(total)}")
    return total


#: phase 10: the range-coder codecs (runner.RC_CODECS) and their kernels
#: D and E, which replace the host's C coder (no TPU kernel)
RC_REPLACES = {"rc_encode": "honours_tpu/native/rangecoder.c:488",
               "rc_decode": "honours_tpu/native/rangecoder.c:512"}
#: the two codecs phase 10 runs over every main-path read (the
#: reference's best general-purpose method and its best ratio)
RC_HEADLINE = ("rccm_vbbe21_zd", "dstall_fz")
#: dependent cycles a coded bit in the chain-floor model of kernels D
#: and E, (encode, decode): what stays serial in their design, at ~30
#: cycles a shared-memory or L1 load and ~4 an integer step.  o0 / o1:
#: encode the coder's range update alone (shift, multiply, two selects:
#: the bits are known, so the probability loads are off the chain);
#: decode the probability's load, the bound, the compare and the next
#: context.  cm, a byte's 8 bits: a nodes' phase is five dependent
#: shared-memory lookups (counters and weights, their stretch, squash,
#: apm1, the stretch of its output) and the mixer's and apm1's 16
#: integer steps between, 5 * 30 + 16 * 4 = 214; encode one phase, then
#: 8 range updates; decode two phases (bits 0-4, then 5-7 below where
#: they led) and, a bit, apm2's lookup, its 8 integer steps and the
#: decoder's 5, 30 + 13 * 4 = 82
RC_CHAIN_CYCLES = {"o0": (16, 40), "o1": (16, 40),
                   "cm": ((214 + 8 * 16) / 8, (2 * 214 + 8 * 82) / 8)}
#: integer operations a coded bit, for the operations bound
RC_STEP_OPS = {"o0": 12, "o1": 12, "cm": 120}


def rc_rows(seed: int, B: int = 24, N: int = 4096):
    """[B, N] bytes and counts of phase 10's small kernel check: an empty
    row, one byte 0 and one 255, full rows of 255, of 0, a ramp, random
    bytes, short random rows, 8 residual-like (geometric) rows of random
    lengths, then tests/rc_rows.py's rows whose model-row keys repeat (a
    run, ABAB, ABCABC, a cycle of 5, residual-like runs, cycles of 17, 33
    and 9 bytes) at lengths from N down; the first B of them."""
    rng = np.random.default_rng(seed + 10)
    rows = [np.zeros(0, np.uint8), np.array([0], np.uint8),
            np.array([255], np.uint8), np.full(N, 255, np.uint8),
            np.zeros(N, np.uint8), (np.arange(N) % 256).astype(np.uint8),
            rng.integers(0, 256, N).astype(np.uint8),
            rng.integers(0, 256, 777).astype(np.uint8)]
    for _ in range(8):
        m = int(rng.integers(1, N + 1))
        p = float(rng.uniform(0.05, 0.6))
        rows.append(np.minimum(rng.geometric(p, m), 255).astype(np.uint8))
    alias = load_tests_module("rc_rows").aliasing_rows(seed + 22, N)
    rows = (rows + [r[: N - 97 * i] for i, r in enumerate(alias)])[:B]
    data = np.zeros((B, N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    return data, np.array([r.size for r in rows], np.int32)


def rc_plain(model: str, data, n, stream):
    """Kernels D's and E's plain versions on the host, in a worker
    process on one intra-op thread: the encode of (data, n), or, given
    `stream` (the kernel's), its decode; (output, milliseconds)."""
    from honours_tpu_torch.engine import rangecoder as R

    torch.set_num_threads(1)
    t = time.perf_counter()
    if stream is None:
        out = R.rc_encode_plain(data, n, model)
    else:
        out = R.rc_decode_plain(stream, torch.zeros_like(n), n,
                                data.shape[1], model)
    return out, (time.perf_counter() - t) * 1e3


def rc_bound(nsum: int, slen: int, rows: int, model: str):
    """(bound ms, "bytes" or "operations") of coding nsum bytes into slen
    stream bytes: the bytes read once and written once (and 8 a row of
    counts), 8 coded bits a byte at RC_STEP_OPS."""
    t_bytes = (nsum + slen + 8 * rows) / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * nsum * RC_STEP_OPS[model] / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rc_floor_ms(longest: int, model: str, name: str) -> float:
    """The chain-floor model of `name` (rc_encode or rc_decode): the
    longest row's 8 coded bits a byte at RC_CHAIN_CYCLES."""
    cycles = RC_CHAIN_CYCLES[model][name == "rc_decode"]
    return 8 * longest * cycles / SM_HZ * 1e3


def rc_reuse(data, n) -> dict:
    """For each model with row slots (rangecoder_cuda.SLOTS: cm's o1 /
    o1s rows, then its o2 rows), the share of the bytes of
    data [B, N] u8 (counts n [B]) whose model rows a slot held, reused
    rather than fetched: counted on the host from the data
    (tests/rc_rows.py row_reuse, the kernels' least-recently-used slots),
    in a worker process."""
    from honours_tpu_torch.engine.rangecoder_cuda import SLOTS

    rows = load_tests_module("rc_rows")
    return {m: rows.row_reuse(data, n, s) for m, s in SLOTS.items()}


#: rows of the main path's bucket whose D and E outputs phase 10 holds to
#: the plain versions (its longest rows: the plain cm coder takes ~0.35
#: ms a coded bit on one host thread, ~3 minutes for a 65,000-byte row)
RC_LONG_ROWS = 4


def rc_bucket(seed: int, smi: str):
    """D and E at the main path's [256, 65536] (rccm_vbbe21_zd's residual
    bytes of the bucket), for each model: timed (CUDA events around 2
    calls) beside the bound and the chain floor, and the cycles a coded
    bit of the longest row logged; every row decoded back.  Returns the
    rows, their counts and, by model, (streams, lengths, encode ms,
    decode ms, bound ms, bound by, (encode floor, decode floor))."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC
    from honours_tpu_torch.engine.rc import vb_zd_parts

    sig, sn = make_bucket(seed)
    _, _, bdata, blen = vb_zd_parts(sig, sn, "vbbe21", sig.shape[1])
    bdata, blen = bdata.contiguous(), blen.to(torch.int32).contiguous()
    Bb, Nb = bdata.shape
    nsum, longest = int(blen.sum()), int(blen.max())
    bzero = torch.zeros_like(blen)
    bucket = {}
    for model in ("cm", "o1", "o0"):
        out, length = RC.rc_encode(bdata, blen, model)
        e_ms = cuda_ms(lambda: RC.rc_encode_launch(bdata, blen, model), 2)
        back = RC.rc_decode(out, bzero, blen, Nb, model)
        d_ms = cuda_ms(lambda: RC.rc_decode(out, bzero, blen, Nb, model), 2)
        if not torch.equal(back, bdata):
            raise AssertionError(f"rc_decode {model} [{Bb}, {Nb}]: rows not "
                                 "given back")
        slen = int(length.sum())
        bound, by = rc_bound(nsum, slen, Bb, model)
        floors = tuple(rc_floor_ms(longest, model, name)
                       for name in ("rc_encode", "rc_decode"))
        for name, ms, floor in (("rc_encode", e_ms, floors[0]),
                                ("rc_decode", d_ms, floors[1])):
            cycles = RC_CHAIN_CYCLES[model][name == "rc_decode"]
            log(f"kernel {name} {model} [{Bb}, {Nb}] (rccm_vbbe21_zd's "
                f"residual bytes of the bucket, {nsum} bytes, longest row "
                f"{longest}, {slen} stream bytes; {smi}): {ms:.3f} ms on the "
                f"card, bound {bound:.4f} ms ({by}), chain floor "
                f"{floor:.3f} ms ({cycles:g} cycles a coded bit), "
                f"{ms / floor:.2f}x the floor, "
                f"{ms * 1e6 / (8 * longest) * SM_HZ / 1e9:.0f} cycles a "
                "coded bit of the longest row")
        bucket[model] = (out, length, e_ms, d_ms, bound, by, floors)
    return bdata, blen, bucket


def rc_kernels_start(seed: int, pool, smi: str):
    """Phase 10's kernel half, started before phase 3 so that the plain
    versions run in `pool` on the host beside the other phases.  At the
    main path's [256, 65536] (rccm_vbbe21_zd's residual bytes of the
    bucket), for each model: D and E timed (CUDA events around 2 calls)
    beside the bound and the chain floor, every row decoded back; and
    the bucket's RC_LONG_ROWS longest rows, [4, 65536], coded alone and
    timed, their streams equal to the bucket call's rows, decoded back,
    and submitted to the plain encode (cm: and the plain decode of D's
    streams).  At [24, 4096] (rc_rows) for each model: D and E, their
    outputs after timed graph replays, one-row calls (a row alone,
    twice: each call starts its model afresh), submitted to the plain
    versions.  Returns the pending checks for rc_kernels_held."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC
    from honours_tpu_torch.engine.rangecoder import MODELS

    bdata, blen, bucket = rc_bucket(seed, smi)
    Bb, Nb = bdata.shape
    top = torch.argsort(blen, descending=True, stable=True)[:RC_LONG_ROWS]
    ldata, ln = bdata[top].contiguous(), blen[top].contiguous()
    lzero = torch.zeros_like(ln)
    reuse = pool.submit(rc_reuse, bdata.cpu().numpy(), blen.cpu().numpy())
    long_pending = {}
    for model in ("cm", "o1", "o0"):  # the longest plain job first
        out, length, e_ms, d_ms, bound, by, floors = bucket[model]
        lout, llen = RC.rc_encode(ldata, ln, model)
        le_ms = cuda_ms(lambda: RC.rc_encode_launch(ldata, ln, model), 2)
        lback = RC.rc_decode(lout, lzero, ln, Nb, model)
        ld_ms = cuda_ms(lambda: RC.rc_decode(lout, lzero, ln, Nb, model), 2)
        if not (torch.equal(lback, ldata) and torch.equal(llen, length[top])
                and torch.equal(lout, out[top])):
            raise AssertionError(f"rc {model} [{RC_LONG_ROWS}, {Nb}]: the "
                                 "longest rows alone differ from the "
                                 "bucket's or do not decode back")
        futures = [pool.submit(rc_plain, model, ldata.cpu(), ln.cpu(), None)]
        if model == "cm":
            futures.append(pool.submit(rc_plain, model, ldata.cpu(),
                                       ln.cpu(), lout.cpu()))
        long_pending[model] = dict(
            data=ldata.cpu(), n=ln.cpu(), got_e=to_cpu((lout, llen)),
            got_d=lback.cpu(), e_ms=le_ms, d_ms=ld_ms,
            bucket=(e_ms, d_ms, bound, by, floors), futures=futures)

    data, n = rc_rows(seed)
    d, nc = torch.from_numpy(data).cuda(), torch.from_numpy(n).cuda()
    N = data.shape[1]
    zero = torch.zeros_like(nc)
    pending = []
    for model in MODELS:
        def enc(m=model):
            return RC.rc_encode_launch(d, nc, m)
        out, length = enc()
        if int((length < 0).sum()):
            raise AssertionError(f"rc_encode {model}: a stream passed its cap")

        def dec(m=model, s=out):
            return RC.rc_decode(s, zero, nc, N, m)
        back = dec()
        e_ms, e_rep = graph_ms(enc, 3)
        d_ms, d_rep = graph_ms(dec, 3)
        alone = [RC.rc_encode_launch(d[6:7].contiguous(), nc[6:7], model)
                 for _ in range(2)]
        futures = [pool.submit(rc_plain, model, torch.from_numpy(data),
                               torch.from_numpy(n), s)
                   for s in (None, out.cpu())]
        pending.append((model, to_cpu((out, length)), to_cpu(e_rep),
                        to_cpu(back), to_cpu(d_rep), to_cpu(alone), e_ms,
                        d_ms, futures))
    if not all(torch.equal(p[3], torch.from_numpy(data)) for p in pending):
        raise AssertionError("rc_decode: [24, 4096] rows not given back")
    return pending, long_pending, (reuse, f"[{Bb}, {Nb}]")


def rc_kernels_held(pending, smi: str) -> dict:
    """D's and E's outputs against their plain versions from the host
    (tolerance 0): at [24, 4096], also after the timed graph's replays
    and for the one-row calls; on the main path bucket's longest rows,
    D's streams (E gave those rows back from them).  Logs each; returns
    the kernels line's entries of rc_encode and rc_decode: cm on the
    longest rows, the bucket's times beside them."""
    small, long_rows, (reuse, shape) = pending
    err = {"rc_encode": 0, "rc_decode": 0}
    shares = reuse.result()
    log(f"kernels rc_encode / rc_decode {shape} (rccm_vbbe21_zd's "
        "residual bytes of the bucket): share of bytes whose model rows a "
        "shared-memory slot held rather than fetched (cm), counted on the "
        f"host from the data: {shares['cm'][0]:.4f} (o1 and o1s rows, by the "
        f"previous byte) and {shares['cm'][1]:.4f} (o2 rows, by the previous "
        "two bytes)")
    for (model, got_e, rep_e, got_d, rep_d, alone, e_ms, d_ms,
         futures) in small:
        (want_e, plain_e), (want_d, plain_d) = (f.result() for f in futures)
        err_e = max(max_abs_err(got_e, want_e), max_abs_err(rep_e, want_e))
        for out, length in alone:  # row 6 alone
            err_e = max(err_e, max_abs_err((out[0], length[0]),
                                           (want_e[0][6], want_e[1][6])))
        err_d = max(max_abs_err(got_d, want_d), max_abs_err(rep_d, want_d))
        if err_e or err_d:
            raise AssertionError(f"rc {model} [24, 4096]: kernel differs "
                                 f"from its plain version (encode err "
                                 f"{err_e}, decode err {err_d})")
        for name, ms, plain, e in (("rc_encode", e_ms, plain_e, err_e),
                                   ("rc_decode", d_ms, plain_d, err_d)):
            log(f"kernel {name} {model} [24, 4096] ({smi}): equal to plain "
                f"(max abs err {e}, also after the replays and alone in a "
                f"one-row call, twice); {ms:.4f} ms on the card vs plain "
                f"{plain:.1f} ms on the host (one thread of a worker "
                "process)")
    records = {}
    for model, p in long_rows.items():
        results = [f.result() for f in p["futures"]]
        (want_e, plain_e) = results[0]
        e = max_abs_err(p["got_e"], want_e)
        d = max_abs_err(p["got_d"], p["data"])
        if len(results) > 1:
            d = max(d, max_abs_err(p["got_d"], results[1][0]))
        if e or d:
            raise AssertionError(f"rc {model} [{RC_LONG_ROWS}, 65536], the "
                                 "main path bucket's longest rows: kernel "
                                 f"differs from its plain version (encode "
                                 f"err {e}, decode err {d})")
        rows = p["n"].tolist()
        log(f"kernel rc_encode {model} [{RC_LONG_ROWS}, 65536], the main "
            f"path bucket's longest rows ({rows} bytes; {smi}): streams "
            f"equal to plain, and rc_decode gives the rows back from them "
            f"(max abs err {e}, {d}); {p['e_ms']:.3f} / {p['d_ms']:.3f} ms "
            f"on the card vs plain {plain_e:.1f} ms"
            + (f" / {results[1][1]:.1f} ms" if len(results) > 1 else "")
            + " on the host (one thread of a worker process)")
        err = {k: max(v, e, d) for k, v in err.items()}
        if model != "cm":
            continue
        nsum = sum(rows)
        slen = int(p["got_e"][1].sum())
        bound, by = rc_bound(nsum, slen, len(rows), "cm")
        e_b, d_b, b_bound, b_by, b_floor = p["bucket"]
        for name, ms, plain, bucket_ms in (
                ("rc_encode", p["e_ms"], plain_e, e_b),
                ("rc_decode", p["d_ms"], results[1][1], d_b)):
            records[name] = {
                "name": name, "route": "cuda",
                "source": "honours_tpu_torch/csrc/rangecoder.cu",
                "replaces": RC_REPLACES[name], "launches": 0,
                "max_abs_err": err[name], "matches_plain": True, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": None,
                "shape": f"[{RC_LONG_ROWS}, 65536] cm, the main path "
                         "bucket's longest rows",
                "chain_floor_ms": rc_floor_ms(max(rows), "cm", name),
                "bucket_ms": bucket_ms, "bucket_shape": "[256, 65536] cm",
                "bucket_bound_ms": b_bound, "bucket_bound_by": b_by,
                "bucket_chain_floor_ms": b_floor[name == "rc_decode"]}
    return records


def cpu_rc_press(reads, codec: str) -> list:
    """The CPU route's streams of `reads`, in a worker process on one
    intra-op thread."""
    from honours_tpu_torch.engine.runner import press_signals

    torch.set_num_threads(1)
    return press_signals(reads, codec, device="cpu")


def rc_check_reads(seed: int, reads) -> list:
    """The reads whose card streams phase 10 holds to the CPU route's for
    every range-coder codec: the 1- and 7-sample edge reads, 1,000
    samples of a main-path read, and a 1,000-sample read with a flat
    stall of 400 inside its in-band range (which the stall codecs
    split)."""
    rng = np.random.default_rng(seed + 11)
    stall = np.concatenate([rng.integers(200, 1000, 300),
                            600 + rng.integers(-4, 5, 400),
                            rng.integers(200, 1000, 300)]).astype(np.int16)
    return [reads[-4], reads[-3], reads[0][:1000].copy(), stall]


def rc_path(codec: str, reads, smi: str, rates: bool = True,
            want: set = None, tag: str = "rc") -> dict:
    """Press and depress `reads` through the runner on the card, every
    launch count at 0 just before; every read back bit for bit and the
    kernels `want` launched (by default D and E, and kernel A for the
    stall codecs).  Logs the ratio,
    the rates (or, without `rates`, the times: of a small set, where
    one-row re-presses and short reads take most of them, no
    throughput) and, for the stall codecs, the split rows.  Returns the
    launches."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        depress_signals,
        press_signals,
    )

    lens = [r.size for r in reads]
    raw = 2 * sum(lens)
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
    if want is None:
        want = {"rc_encode", "rc_decode"}
        if "stall" in codec:
            want.add("find_stall")
    idle = sorted(k for k in want if launches[k] == 0)
    if idle:
        raise AssertionError(f"{codec}: kernels not launched: {idle}")
    split = (f", split rows {split_rows(streams)}" if "stall" in codec
             else "")
    times = (f"encode {t1 - t0:.3f} s {raw / (t1 - t0) / 1e6:.1f} MB/s, "
             f"decode {t2 - t1:.3f} s {raw / (t2 - t1) / 1e6:.1f} MB/s"
             if rates else f"encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s "
             "(a small set: no throughput)")
    log(f"{tag} {codec}: all {len(reads)} reads round-trip bit for bit; "
        f"ratio {raw / sum(map(len, streams)):.6f}; {times}{split} ({smi}); "
        "launches "
        + ", ".join(f"{k} {launches[k]}" for k in sorted(want)))
    return launches


def rc_cli(reads, smi: str) -> dict:
    """A BLOW5 of the CLI phases' 68 reads pressed and depressed through
    the port's CLI on the card with rccm_vbbe21_zd and dstall_fz; every
    signal back.  Returns the launches."""
    import collections

    from honours_tpu_torch import cli
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.io import blow5

    total = collections.Counter()
    with build_tmp() as tmp:
        src = Path(tmp) / "src.blow5"
        sel = cli_file(reads, src)
        for codec in RC_HEADLINE:
            for k in KERNELS.values():
                k.launches = 0
            pressed = Path(tmp) / f"{codec}.blow5"
            back = Path(tmp) / f"{codec}.depressed.blow5"
            t0 = time.perf_counter()
            if cli.main(["press", str(src), str(pressed), "--codec",
                         codec]) != 0:
                raise AssertionError(f"cli press {codec} failed")
            t1 = time.perf_counter()
            if cli.main(["depress", str(pressed), str(back)]) != 0:
                raise AssertionError(f"cli depress {codec} failed")
            t2 = time.perf_counter()
            got = blow5.read_blow5(str(back)).reads
            if len(got) != len(sel) or not all(
                    np.array_equal(r.signal, s) for r, s in zip(got, sel)):
                raise AssertionError(f"cli {codec}: signals differ after "
                                     "press and depress")
            total.update({name: k.launches for name, k in KERNELS.items()})
            log(f"rc cli {codec}: press {pressed.stat().st_size} B in "
                f"{t1 - t0:.3f} s, depress {back.stat().st_size} B in "
                f"{t2 - t1:.3f} s, every one of {len(sel)} signals back "
                f"({smi})")
    return total


def rc_bucketed() -> tuple:
    """The range-coder codecs but RC_HEADLINE that press a bucket a
    container (those over the zigzag deltas and the dstall split); the
    other 7 press a read at a time."""
    from honours_tpu_torch.engine.runner import RC_CODECS

    return tuple(sorted(c for c in set(RC_CODECS) - set(RC_HEADLINE)
                        if c.endswith("_zd") or c.startswith("dstall")))


def rc_phase(seed: int, reads, cpu, smi: str) -> dict:
    """Phase 10: the two headline codecs (RC_HEADLINE) and the 16 other
    codecs that press a bucket a container (rc_bucketed) over every
    main-path read, the 7 that press a read at a time over the four edge
    reads and the 60 shortest reads, rccm_svbbe21_zd and dstall_fz over
    the stall set, each with every launch count at 0 just before
    (rc_path); the card's streams of rc_check_reads equal to the CPU
    route's (`cpu`: futures by codec); the CLI round trip (rc_cli).
    Returns the launches of its runs."""
    import collections

    from honours_tpu_torch.engine.runner import RC_CODECS, press_signals
    from honours_tpu_torch.synth import stall_set

    total = collections.Counter()
    t = time.perf_counter()
    for codec in RC_HEADLINE + rc_bucketed():
        total.update(rc_path(codec, reads, smi))
    order = np.argsort([r.size for r in reads[:-4]], kind="stable")
    few = [reads[i] for i in order[:60]] + reads[-4:]
    for codec in sorted(set(RC_CODECS) - set(RC_HEADLINE)
                        - set(rc_bucketed())):
        total.update(rc_path(codec, few, smi, rates=False))
    stalls = stall_set(seed)
    for codec in ("rccm_svbbe21_zd", "dstall_fz"):
        total.update(rc_path(codec, stalls, smi, rates=False))
    total.update(rc_cli(reads, smi))
    check = rc_check_reads(seed, reads)
    for codec, f in cpu.items():
        if press_signals(check, codec) != f.result():
            raise AssertionError(f"{codec}: the card's streams differ from "
                                 "the CPU route's")
    log(f"rc: the card's streams of {len(check)} reads (n = "
        f"{[r.size for r in check]}) equal the CPU route's for all "
        f"{len(cpu)} range-coder codecs; phase 10 took "
        f"{time.perf_counter() - t:.1f} s")
    return total


#: kernels each phase-11 codec must launch besides kernel 1's five
#: entries (every exception block) and, for vbsse21, svb16's two (its
#: exception values)
ENTROPY_PATHS = {
    **{f"rccdf_{k}_zd": {"rccdf_encode", "rccdf_decode"}
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")},
    **{f"huffman_{k}_zd": {"huffman_build", "huffman_decode_rows"}
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")},
    **{f"shuffman_{k}_zd": {"huffman_decode"}
       for k in ("vbe21", "vbsbe21", "vbsse21")},
}


def entropy_phase(reads, check, cpu, smi: str) -> dict:
    """Phase 11: the 11 per-read entropy codecs (engine.runner
    .ENTROPY_CODECS) over every main-path read, each with every launch
    count at 0 just before (rc_path: every read back bit for bit, its
    kernels and kernel 1 launched, svb16 for vbsse21; its ratio and
    rates logged); the card's streams of `check` (rc_check_reads) equal
    to the CPU route's (`cpu`: futures by codec).  Returns the
    launches."""
    import collections

    from honours_tpu_torch.engine.runner import press_signals

    total = collections.Counter()
    t = time.perf_counter()
    for codec, kernels in ENTROPY_PATHS.items():
        want = kernels | KERNEL_1
        if "vbsse21" in codec:
            want |= {"svb16_encode", "svb16_decode"}
        total.update(rc_path(codec, reads, smi, want=want, tag="entropy"))
    for codec, f in cpu.items():
        if press_signals(check, codec) != f.result():
            raise AssertionError(f"{codec}: the card's streams differ from "
                                 "the CPU route's")
    log(f"entropy: the card's streams of {len(check)} reads (n = "
        f"{[r.size for r in check]}) equal the CPU route's for all "
        f"{len(cpu)} per-read entropy codecs; phase 11 took "
        f"{time.perf_counter() - t:.1f} s")
    return total


#: kernels each phase-12 codec must launch
RAW_PATHS = {
    **{k: KERNEL_1 for k in ("vb1e2", "vbe21", "vbbe21", "vbsbe21")},
    "vbsse21": KERNEL_1 | {"svb16_encode", "svb16_decode"},
    "svb": SVB32,
    "svb0124": SVB32,
    "svb12_nosimd": {"svb16_encode", "svb16_decode"},
    "svb12_zd_nosimd": {"svb16_encode", "svb16_decode"},
    **{k: {"bitpack_msb", "bitunpack_msb"}
       for k in ("uintx_16", "uint11", "uint", "uint_submin", "uint_zd")},
    "uint_zsm": {"bitpack_msb", "bitunpack_msb", "zsm_mean"},
    "flat_uint_submin": {"flats_partition", "bitpack_msb", "bitunpack_msb",
                         "monotone_compact_i32", "hdrwalk"},
}


def cpu_round(reads, codec: str):
    """The CPU route's streams of `reads` and its decode of them, in a
    worker process on one intra-op thread."""
    from honours_tpu_torch.engine.runner import (
        depress_signals,
        press_signals,
    )

    torch.set_num_threads(1)
    streams = press_signals(reads, codec, device="cpu")
    return streams, depress_signals(streams, [r.size for r in reads], codec,
                                    device="cpu")


def uint11_path(reads, cpu, smi: str) -> dict:
    """uint11 over `reads` on the card, every launch count at 0 just
    before: its streams and its decode equal the CPU route's (`cpu`: a
    future of cpu_round) for every read, I and J launched; the reads
    that do not round-trip (a sample outside [0, 2048)) are counted, as
    uint11 keeps 11 bits a sample.  Returns the launches."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        depress_signals,
        press_signals,
    )

    lens = [r.size for r in reads]
    raw = 2 * sum(lens)
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    streams = press_signals(reads, "uint11")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = depress_signals(streams, lens, "uint11")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: k.launches for name, k in KERNELS.items()}
    want_streams, want_out = cpu.result()
    if streams != want_streams:
        raise AssertionError("uint11: the card's streams differ from the "
                             "CPU route's")
    bad = [i for i, (a, b) in enumerate(zip(out, want_out))
           if not np.array_equal(a, b)]
    if bad:
        raise AssertionError(f"uint11: the card's decode of reads {bad[:8]} "
                             "differs from the CPU route's")
    idle = sorted(k for k in RAW_PATHS["uint11"] if launches[k] == 0)
    if idle:
        raise AssertionError(f"uint11: kernels not launched: {idle}")
    lossy = sum(not np.array_equal(a, r) for a, r in zip(out, reads))
    log(f"raw uint11: the card's streams and decode equal the CPU route's "
        f"for all {len(reads)} reads; {lossy} of them do not round-trip "
        f"(11 bits a sample); ratio {raw / sum(map(len, streams)):.6f}; "
        f"encode {t1 - t0:.3f} s {raw / (t1 - t0) / 1e6:.1f} MB/s, decode "
        f"{t2 - t1:.3f} s {raw / (t2 - t1) / 1e6:.1f} MB/s ({smi}); launches "
        + ", ".join(f"{k} {launches[k]}" for k in sorted(RAW_PATHS["uint11"])))
    return launches


def raw_phase(reads, check, cpu, u11, smi: str) -> dict:
    """Phase 12: the 16 raw-sample and bit-packing codecs (engine.runner
    .RAW_CODECS) over every main-path read, each with every launch count
    at 0 just before (rc_path: every read back bit for bit, its kernels
    launched, ratio and rates logged; uint11: uint11_path, with `u11` the
    CPU route's round of every read); the card's streams of `check`
    (rc_check_reads) equal the CPU route's (`cpu`: futures by codec).
    Returns the launches."""
    import collections

    from honours_tpu_torch.engine.runner import press_signals

    total = collections.Counter()
    t = time.perf_counter()
    for codec, kernels in RAW_PATHS.items():
        if codec == "uint11":
            total.update(uint11_path(reads, u11, smi))
        else:
            total.update(rc_path(codec, reads, smi, want=kernels, tag="raw"))
    for codec, f in cpu.items():
        if press_signals(check, codec) != f.result():
            raise AssertionError(f"{codec}: the card's streams differ from "
                                 "the CPU route's")
    log(f"raw: the card's streams of {len(check)} reads (n = "
        f"{[r.size for r in check]}) equal the CPU route's for all "
        f"{len(cpu)} raw-sample codecs; phase 12 took "
        f"{time.perf_counter() - t:.1f} s")
    return total


#: kernels each phase-13 codec must launch (kernel 1's i32 entries place
#: turbopfor's exception bytes and flac's Rice fields)
BLOCK_PATHS = {
    "turbopfor": {"hdrwalk", "bitpack_msb", "bitunpack_msb",
                  "monotone_compact_i32", "monotone_expand_i32"},
    "flac": {"flac_decode", "monotone_compact_i32", "monotone_expand_i32"},
}


def zstd_missing():
    """Why the zstd layers cannot run here, or None where `zstandard`
    imports."""
    try:
        import zstandard  # noqa: F401
    except ImportError as e:
        return f"{type(e).__name__}: {e}"
    return None


def last_codecs() -> list:
    """The 33 codecs phase 13 runs: turbopfor, flac, none and the 30 byte
    layers (runner.BLOCK_CODECS, LAYER_CODECS), less the zstd ones where
    `zstandard` does not import."""
    from honours_tpu_torch.engine.runner import BLOCK_CODECS, LAYER_CODECS

    names = sorted({**BLOCK_CODECS, **LAYER_CODECS})
    return [c for c in names if not (zstd_missing() and "zstd" in c)]


def block_phase(reads, check, cpu, smi: str) -> dict:
    """Phase 13: turbopfor and flac over every main-path read, each with
    every launch count at 0 just before (rc_path: every read back bit for
    bit, M, I and J or N launched, ratio and rates logged); none and the
    30 byte layers over the four edge reads and the 60 shortest reads
    (every read back; the zstd ones only where `zstandard` imports, the
    others named on a log line); the card's streams of `check`
    (rc_check_reads) equal the CPU route's (`cpu`: futures by codec) for
    all of them.  Returns the launches."""
    import collections

    from honours_tpu_torch.engine.runner import press_signals

    total = collections.Counter()
    t = time.perf_counter()
    for codec, kernels in BLOCK_PATHS.items():
        total.update(rc_path(codec, reads, smi, want=kernels, tag="block"))
    order = np.argsort([r.size for r in reads[:-4]], kind="stable")
    few = [reads[i] for i in order[:60]] + reads[-4:]
    run = [c for c in last_codecs() if c not in BLOCK_PATHS]
    for codec in run:
        total.update(rc_path(codec, few, smi, rates=False, want=set(),
                             tag="layer"))
    why = zstd_missing()
    if why:
        from honours_tpu_torch.engine.runner import LAYER_CODECS

        skipped = sorted(c for c in LAYER_CODECS if "zstd" in c)
        log(f"layer: skipped the {len(skipped)} zstd codecs ({why}): "
            + ", ".join(skipped))
    for codec, f in cpu.items():
        if press_signals(check, codec) != f.result():
            raise AssertionError(f"{codec}: the card's streams differ from "
                                 "the CPU route's")
    log(f"block: the card's streams of {len(check)} reads (n = "
        f"{[r.size for r in check]}) equal the CPU route's for all "
        f"{len(cpu)} of turbopfor, flac, none and the layers run here; "
        f"phase 13 took {time.perf_counter() - t:.1f} s")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check and time the kernels, then stop "
                    "(no main path, no result lines)")
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
    log("clocks (sm, max sm): " + nvidia_smi("clocks.sm,clocks.max.sm"))
    t = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t:.1f} s")

    results = check_kernels(args.seed)
    if args.kernels_only:
        rc_bucket(args.seed, smi)
        return 0
    import multiprocessing

    from concurrent.futures import ProcessPoolExecutor

    from honours_tpu_torch.engine.runner import (
        ENTROPY_CODECS,
        RAW_CODECS,
        RC_CODECS,
    )

    # phase 10's plain versions and CPU routes (and phase 11's, 12's and
    # 13's CPU routes) run on the host in 3 worker processes beside phases
    # 3-9
    with ProcessPoolExecutor(max_workers=3, mp_context=multiprocessing
                             .get_context("spawn")) as rc_pool:
        rc_pending = rc_kernels_start(args.seed, rc_pool, smi)
        reads = read_set(args.seed)
        check = rc_check_reads(args.seed, reads)
        rc_cpu = {c: rc_pool.submit(cpu_rc_press, check, c)
                  for c in sorted(RC_CODECS)}
        entropy_cpu = {c: rc_pool.submit(cpu_rc_press, check, c)
                       for c in sorted(ENTROPY_CODECS)}
        raw_cpu = {c: rc_pool.submit(cpu_rc_press, check, c)
                   for c in sorted(RAW_CODECS)}
        block_cpu = {c: rc_pool.submit(cpu_rc_press, check, c)
                     for c in last_codecs()}
        u11_cpu = rc_pool.submit(cpu_round, reads, "uint11")
        results.update({k: {"launches": 0} for k in RC_REPLACES})
        log(f"main path: {len(reads)} reads, {sum(r.size for r in reads)} "
            f"samples, {sum(2 * r.size for r in reads) / 1e6:.1f} MB int16")
        for codec in PATHS:
            for k, c in main_path(codec, reads).items():
                results[k]["launches"] += c
        stall_phase(args.seed)
        cli_phase(reads)
        for k, c in bench_analyze_phase(reads, smi).items():
            results[k]["launches"] += c
        for k, c in shard_phase(args.seed).items():
            results[k]["launches"] += c
        for k, c in bench_phase(smi).items():
            results[k]["launches"] += c
        for k, c in long_phase(args.seed, smi).items():
            results[k]["launches"] += c
        for k, c in rc_phase(args.seed, reads, rc_cpu, smi).items():
            results[k]["launches"] += c
        for k, c in entropy_phase(reads, check, entropy_cpu, smi).items():
            results[k]["launches"] += c
        for k, c in raw_phase(reads, check, raw_cpu, u11_cpu, smi).items():
            results[k]["launches"] += c
        for k, c in block_phase(reads, check, block_cpu, smi).items():
            results[k]["launches"] += c
        held = rc_kernels_held(rc_pending, smi)
    for k, r in held.items():
        r["launches"] = results[k]["launches"]
        results[k] = r
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
