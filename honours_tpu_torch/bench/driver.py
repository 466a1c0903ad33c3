"""Benchmark driver: the VBZ-class pipeline on one card.

The port of the JAX system's root bench.py, run from the repository
root (it reads tests/data/three-reads.blow5) as

    python -m honours_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout (the log goes to stderr):
  {"metric": "vbz_svb16zd_enc_dec_GBps_per_chip", "value": N,
   "unit": "GB/s", "vs_baseline": N, "extra": {...}}

Measured quantity: encode+decode throughput of the svb16-zd (VBZ
container) batched engine on fixture-derived signal, GB/s per card,
total bytes / (t_enc + t_dec).  Baseline: the reference's single-core
zstd-svb-zd encode+decode on the NA12878 corpus (BASELINE.md: 113.471
GB x2 / (388.1 s + 381.8 s) = 0.295 GB/s).  `extra` names the card and
its power limit, beside which every rate stands.

Ten sections, in plan order: svb16 (the headline), vbz_ratio, srans2,
drans, srans, srans3, dstall, heldout, synthetic, dstall_drans.  A
section skipped for budget or error is recorded in extra["skipped"];
the wall-clock budget (HTPU_BENCH_BUDGET_S, default 2100 s) is a SIGALRM
that ledgers the section it lands in and every later one.  Each
section's times are host-clock walls: one warm call, a synchronize,
`reps` calls, a synchronize.  Ratios are over the unique fixture chunks
only.  Every round trip is checked, and the srans2, srans3, drans and
dstall_drans streams of the JAX bench's rows are held to the port's CPU
route (`*_host_parity`).  The VBZ ratios need the `zstandard` package;
where it does not import, vbz_ratio is skipped with that reason and the
synthetic section reports the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from honours_tpu_torch.device import resolve_device

METRIC = "vbz_svb16zd_enc_dec_GBps_per_chip"
BASELINE_VBZ_ENC_DEC_GBPS = 2 * 113.471 / (388.1 + 381.8)
#: the reference method with comparable ratio to srans (rc01s-vbbe21-zd,
#: ratio 2.9913; BASELINE.md enc 5828.5 s / dec 6640.1 s single-core)
BASELINE_RC01S_ENC_DEC_GBPS = 2 * 113.471 / (5828.5 + 6640.1)

B = 256
L = 1 << 16
REPS = 10
FIXTURE = "tests/data/three-reads.blow5"
#: what the synthetic section leaves for dstall_drans and the epilogue:
#: about 3x dstall_drans's ~10 s on an H100 80GB HBM3 (700 W)
SYNTH_RESERVE_S = 30


class BenchTimeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise BenchTimeout()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name(dev: torch.device) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it
    (torch's device name where nvidia-smi is absent); "cpu" on the
    CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)


def build_batch(B: int, L: int):
    """B chunks of length L tiled from the fixture reads.

    The fixture holds ~250 KB of unique signal; the batch tiles it to
    fill [B, L].  Throughput numbers are unaffected by the tiling;
    RATIOS are therefore reported over the unique chunks only (the first
    n_unique rows) and the JSON discloses corpus_unique_bytes."""
    from honours_tpu_torch.io.blow5 import read_blow5

    chunks = []
    for r in read_blow5(FIXTURE, device="cpu").reads:
        s = r.signal
        for i in range(0, s.size - L + 1, L):
            chunks.append(s[i: i + L])
    n_unique = min(len(chunks), B)
    while len(chunks) < B:
        chunks = chunks + chunks
    return np.stack(chunks[:B]), n_unique


class Bench:
    """One run: the batch on the device, the skip ledger, `extra`, and
    the state sections hand on.  `lengths` keeps the exact byte counts
    behind each ratio, for callers that check them: a section's unique
    rows' stream lengths (drans_tiled: those of the tiled batch's fit),
    the VBZ bytes of the unique rows, and the synthetic section's bytes
    a batch (synth_srans2, synth_drans, synth_vbz)."""

    def __init__(self, budget_s: float = None):
        self.budget_s = (int(os.environ.get("HTPU_BENCH_BUDGET_S", "2100"))
                         if budget_s is None else budget_s)
        self.t0 = time.time()
        self.skipped: list = []
        self.extra: dict = {}
        self.state: dict = {}
        self.lengths: dict = {}

    def load(self, device="cuda", B: int = B, L: int = L):
        self.dev = resolve_device(device)
        self.card = card_name(self.dev)
        self.B, self.L, self.emax = B, L, L // 16
        self.base, self.n_unique = build_batch(B, L)
        self.nbytes = self.base.size * 2
        self.unique_bytes = self.n_unique * L * 2
        self.sig = torch.from_numpy(self.base).to(self.dev)
        self.n = torch.full((B,), L, dtype=torch.int32, device=self.dev)
        return self

    def budget_left(self) -> float:
        return self.budget_s - (time.time() - self.t0)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def timed(self, fn, reps: int = REPS) -> float:
        """Seconds a call of fn() on the host clock: one warm call, a
        synchronize, `reps` calls, a synchronize."""
        fn()
        self.sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        self.sync()
        return max((time.perf_counter() - t0) / reps, 1e-9)

    def o1_tabs(self):
        from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

        if "o1_tabs" not in self.state:
            self.state["o1_tabs"] = canned_o1_device_tables(self.dev)
        return self.state["o1_tabs"]

    def ratio(self, name: str, lens) -> float:
        """unique_bytes over the unique rows' stream bytes; keeps the
        lengths under `name`."""
        self.lengths[name] = [int(x) for x in lens[: self.n_unique].tolist()]
        return self.unique_bytes / sum(self.lengths[name])

    def unique_batch(self):
        """The unique chunks, padded with one-sample rows to 8 rows where
        there are fewer, as ([rows, L] int16, [rows] int32) on the
        device."""
        from honours_tpu_torch.engine.pipeline import pad_batch

        small = [self.base[i] for i in range(self.n_unique)]
        small += [np.zeros(1, np.int16)] * (8 - len(small))
        return pad_batch(small, self.L, device=self.dev)

    def rates(self, prefix: str, t_enc: float, t_dec: float) -> float:
        """Records prefix_enc_GBps / _dec_GBps; returns the enc+dec rate."""
        self.extra[f"{prefix}_enc_GBps"] = round(self.nbytes / t_enc / 1e9, 4)
        self.extra[f"{prefix}_dec_GBps"] = round(self.nbytes / t_dec / 1e9, 4)
        return 2 * self.nbytes / (t_enc + t_dec) / 1e9


def rows(st, sl, k: int) -> list[bytes]:
    """The first k rows' streams as bytes."""
    st, sl = st[:k].cpu().numpy(), sl[:k].cpu().numpy()
    return [st[i, : sl[i]].tobytes() for i in range(k)]


def cpu_rows(press, tables, sig, n, emax: int) -> list[bytes]:
    """The port's CPU route over the same rows: `press` with the tables
    built on the CPU, on CPU copies of sig and n."""
    cpu = torch.device("cpu")
    st, sl = press(sig.cpu(), n.cpu(), tables(cpu), emax)
    return rows(st, sl, sig.shape[0])


def rates_text(b: Bench, t_enc: float, t_dec: float) -> str:
    return (f"enc {b.nbytes / t_enc / 1e9:.2f} GB/s, dec "
            f"{b.nbytes / t_dec / 1e9:.2f} GB/s")


def vbz_bytes(cctx, stream, lens, k: int) -> int:
    """zstd level 1 over the first k rows' svb16-zd streams, plus the
    4-byte length each VBZ record carries."""
    st, ln = stream[:k].cpu().numpy(), lens[:k].cpu().numpy()
    return sum(len(cctx.compress(st[i, : ln[i]].tobytes())) + 4
               for i in range(k))


# ---- 1. VBZ container (the svb16 kernels; the headline) ----
def sec_svb16(b: Bench):
    from honours_tpu_torch.engine.svb16 import (
        svb16_decode_batch,
        svb16_encode_batch,
    )

    stream, out_len = svb16_encode_batch(b.sig, b.n, zd=True)
    dec = svb16_decode_batch(stream, b.n, b.L, zd=True)
    ok = bool(torch.equal(dec, b.sig))
    t_enc = b.timed(lambda: svb16_encode_batch(b.sig, b.n, zd=True))
    t_dec = b.timed(lambda: svb16_decode_batch(stream, b.n, b.L, zd=True))
    log(f"svb16-zd: {rates_text(b, t_enc, t_dec)}, lossless={ok}")
    b.state.update(svb_stream=stream, svb_len=out_len,
                   gbps=b.rates("svb16", t_enc, t_dec))
    b.extra.update(svb16_lossless=ok)


# ---- 2. VBZ ratio (host zstd over the svb16 stream, level 1) ----
def sec_vbz(b: Bench):
    import zstandard

    cctx = zstandard.ZstdCompressor(level=1)
    t0 = time.time()
    c = vbz_bytes(cctx, b.state["svb_stream"], b.state["svb_len"],
                  b.n_unique)
    b.lengths["vbz_ratio"] = [c]
    b.state["vbz_ratio"] = b.unique_bytes / c
    log(f"VBZ (zstd over svb16-zd): ratio {b.state['vbz_ratio']:.4f}, "
        f"host zstd {time.time() - t0:.2f}s")
    b.extra.update(vbz_ratio=round(b.state["vbz_ratio"], 4))


# ---- 3. srans2 flagship (order-1) ----
def sec_srans2(b: Bench):
    from honours_tpu_torch.engine.pipeline import (
        canned_o1_device_tables,
        depress_srans2_batch,
        press_srans2_batch,
    )

    tabs = b.o1_tabs()
    s3, l3 = press_srans2_batch(b.sig, b.n, tabs, b.emax)
    ratio = b.ratio("srans2", l3)
    d3 = depress_srans2_batch(s3, b.n, tabs, b.L, emax=b.emax)
    ok = bool(torch.equal(d3, b.sig))
    parity = rows(s3, l3, 1) == cpu_rows(
        press_srans2_batch, canned_o1_device_tables, b.sig[:1], b.n[:1],
        b.emax)
    t_enc = b.timed(lambda: press_srans2_batch(b.sig, b.n, tabs, b.emax))
    t_dec = b.timed(lambda: depress_srans2_batch(s3, b.n, tabs, b.L,
                                                 emax=b.emax))
    log(f"srans2: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f}, "
        f"lossless={ok}, host-parity={parity}")
    b.state["srans2_ratio"] = ratio
    rate = b.rates("srans2", t_enc, t_dec)
    b.extra.update(
        srans2_ratio=round(ratio, 4),
        srans2_lossless=ok,
        srans2_host_parity=parity,
        srans2_vs_rc01s_throughput=round(rate / BASELINE_RC01S_ENC_DEC_GBPS,
                                         1),
    )


# ---- 4. dstall_srans2 (stall-aware flagship) ----
def sec_dstall(b: Bench):
    from honours_tpu_torch.engine.dstall import (
        depress_dstall_batch,
        press_dstall_batch,
    )

    tabs = b.o1_tabs()
    s4, l4 = press_dstall_batch(b.sig, b.n, tabs, b.emax)
    ratio = b.ratio("dstall", l4)
    d4 = depress_dstall_batch(s4, b.n, tabs, b.L, emax=b.emax)
    ok = bool(torch.equal(d4, b.sig))
    t_enc = b.timed(lambda: press_dstall_batch(b.sig, b.n, tabs, b.emax),
                    reps=4)
    t_dec = b.timed(lambda: depress_dstall_batch(s4, b.n, tabs, b.L,
                                                 emax=b.emax), reps=4)
    log(f"dstall: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f}, "
        f"lossless={ok}")
    b.rates("dstall", t_enc, t_dec)
    b.extra.update(dstall_ratio=round(ratio, 4), dstall_lossless=ok)


# ---- 5. drans (self-contained table; no train/test caveat) ----
def sec_drans(b: Bench):
    from honours_tpu_torch.engine.drans import (
        depress_drans_batch,
        press_drans_batch,
    )
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    tabs = b.o1_tabs()
    s5, l5 = press_drans_batch(b.sig, b.n, tabs, b.emax)
    d5 = depress_drans_batch(s5, b.n, tabs, b.L, emax=b.emax)
    ok = bool(torch.equal(d5, b.sig))
    tiled = b.ratio("drans_tiled", l5)
    # RATIO comes from the unique-chunk batch: tiling the fixture x85
    # duplicates the fit counts, which degrades the prefix-fitted model
    # on this corpus; a real file holds each chunk once.  The one-sample
    # rows that pad it to 8 add nothing to the shared fit.
    sj, nj = b.unique_batch()
    se, le = press_drans_batch(sj, nj, tabs, b.emax)
    parity = rows(se, le, b.n_unique) == cpu_rows(
        press_drans_batch, canned_o1_device_tables, sj, nj,
        b.emax)[: b.n_unique]
    du = depress_drans_batch(se, nj, tabs, b.L, emax=b.emax)
    ok = ok and bool(torch.equal(du, sj))
    ratio = b.ratio("drans", le)
    t_enc = b.timed(lambda: press_drans_batch(b.sig, b.n, tabs, b.emax),
                    reps=4)
    t_dec = b.timed(lambda: depress_drans_batch(s5, b.n, tabs, b.L,
                                                emax=b.emax), reps=4)
    log(f"drans: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f} "
        f"(self-contained), lossless={ok}, host-parity={parity}")
    b.rates("drans", t_enc, t_dec)
    b.extra.update(
        drans_ratio=round(ratio, 4),
        drans_ratio_tiled=round(tiled, 4),
        drans_lossless=ok,
        drans_host_parity=parity,
        drans_protocol="model fitted from the stream's own prefix by "
        "both encoder and decoder; zero table bytes; no training "
        "data; ratio measured on the unique-chunk batch (tiled-batch "
        "fit disclosed as drans_ratio_tiled)",
    )


# ---- 6. srans (order-0) ----
def sec_srans(b: Bench):
    from honours_tpu_torch.engine.pipeline import (
        canned_rans_tables,
        depress_srans_batch,
        press_srans_batch,
    )

    tabs = canned_rans_tables(b.dev)
    s2, l2 = press_srans_batch(b.sig, b.n, tabs, b.emax)
    ratio = b.ratio("srans", l2)
    d2 = depress_srans_batch(s2, b.n, tabs, b.L, emax=b.emax)
    ok = bool(torch.equal(d2, b.sig))
    t_enc = b.timed(lambda: press_srans_batch(b.sig, b.n, tabs, b.emax))
    t_dec = b.timed(lambda: depress_srans_batch(s2, b.n, tabs, b.L,
                                                emax=b.emax))
    log(f"srans: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f}, "
        f"lossless={ok}")
    rate = b.rates("srans", t_enc, t_dec)
    b.extra.update(
        srans_ratio=round(ratio, 4),
        srans_lossless=ok,
        srans_vs_rc01s_throughput=round(rate / BASELINE_RC01S_ENC_DEC_GBPS,
                                        1),
    )


# ---- 7. srans3 (nibble order-1) ----
def sec_srans3(b: Bench):
    from honours_tpu_torch.engine.pipeline import (
        canned_o1n_device_tables,
        depress_srans3_batch,
        press_srans3_batch,
    )

    tabs3 = canned_o1n_device_tables(b.dev)
    s4, l4 = press_srans3_batch(b.sig, b.n, tabs3, b.emax)
    ratio = b.ratio("srans3", l4)
    d4 = depress_srans3_batch(s4, b.n, tabs3, b.L, emax=b.emax)
    ok = bool(torch.equal(d4, b.sig))
    parity = rows(s4, l4, 1) == cpu_rows(
        press_srans3_batch, canned_o1n_device_tables, b.sig[:1], b.n[:1],
        b.emax)
    t_enc = b.timed(lambda: press_srans3_batch(b.sig, b.n, tabs3, b.emax),
                    reps=4)
    t_dec = b.timed(lambda: depress_srans3_batch(s4, b.n, tabs3, b.L,
                                                 emax=b.emax), reps=4)
    log(f"srans3: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f}, "
        f"lossless={ok}, host-parity={parity}")
    rate = b.rates("srans3", t_enc, t_dec)
    b.extra.update(
        srans3_ratio=round(ratio, 4),
        srans3_lossless=ok,
        srans3_host_parity=parity,
        srans3_vs_rc01s_throughput=round(rate / BASELINE_RC01S_ENC_DEC_GBPS,
                                         1),
    )


# ---- 8. held-out ratio protocol (canned-table disclosure) ----
def sec_heldout(b: Bench):
    from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
    from honours_tpu_torch.engine.pipeline import (
        depress_srans2_batch,
        press_srans2_batch,
    )
    from honours_tpu_torch.tables.o1 import heldout_o1_freqs

    ho_tabs = make_o1_tables(heldout_o1_freqs(), b.dev)
    s_ho, l_ho = press_srans2_batch(b.sig, b.n, ho_tabs, b.emax)
    d_ho = depress_srans2_batch(s_ho, b.n, ho_tabs, b.L, emax=b.emax)
    ho_ok = bool(torch.equal(d_ho, b.sig))
    heldout_ratio = b.ratio("heldout", l_ho)
    log(f"held-out: srans2 {heldout_ratio:.4f} (in-sample "
        f"{b.state.get('srans2_ratio', 0):.4f}, vbz on same data "
        f"{b.state.get('vbz_ratio', 0):.4f}), lossless={ho_ok}")
    b.extra.update(
        heldout_ratio_srans2=round(heldout_ratio, 4),
        heldout_lossless=ho_ok,
        heldout_protocol="o1 table trained on read 0 only; scored "
        "chunks all come from reads 1-2 (drans needs no such split)",
    )


# ---- 9. synthetic transfer corpus (>=100 MB unseen) ----
def sec_synth(b: Bench):
    from honours_tpu_torch.engine.drans import (
        depress_drans_batch,
        press_drans_batch,
    )
    from honours_tpu_torch.engine.pipeline import (
        depress_srans2_batch,
        press_srans2_batch,
    )
    from honours_tpu_torch.engine.svb16 import svb16_encode_batch
    from honours_tpu_torch.synth import synthesize_corpus

    try:
        import zstandard

        # a compressor of its own: this section does not depend on the
        # vbz_ratio section having run
        cctx = zstandard.ZstdCompressor(level=1)
    except ImportError as e:
        cctx = None
        b.extra["synth_vbz_ratio_missing"] = f"{type(e).__name__}: {e}"
    tabs = b.o1_tabs()
    # at least 3 batches (100.7 MB at [256, 65536]), up to 30 (1.01 GB),
    # of unseen synthetic signal, with per-batch ratio dispersion
    max_batches = int(os.environ.get("HTPU_SYNTH_BATCHES", "30"))
    batch_raw = b.B * b.L * 2
    synth_comp = synth_vbz = synth_drans = 0
    r_srans2, r_drans, r_vbz = [], [], []
    bi = 0
    t_start = time.time()
    while bi < max_batches:
        # reserve the dstall_drans section that runs after this one, one
        # more batch and the JSON epilogue
        if bi >= 3 and b.budget_left() < (
            1.5 * (time.time() - t_start) / bi + SYNTH_RESERVE_S
        ):
            break
        sb = synthesize_corpus(b.B * b.L, seed=100 + bi).reshape(b.B, b.L)
        sbj = torch.from_numpy(sb).to(b.dev)
        s_s, l_s = press_srans2_batch(sbj, b.n, tabs, b.emax)
        d_s = depress_srans2_batch(s_s, b.n, tabs, b.L, emax=b.emax)
        assert bool(torch.equal(d_s, sbj)), "synthetic round trip failed"
        c = int(l_s.sum())
        synth_comp += c
        r_srans2.append(batch_raw / c)
        b.lengths.setdefault("synth_srans2", []).append(c)
        s_d, l_d = press_drans_batch(sbj, b.n, tabs, b.emax)
        d_d = depress_drans_batch(s_d, b.n, tabs, b.L, emax=b.emax)
        assert bool(torch.equal(d_d, sbj)), "synthetic drans failed"
        c = int(l_d.sum())
        synth_drans += c
        r_drans.append(batch_raw / c)
        b.lengths.setdefault("synth_drans", []).append(c)
        if cctx is not None:
            st_s, ol_s = svb16_encode_batch(sbj, b.n, zd=True)
            c = vbz_bytes(cctx, st_s, ol_s, b.B)
            synth_vbz += c
            r_vbz.append(batch_raw / c)
            b.lengths.setdefault("synth_vbz", []).append(c)
        bi += 1
    synth_raw = bi * batch_raw

    def disp(rs):
        a = np.asarray(rs)
        return dict(mean=round(float(a.mean()), 4),
                    std=round(float(a.std()), 4),
                    min=round(float(a.min()), 4),
                    max=round(float(a.max()), 4))

    vbz = f"{synth_raw / synth_vbz:.4f}" if r_vbz else "missing"
    log(f"synthetic ({synth_raw / 1e6:.0f} MB, {bi} batches): srans2 "
        f"{synth_raw / synth_comp:.4f}, drans "
        f"{synth_raw / synth_drans:.4f}, vbz {vbz}"
        f" (per-batch drans spread {disp(r_drans)})")
    b.extra.update(
        synth_raw_bytes=synth_raw,
        synth_batches=bi,
        synth_srans2_ratio=round(synth_raw / synth_comp, 4),
        synth_drans_ratio=round(synth_raw / synth_drans, 4),
        synth_srans2_dispersion=disp(r_srans2),
        synth_drans_dispersion=disp(r_drans),
    )
    if r_vbz:
        b.extra.update(synth_vbz_ratio=round(synth_raw / synth_vbz, 4),
                       synth_vbz_dispersion=disp(r_vbz))


# ---- 10. dstall_drans (stall-aware self-contained flagship) ----
def sec_dstall_drans(b: Bench):
    from honours_tpu_torch.engine.dstall_drans import (
        depress_dstall_drans_batch,
        press_dstall_drans_batch,
    )
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    tabs = b.o1_tabs()
    s6, l6 = press_dstall_drans_batch(b.sig, b.n, tabs, b.emax)
    d6 = depress_dstall_drans_batch(s6, b.n, tabs, b.L, emax=b.emax)
    ok = bool(torch.equal(d6, b.sig))
    # ratio and parity on the unique-chunk batch (as sec_drans)
    sj, nj = b.unique_batch()
    se, le = press_dstall_drans_batch(sj, nj, tabs, b.emax)
    parity = rows(se, le, b.n_unique) == cpu_rows(
        press_dstall_drans_batch, canned_o1_device_tables, sj, nj,
        b.emax)[: b.n_unique]
    du = depress_dstall_drans_batch(se, nj, tabs, b.L, emax=b.emax)
    ok = ok and bool(torch.equal(du, sj))
    ratio = b.ratio("dstall_drans", le)
    t_enc = b.timed(lambda: press_dstall_drans_batch(b.sig, b.n, tabs,
                                                     b.emax), reps=2)
    t_dec = b.timed(lambda: depress_dstall_drans_batch(
        s6, b.n, tabs, b.L, emax=b.emax), reps=2)
    log(f"dstall_drans: {rates_text(b, t_enc, t_dec)}, ratio {ratio:.4f} "
        f"(self-contained, stall-aware), lossless={ok}, "
        f"host-parity={parity}")
    b.rates("dstall_drans", t_enc, t_dec)
    b.extra.update(
        dstall_drans_ratio=round(ratio, 4),
        dstall_drans_lossless=ok,
        dstall_drans_host_parity=parity,
        dstall_drans_protocol="reference dstall-fz min-pick over "
        "self-contained drans branches; measured: the pick chooses "
        "plain on real signal (split never earns back its framing "
        "under a globally fitted model), so ratio tracks drans "
        "minus 5 bytes/read",
    )


def plan():
    """(name, seconds of budget a section needs to start, section), in
    run order: every engine codec reports before the optional evidence
    sections.  The gates are about 3x each section's wall in a default
    run on an H100 80GB HBM3 (700 W), at least 10 s; svb16's holds the
    kernels' build (nvcc, at first use), synthetic's its first 3 batches
    and the reserve."""
    return [
        ("svb16", 35, sec_svb16),
        ("vbz_ratio", 10, sec_vbz),
        ("srans2", 10, sec_srans2),
        ("drans", 10, sec_drans),
        ("srans", 10, sec_srans),
        ("srans3", 10, sec_srans3),
        ("dstall", 10, sec_dstall),
        ("heldout", 10, sec_heldout),
        ("synthetic", 45, sec_synth),
        ("dstall_drans", 30, sec_dstall_drans),
    ]


def section(b: Bench, name: str, min_budget_s: float, fn) -> None:
    """Run one bench section; record a skip reason instead of dying."""
    if b.budget_left() < min_budget_s:
        b.skipped.append({"section": name, "reason": "budget"})
        log(f"skipping {name} (budget: {b.budget_left():.0f}s left, "
            f"needs ~{min_budget_s}s)")
        return
    log(f"[{name}] (budget left {b.budget_left():.0f}s)")
    try:
        fn(b)
    except BenchTimeout:
        raise
    except Exception as e:  # noqa: BLE001 — record and continue
        b.skipped.append({"section": name,
                          "reason": f"{type(e).__name__}: {e}"[:200]})
        log(f"section {name} FAILED:")
        traceback.print_exc()


def run(b: Bench) -> dict:
    """Every section of the plan in order -> the JSON line's object."""
    sections = plan()
    for i, (name, gate, fn) in enumerate(sections):
        try:
            section(b, name, gate, fn)
        except BenchTimeout:
            # the alarm fired inside this section: ledger it AND every
            # unreached section, then stop
            b.skipped.append({"section": name, "reason": "wall-clock alarm"})
            for rest, _, _ in sections[i + 1:]:
                b.skipped.append({"section": rest, "reason": "after alarm"})
            break
    b.extra.update(
        ref_vbz_ratio=2.9284,
        ref_rc01s_ratio=2.9913,
        ref_dstall_ratio=2.9917,
        batch=[b.B, b.L],
        corpus_unique_bytes=b.unique_bytes,
        ratio_basis="unique fixture chunks only",
        card=b.card,
        skipped=b.skipped,
    )
    return line(b.state.get("gbps", 0.0), b.extra)


def line(value: float, extra: dict) -> dict:
    return {"metric": METRIC, "value": round(value, 4), "unit": "GB/s",
            "vs_baseline": round(value / BASELINE_VBZ_ENC_DEC_GBPS, 2),
            "extra": extra}


def sentinel(b: Bench, e: BaseException) -> dict:
    """The line of a run that failed outside its sections (or whose alarm
    fired there): the error, the skip ledger, and the headline salvaged
    from the svb16 section if it completed."""
    kind = ("timeout: wall-clock budget" if isinstance(e, BenchTimeout)
            else f"{type(e).__name__}: {e}")
    b.extra.update(error=kind[:500], skipped=b.skipped)
    g = 0.0
    e_, d_ = b.extra.get("svb16_enc_GBps", 0), b.extra.get("svb16_dec_GBps", 0)
    if e_ > 0 and d_ > 0:
        g = 2 / (1 / e_ + 1 / d_)
    return line(g, b.extra)


def main(argv=None) -> Bench:
    """Run the bench and print its JSON line; returns the run.  A failure
    outside the sections prints the sentinel line and ends the process
    (os._exit: 0 after the wall-clock alarm, else 1), so a wedged call
    cannot hold the line back."""
    ap = argparse.ArgumentParser(prog="honours_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=B,
                    help="rows of the tiled batch (a smaller run for a "
                    "quick check; the recorded numbers use the default)")
    ap.add_argument("--width", type=int, default=L,
                    help="samples a row (the same)")
    args = ap.parse_args(argv)
    b = Bench()
    alarm = threading.current_thread() is threading.main_thread()
    if alarm:
        handler = signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(max(int(b.budget_s), 1))
    try:
        b.load(args.device, args.batch, args.width)
        log(f"device: {b.dev} ({b.card})")
        print(json.dumps(run(b)), flush=True)
        return b
    except BaseException as e:  # noqa: BLE001 — the JSON line must emit
        log("bench failed — emitting sentinel:", repr(e))
        traceback.print_exc()
        print(json.dumps(sentinel(b, e)), flush=True)
        sys.stderr.flush()
        os._exit(0 if isinstance(e, BenchTimeout) else 1)
    finally:
        if alarm:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, handler)
