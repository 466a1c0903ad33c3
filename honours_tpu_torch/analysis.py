"""Signal analysis toolkit on the card: the port of honours_tpu/analysis.py.

The statistics that motivated the codec designs (the reference's offline
viz/ corpus, viz/README:1-80): value and delta frequency tallies,
empirical entropy, exception rates, the quantisation shift, flat runs,
stall segmentation reports and per-read summaries.  Every function
computes with torch on `device` (CUDA unless the caller passes "cpu"; no
CUDA raises) and returns the JAX module's keys with its Python types
(int, float, bool, list).  Integers are exact; float statistics are
float64 and agree with the numpy ones to rounding (sums in another
order).  The per-read summaries are masked reductions over a bucket of
reads at a time (io/batching.py), entropies from one sort of (read,
value) keys, the stall report from the batched segmenter (kernel A on
the card), start and length as the C segmenter gives them (uint16,
native/segment.c).

Usage:
  python -m honours_tpu_torch analyze FILE.blow5 [--per-read]
      [--device cuda|cpu]
  or library: honours_tpu_torch.analysis.analyze_reads(signals)
"""

from __future__ import annotations

import numpy as np
import torch

from honours_tpu_torch.device import resolve_device
from honours_tpu_torch.io.batching import bucket_reads, restore_order
from honours_tpu_torch.synth import synthesize_corpus  # noqa: F401
from honours_tpu_torch.transforms.core import find_qts, zigdelta


def _tensor(values, device) -> torch.Tensor:
    """values (a tensor, an array or a sequence) as a 1-D tensor on the
    resolved device; unsigned arrays are widened to int64 first."""
    dev = resolve_device(device)
    if not isinstance(values, torch.Tensor):
        a = np.asarray(values)
        if a.dtype.kind == "u":
            a = a.astype(np.int64)
        values = torch.from_numpy(np.ascontiguousarray(a))
    return values.reshape(-1).to(dev)


class Welford:
    """Streaming min/max/mean/var/sd (press/stats.c:62-88 update_stats):
    one pass over chunks of samples, each chunk reduced on `device`."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = np.inf
        self.max = -np.inf

    def update(self, values) -> "Welford":
        v = _tensor(values, self.device).to(torch.float64)
        if v.numel() == 0:
            return self
        n2 = v.numel()
        mean2 = float(v.mean())
        m22 = float(((v - mean2) ** 2).sum())
        delta = mean2 - self.mean
        n = self.n + n2
        self.mean += delta * n2 / n
        self.m2 += m22 + delta * delta * self.n * n2 / n
        self.n = n
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        return self

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    @property
    def sd(self) -> float:
        return float(np.sqrt(self.var))


def freq_tally(values, minlength=0, device="cuda") -> torch.Tensor:
    """Value frequency tally (viz/freq_slow5.c / tally.c role); int16
    values are counted by their uint16 bits."""
    v = _tensor(values, device)
    v = v.to(torch.int32) & 0xFFFF if v.dtype == torch.int16 else v.long()
    return torch.bincount(v, minlength=minlength)


def _entropy(counts: torch.Tensor) -> float:
    counts = counts[counts > 0].to(torch.float64)
    p = counts / counts.sum()
    return float(-(p * torch.log2(p)).sum())


def entropy_bits(values, device="cuda") -> float:
    """Empirical order-0 entropy in bits/sample (viz entropy tools;
    reference baseline: raw 7.700, zd 5.391 — thesis entropy-tab)."""
    return _entropy(freq_tally(values, device=device))


#: read_summary's keys, in the JAX report's order; the ints among them
SUMMARY_KEYS = ("n", "min", "max", "mean", "sd", "raw_entropy_bits", "qts",
                "delta_mean", "delta_std", "delta_entropy_bits",
                "exception_rate", "max_abs_delta",
                "stall", "stall_start", "stall_len")
_INTS = {"n", "min", "max", "qts", "max_abs_delta", "stall_start",
         "stall_len"}
_DELTA_KEYS = SUMMARY_KEYS[7:12]
_STALL_KEYS = SUMMARY_KEYS[12:]

#: samples a bucket of reads holds at most (bounds the int64 temporaries)
_CHUNK = 1 << 23


def _row_entropy(vals, valid, n, corpus):
    """Order-0 entropy of each row's valid uint16 values [B, L] -> [B]
    float64, from one sort of (row, value) keys; the tally is also added
    into the corpus tally `corpus` [65536]."""
    B = vals.shape[0]
    row = torch.arange(B, device=vals.device)[:, None]
    keys, c = torch.unique(((row << 16) | vals)[valid], return_counts=True)
    r = keys >> 16
    corpus.index_add_(0, keys & 0xFFFF, c)
    p = c.to(torch.float64) / n[r].to(torch.float64)
    h = torch.zeros(B, dtype=torch.float64, device=vals.device)
    return -h.index_add_(0, r, p * torch.log2(p))


def _bucket_summary(sig, n, corpus_raw, corpus_zd, stall):
    """read_summary's values for every row of [B, L] int16 sig (first n
    valid) as masked reductions -> [len(SUMMARY_KEYS), B] float64 (exact
    for the integers), without the stall rows when `stall` is false."""
    from honours_tpu_torch.segment import find_stall_batch

    L = sig.shape[1]
    n = n.to(torch.int64)
    pos = torch.arange(L, device=sig.device)
    valid = pos[None, :] < n[:, None]
    dvalid = pos[None, 1:] < n[:, None]  # d[i] = x[i+1] - x[i]
    n1 = n.clamp(min=1).to(torch.float64)
    nd1 = (n - 1).clamp(min=1).to(torch.float64)
    x = sig.to(torch.int64)
    mean = torch.where(valid, x, 0).sum(1) / n1
    sd = (torch.where(valid, (x - mean[:, None]) ** 2, 0.0).sum(1)
          / n1).sqrt()
    d = torch.diff(x, dim=1)
    dmean = torch.where(dvalid, d, 0).sum(1) / nd1
    dstd = (torch.where(dvalid, (d - dmean[:, None]) ** 2, 0.0).sum(1)
            / nd1).sqrt()
    zd = zigdelta(sig).to(torch.int64)
    rows = [
        n, torch.where(valid, x, 1 << 16).amin(1),
        torch.where(valid, x, -(1 << 16)).amax(1), mean, sd,
        _row_entropy(x & 0xFFFF, valid, n, corpus_raw), find_qts(sig, n),
        dmean, dstd, _row_entropy(zd, valid, n, corpus_zd),
        (dvalid & (zd[:, 1:] > 255)).sum(1),
        torch.where(dvalid, d.abs(), 0).amax(1),
    ]
    if stall:
        ex, start, length = find_stall_batch(sig, n)
        rows += [ex, start.to(torch.int64) & 0xFFFF,
                 length.to(torch.int64) & 0xFFFF]
    return torch.stack([r.to(torch.float64) for r in rows])


def _summary_dict(keys, values) -> dict:
    """A read's summary with the JAX report's Python types; n = 0 and 1
    take the JAX defaults (qts 0, no deltas)."""
    out = {k: (int(v) if k in _INTS else bool(v) if k == "stall" else v)
           for k, v in zip(keys, values)}
    n = out["n"]
    if n == 0:
        out.update(min=0, max=0, qts=0)
    out["exception_rate"] = (int(out["exception_rate"]) / (n - 1)
                             if n > 1 else 0.0)
    return out


def _summaries(host, dev, stall=True):
    """(read_summary of every read, corpus raw tally, corpus zd tally):
    a bucket of reads (io/batching.py) at a time, cut to at most _CHUNK
    samples, each part's statistics brought back in one transfer."""
    corpus_raw = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    corpus_zd = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    keys = SUMMARY_KEYS if stall else SUMMARY_KEYS[:12]
    buckets = bucket_reads(host)
    outs = []
    for b in buckets:
        step = max(1, _CHUNK // b.L)
        rows = []
        for lo in range(0, b.n.size, step):
            part = _bucket_summary(
                torch.from_numpy(b.sig[lo: lo + step]).to(dev),
                torch.from_numpy(b.n[lo: lo + step]).to(dev), corpus_raw,
                corpus_zd, stall)
            rows += [_summary_dict(keys, c) for c in part.T.tolist()]
        outs.append(rows)
    return restore_order(buckets, outs), corpus_raw, corpus_zd


def _host_reads(signals) -> list[np.ndarray]:
    return [s.cpu().numpy() if isinstance(s, torch.Tensor) else
            np.asarray(s, np.int16) for s in signals]


def _summary(signal, device, stall=True) -> dict:
    (rep,), _, _ = _summaries(_host_reads([signal]), resolve_device(device),
                              stall)
    return rep


def delta_stats(signal, device="cuda") -> dict:
    rep = _summary(signal, device, stall=False)
    return {k: rep[k] for k in _DELTA_KEYS}


def stall_report(signal, device="cuda") -> dict:
    """The segmenter's first stall (kernel A on the card), start and
    length as uint16 as the C segmenter reports them."""
    rep = _summary(signal, device)
    return {k: rep[k] for k in _STALL_KEYS}


def read_summary(signal, device="cuda") -> dict:
    return _summary(signal, device)


def analyze_reads(signals, device="cuda") -> dict:
    """Corpus-level report: per-read summaries + aggregate statistics,
    computed a bucket of reads at a time; the corpus tallies are the
    sums of the buckets'."""
    dev = resolve_device(device)
    host = _host_reads(signals)
    reads, corpus_raw, corpus_zd = _summaries(host, dev)
    agg = {
        "n_reads": len(host),
        "total_samples": int(sum(s.size for s in host)),
        "corpus_raw_entropy_bits": _entropy(corpus_raw),
        "corpus_zd_entropy_bits": _entropy(corpus_zd),
    }
    return {"aggregate": agg, "reads": reads}


def conditional_entropy_bits(values, device="cuda") -> float:
    """Order-1 conditional entropy H(x_t | x_{t-1}) in bits/sample over
    byte-valued data (the statistic that motivates the order-1 srans2
    table; viz entropy-tools role): one bincount over (prev << 8 | cur)."""
    v = _tensor(values, device).long()
    if v.numel() < 2:
        return 0.0
    pair = ((v[:-1] & 255) << 8) | (v[1:] & 255)
    J = torch.bincount(pair, minlength=65536).reshape(256, 256)
    J = J.to(torch.float64)
    rows = J.sum(dim=1)
    nz = rows > 0
    P = J[nz] / rows[nz, None]
    h = -torch.where(P > 0, P * torch.log2(P), 0.0).sum(dim=1)
    w = rows[nz] / rows.sum()
    return float((w * h).sum())


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative value below 2^17, counted exactly:
    ceil(log2(v + 1))."""
    return sum(((v >> k) > 0).long() for k in range(17))


def exception_report(signal, device="cuda") -> dict:
    """Exception (zd > 255) positions/gaps/values statistics — the
    analysis behind the vb container designs (viz ex-tools role,
    press/press.c:2767-2773 framing decisions)."""
    zd = zigdelta(_tensor(signal, device).to(torch.int16))[1:]
    pos = torch.nonzero(zd > 255).flatten()
    gaps = torch.diff(pos)
    vals = zd[pos].long() - 256
    return {
        "nex": int(pos.numel()),
        "ex_rate": pos.numel() / max(zd.numel(), 1),
        "ex_gap_mean": (float(gaps.to(torch.float64).mean())
                        if gaps.numel() else 0.0),
        "ex_gap_max": int(gaps.max()) if gaps.numel() else 0,
        "ex_val_bits_mean": (float(_bit_length(vals).to(torch.float64)
                                   .mean()) if vals.numel() else 0.0),
        "ex_val_max": int(vals.max()) if vals.numel() else 0,
    }


def run_length_report(signal, tol: int = 0, device="cuda") -> dict:
    """Flat-run statistics (|delta| <= tol) — the analysis behind the
    flats partitioner and stall codecs (viz flats/stall role)."""
    x = _tensor(signal, device).long()
    if x.numel() < 2:
        return {"n_runs": 0, "run_mean": 0.0, "run_max": 0}
    flat = torch.diff(x).abs() <= tol
    edges = torch.diff(flat.to(torch.int8))
    starts = torch.nonzero(edges == 1).flatten()
    ends = torch.nonzero(edges == -1).flatten()
    head, tail = flat[[0, -1]].tolist()
    if head:
        starts = torch.cat([starts.new_tensor([-1]), starts])
    if tail:
        ends = torch.cat([ends, ends.new_tensor([flat.numel() - 1])])
    lens = ends - starts
    return {
        "n_runs": int(lens.numel()),
        "run_mean": (float(lens.to(torch.float64).mean())
                     if lens.numel() else 0.0),
        "run_max": int(lens.max()) if lens.numel() else 0,
    }


def value_histogram(values, bucket: int = 16, device="cuda") -> dict:
    """Bucketed value histogram (viz hist/sigstat role)."""
    v = _tensor(values, device).long()
    if v.numel() == 0:
        return {"bucket": bucket, "lo": 0, "counts": []}
    lo = int(v.min()) // bucket * bucket
    idx = torch.div(v - lo, bucket, rounding_mode="floor")
    return {"bucket": bucket, "lo": lo,
            "counts": torch.bincount(idx).tolist()}


def method_size_table(signals, methods, device="cuda") -> dict:
    """Compressed-size comparison table over ported codecs (the one-off
    per-method analyses the viz shell scripts drive).  Each read is
    pressed alone (engine.runner.press_read), as the JAX table presses
    each read through the host codec, so the sizes are the host codec's;
    a name the port does not run raises NotImplementedError."""
    from honours_tpu_torch.engine.runner import engine_kind, press_read

    dev = resolve_device(device)
    host = _host_reads(signals)
    raw = sum(int(s.size) * 2 for s in host)
    out = {"raw_bytes": raw, "methods": {}}
    for m in methods:
        engine_kind(m)
        size = sum(len(press_read(s, m, device=dev)) for s in host)
        out["methods"][m] = {
            "bytes": size,
            "ratio": round(raw / size, 6) if size else 0.0,
        }
    return out
