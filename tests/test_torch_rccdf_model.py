"""Kernels F and G's arithmetic (csrc/rccdf.cu), checked on the CPU.

F: a numpy model of its per-symbol reciprocal (ryg's rcp_freq with s =
ceil(log2 f), the shift s - 1, and x itself through a mask for f = 1)
gives x // f for every f in [1, 4096] at x = 0, at the largest state the
encode divides (f << 19) - 1, at multiples k f and k f - 1 near the ends
and the middle of that range and at seeded random x, and the step's
multiply-add gives the state of the plain version (engine/rccdf.py
rccdf_encode_plain).

G: a model of its lane walk (decode_model: the slot table built 16 slots
a thread, 32-bit states, one slot lookup a step, the two refill bytes a
step loaded from a ring of the lane's stream that is refilled every RS
steps and whose copy lands RS steps later; the source's constants) gives
the plain version's bytes (rccdf_decode_plain) and, on valid streams,
the JAX package's host decode (honours_tpu/kernels/rans.py
rans_decode_static, numpy), exactly; every state stays below 2^32 and
every ring byte a step loads holds the stream byte it should, no copy in
flight into it.  Rows: encoded residual-like and random rows, a
one-symbol table, states of 0xFFFFFFFF over random bytes, tables with f
= 0 past their sum (and f != 0 there), tables summing past 4096,
truncated rows, odd body offsets, every row address mod 16, count 0 and
counts short of and past the lanes' bytes.  No JAX is imported (the
host coder is numpy)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from honours_tpu.kernels.rans import rans_decode_static
from honours_tpu_torch.engine import rans_encode_cuda as E
from honours_tpu_torch.engine import rccdf as R
from honours_tpu_torch.engine.rccdf import RENORM_SHIFT
from honours_tpu_torch.kernels.rans import M, PROB_BITS
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

F = np.arange(1, M + 1, dtype=np.uint64)[:, None]


def symbol_entries(f):
    """symbol_entry's (reciprocal, shift, mask) of f (uint64 in [1, M])."""
    s = np.array([(int(v) - 1).bit_length() for v in f.ravel()],
                 np.uint64).reshape(f.shape)
    rcp = np.where(f < 2, 0, ((np.uint64(1) << (np.uint64(31) + s)) + f
                              - np.uint64(1)) // f)
    shift = (s.astype(np.int64) - 1) & 31
    mask = np.where(f == 1, np.uint64(0xFFFFFFFF), np.uint64(0))
    return rcp.astype(np.uint64), shift.astype(np.uint64), mask


def quotient(x, f):
    """encode_step's q: (umulhi(x, rcp) >> shift) | (x & mask)."""
    rcp, shift, mask = symbol_entries(f)
    return (((x * rcp) >> np.uint64(32)) >> shift) | (x & mask)


def _states(seed: int):
    """[M, X] states below f << 19 for each f: 0, 1, the largest, k f and
    k f - 1 for k near 1, near 2^18 and near 2^19, and seeded random
    ones."""
    top = F << np.uint64(RENORM_SHIFT)
    k = np.array([1, 2, 3, (1 << 18) - 1, 1 << 18, (1 << 18) + 1,
                  (1 << 19) - 2, (1 << 19) - 1], np.uint64)[None, :]
    rng = np.random.default_rng(seed)
    rand = (rng.random((M, 64)) * top).astype(np.uint64)
    x = np.concatenate([np.zeros_like(F), np.ones_like(F), top - 1, k * F,
                        k * F - np.uint64(1), rand], axis=1)
    return np.minimum(x, top - np.uint64(1))


def test_reciprocal_division_is_exact_for_every_f():
    x = _states(0)
    f = np.broadcast_to(F, x.shape)
    assert (x < np.uint64(1 << 31)).all()
    assert np.array_equal(quotient(x, f), x // f)


def test_reciprocals_are_kernel_3s():
    """The same table as kernel 3's (rans_encode_cuda.reciprocals)."""
    rcp, _, _ = symbol_entries(F)
    assert np.array_equal(rcp[:, 0], E.reciprocals()[1: M + 1])


def test_step_gives_the_plain_state():
    """x + q (4096 - f) + c = (x // f << 12) + x % f + c for a valid
    table (f + c <= 4096), and stays below 2^31; the idle entry (f =
    4096, c = 0) leaves x as it is."""
    x = _states(1)
    f = np.broadcast_to(F, x.shape)
    rng = np.random.default_rng(2)
    c = (rng.random(x.shape) * (np.uint64(M) - f + np.uint64(1))).astype(
        np.uint64)
    got = x + quotient(x, f) * (np.uint64(M) - f) + c
    want = ((x // f) << np.uint64(PROB_BITS)) + x % f + c
    assert np.array_equal(got, want) and (got < np.uint64(1 << 31)).all()
    idle = np.full_like(x, M)
    assert np.array_equal(x + quotient(x, idle) * np.uint64(0), x)


# ---------------------------------------------------------------------------
# kernel G: a model of the lane walk
# ---------------------------------------------------------------------------

SOURCE = (Path(__file__).resolve().parent.parent / "honours_tpu_torch"
          / "csrc" / "rccdf.cu").read_text()


def _const(name: str) -> int:
    m = re.search(r"constexpr int " + name + r" = ([^;]+);", SOURCE)
    return int(eval(m.group(1), {"K": 16}))  # noqa: S307 (the source's own)


RS, LRING, TT = _const("RS"), _const("LRING"), _const("TT")
K, HEAD, U32 = 16, 128, (1 << 32) - 1


def slot_table(freqs):
    """The kernel's slot table of freqs [256] (each in [0, 4096]): thread
    t's slots 16 t .. 16 t + 15, the first by a binary search for the
    first symbol whose high end passes it, the rest by a walk over the
    high ends (255 past the sum); each slot's (symbol, f, slot - lo)."""
    f = [int(v) for v in freqs]
    hi = np.cumsum(f).tolist()
    lo = [h - v for h, v in zip(hi, f)]
    sym, ef, bias = [0] * M, [0] * M, [0] * M
    for t in range(256):
        slot0 = 16 * t
        a, z = 0, 256
        while a < z:
            mid = (a + z) >> 1
            if hi[mid] > slot0:
                z = mid
            else:
                a = mid + 1
        s = min(a, 255)
        for slot in range(slot0, slot0 + 16):
            while s < 255 and hi[s] <= slot:
                s += 1
            sym[slot], ef[slot], bias[slot] = s, f[s], slot - lo[s]
            assert 0 <= bias[slot] < M
    return sym, ef, bias


class Ring:
    """A lane's ring of LRING bytes over its stream blocks (offsets from
    its 16-byte aligned base a0): a fill lands at the next refill, RS
    steps after it was started; a byte read must hold the stream byte it
    is read for."""

    def __init__(self, row, a0):
        self.row, self.a0 = row, a0
        self.held = [None] * LRING  # the offset each ring byte holds
        self.data = bytearray(LRING)
        self.pending = None

    def start(self, lo, hi):
        assert self.pending is None
        self.pending = (lo, hi)

    def land(self):
        if self.pending:
            lo, hi = self.pending
            for o in range(lo, hi):
                p = self.a0 + o
                self.data[o % LRING] = (int(self.row[p])
                                        if 0 <= p < self.row.size else 0)
                self.held[o % LRING] = o
            self.pending = None

    def byte(self, o):
        """The byte at offset o."""
        assert self.held[o % LRING] == o, (o, self.held[o % LRING])
        if self.pending:  # no copy in flight into this byte
            lo, hi = self.pending
            assert (o - lo) % LRING >= hi - lo, (o, lo, hi)
        return self.data[o % LRING]


def decode_model(row, base: int, cnt: int, freqs, N: int, addr: int = 0,
                 stats=None):
    """Kernel G's walk of one row (u8 [M]), its body at byte base, cnt
    bytes (clamped to [0, N]) with freqs [256]; the row at an address
    addr mod 16.  -> [N] u8, zeros past cnt."""
    cnt = min(max(cnt, 0), N)
    sym, ef, bias = slot_table(freqs)

    def byte_at(p):
        return int(row[p]) if 0 <= p < row.size else 0

    def u32(p):
        return sum(byte_at(p + i) << (8 * i) for i in range(4))

    xs = [u32(base + 4 * i) for i in range(K)]
    lens = [u32(base + 4 * K + 4 * i) for i in range(K)]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).tolist()
    out = np.zeros(N, np.uint8)
    nst = -(-cnt // K)
    tiles = -(-nst // TT)
    for lane in range(K):
        p0 = base + HEAD + int(starts[lane])
        mis = (addr + p0) & 15
        a0 = p0 - mis
        ring = Ring(row, a0)
        if tiles:
            ring.start(0, LRING)
            ring.land()
        fetched = LRING
        x = xs[lane]
        rp = mis  # the read offset from a0
        for q in range(tiles):
            if q and q % (RS // TT) == 0:
                ring.land()
                to = (rp & ~15) + LRING
                ring.start(fetched, to)
                fetched = to
            for j in range(TT):
                # the step's two ring bytes, loaded whatever it takes
                b0, b1 = ring.byte(rp), ring.byte(rp + 1)
                i = (q * TT + j) * K + lane
                if i >= cnt:
                    continue
                slot = x & (M - 1)
                y = ef[slot] * (x >> PROB_BITS) + bias[slot]
                assert y <= U32
                k = int(y < (1 << 23)) + int(y < (1 << 15))
                x = (y << 16 | b0 << 8 | b1 if k == 2 else
                     y << 8 | b0 if k else y)
                assert x <= U32 and (k == 0 or x < 1 << 31)
                rp += k
                out[i] = sym[slot]
                if stats is not None:
                    stats["steps"] = stats.get("steps", 0) + 1
                    stats["refills"] = stats.get("refills", 0) + k
        if stats is not None:
            stats["ring_fills"] = stats.get("ring_fills", 0) + max(
                tiles - 1, 0) // (RS // TT)
    return out


def _plain(rows, bases, cnts, freqs, N):
    """rccdf_decode_plain on rows [B, M] -> [B, N] numpy."""
    t = torch.from_numpy
    return R.rccdf_decode_plain(
        t(np.ascontiguousarray(rows)), t(np.asarray(bases, np.int32)),
        t(np.asarray(cnts, np.int32)),
        t(np.asarray(freqs, np.int32).reshape(-1, 256)), N).numpy()


def _encode(data_rows, N):
    """The plain encode of byte rows (each a u8 array, at most N) -> (the
    body rows [B, 128 + 2N], their lengths, the tables [B, 256])."""
    data = np.zeros((len(data_rows), N), np.uint8)
    for i, r in enumerate(data_rows):
        data[i, : r.size] = r
    d = torch.from_numpy(data)
    n = torch.tensor([r.size for r in data_rows], dtype=torch.int32)
    freqs = R.fit_freqs_batch(R.byte_histogram(d, n)).to(torch.int32)
    body, blen = R.rccdf_encode_plain(d, n, freqs, R.cum_of(freqs).to(
        torch.int32))
    return body.numpy(), blen.numpy(), freqs.numpy()


def _rows(seed: int):
    rng = np.random.default_rng(seed)
    return [np.minimum(rng.geometric(p, m), 255).astype(np.uint8)
            for p, m in ((0.05, 3000), (0.3, 4096), (0.6, 17), (0.2, 1))] + [
        rng.integers(0, 256, 2000).astype(np.uint8),
        np.full(777, 42, np.uint8),  # one symbol: f = 4096
        np.zeros(0, np.uint8)]


def _check(rows, bases, cnts, freqs, N, addrs=(0,), stats=None):
    want = _plain(rows, bases, cnts, freqs, N)
    for addr in addrs:
        for i in range(len(rows)):
            got = decode_model(rows[i], int(bases[i]), int(cnts[i]),
                               freqs[i], N, addr, stats)
            assert np.array_equal(got, want[i]), (i, addr)
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_model_gives_encoded_rows_back(seed):
    """On valid streams: the model, the plain version and the host decode
    (rans_decode_static) give the rows back, at every row address mod 16
    (seed 0) and at odd body offsets (seed 1)."""
    data = _rows(seed)
    N = 4096
    body, blen, freqs = _encode(data, N)
    pad = np.arange(len(data)) * 3 + 1 if seed else np.zeros(len(data), int)
    rows = np.zeros((len(data), body.shape[1] + 64), np.uint8)
    for i in range(len(data)):
        rows[i, pad[i]: pad[i] + body.shape[1]] = body[i]
    cnts = [r.size for r in data]
    stats = {}
    want = _check(rows, pad, cnts, freqs, N,
                  addrs=range(16) if seed == 0 else (5,), stats=stats)
    assert stats["refills"] > 0 and stats["ring_fills"] > 0
    for i, r in enumerate(data):
        assert np.array_equal(want[i, : r.size], r)
        if r.size and (freqs[i] > 0).sum() > 0:
            host = rans_decode_static(
                rows[i, pad[i]: pad[i] + int(blen[i])].tobytes(), r.size,
                freqs[i].astype(np.int64))
            assert np.array_equal(host, r), i


def test_decode_model_long_row_many_ring_fills():
    """A residual-like row of 70,001 bytes (4,376 lane steps, 34 ring
    fills a lane), one of rare symbols, and random bytes under a table of
    zeros (every slot symbol 255 with f = 0, so x' < 2^12 and every step
    takes two bytes, the most a ring gives up between fills): model =
    plain (= the row where it was encoded), also at an odd address."""
    rng = np.random.default_rng(7)
    data = [np.minimum(rng.geometric(0.05, 70_001), 255).astype(np.uint8),
            np.where(rng.random(40_000) < 0.97, 7, rng.integers(
                0, 256, 40_000)).astype(np.uint8)]
    body, _, freqs = _encode(data, 70_001)
    rows = np.concatenate([body, rng.integers(0, 256, (1, body.shape[1]))
                           .astype(np.uint8)])
    freqs = np.concatenate([freqs, np.zeros((1, 256), freqs.dtype)])
    stats = {}
    want = _check(rows, [0, 0, 5], [r.size for r in data] + [40_000],
                  freqs, 70_001, addrs=(0, 7), stats=stats)
    for i, r in enumerate(data):
        assert np.array_equal(want[i, : r.size], r)
    assert stats["ring_fills"] >= 2 * 16 * (-(-70_001 // 16) // RS)


def _garbage(seed: int, B: int, W: int, states=None):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, W)).astype(np.uint8)
    if states is not None:
        rows[:, : 4 * K] = states
    return rows


ADVERSARIAL = ["top_states", "one_symbol", "f0_past_sum", "f_past_sum",
               "sum_past_4096", "truncated", "count_0_and_past"]


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_decode_model_on_adversarial_rows(case):
    """On rows the encode never writes, the model equals the plain
    version byte for byte and every state stays below 2^32: states of
    0xFFFFFFFF over random bytes, a one-symbol table (f = 4096), tables
    whose sum falls short of 4096 with f = 0 (and f != 0) for symbol
    255, tables summing past 4096, rows cut short of their lanes (bytes
    past the row read 0), and counts of 0, short of and past the lanes'
    bytes."""
    rng = np.random.default_rng(ADVERSARIAL.index(case))
    B, W, N = 4, 600, 700
    freqs = np.zeros((B, 256), np.int64)
    rows = _garbage(1, B, W)
    bases = rng.integers(0, 9, B)
    cnts = [N, 311, 17, 64]
    good = _encode(_rows(3)[:B], 4096)[2]
    if case == "top_states":
        rows = _garbage(2, B, W, states=0xFF)
        freqs[:] = good
    elif case == "one_symbol":
        freqs[np.arange(B), [0, 42, 255, 128]] = M
    elif case == "f0_past_sum":
        freqs[:, :200] = rng.integers(0, 20, (B, 200))
        freqs[:, 255] = 0
    elif case == "f_past_sum":
        freqs[:, :100] = rng.integers(0, 30, (B, 100))
        freqs[:, 255] = [1, 7, 4096, 300]
    elif case == "sum_past_4096":
        freqs[:] = rng.integers(0, 4097, (B, 256))
    elif case == "truncated":
        freqs[:] = good
        rows = rows[:, :90]  # the lanes' bytes mostly past the row
    else:
        freqs[:] = good
        cnts = [0, 0, N, N - 1]
        lens = rng.integers(0, 5, (B, K)).astype("<u4").view(np.uint8)
        for i in range(B):
            rows[i, bases[i] + 64: bases[i] + 128] = lens[i]
    assert (freqs >= 0).all() and (freqs <= M).all()
    _check(rows, bases, cnts, freqs, N, addrs=(0, 3, 13))
