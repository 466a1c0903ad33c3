"""The adaptive binary range coder of the rc, rcc and rccm codecs, as
batched plain PyTorch: the plain versions of kernels D and E
(csrc/rangecoder.cu, rangecoder_cuda.py).

The port's copy of honours_tpu/native/rangecoder.c, which the JAX
package runs on the host only: an LZMA-class binary range coder (32-bit
range, 64-bit low with a carry cache, 11-bit probabilities) under three
byte models, each byte eight binary decisions down a bit tree whose
context starts at 1 and takes each coded bit:
  o0  one adaptive probability a tree node (rc, ht_rc0_*), shift 5;
  o1  the same, a tree a previous byte (rcc, ht_rc1_*);
  cm  a logistic mix of order-0, order-1 (fast and slow) and order-2
      counters whose weight set the partial byte selects, refined by two
      APM stages (rccm, ht_rccm_*: cm_predict, cm_update).
Every row is one stream of its own; the functions here run a batch of
rows in lock step, a bit a loop pass over [k] tensors (k the rows still
coding: rows are sorted by length and leave the pass when their bytes
end), so they are slow and serve as the reference the kernels are held
to.

The C keeps one epoch-tagged order-2 table across calls; an epoch only
spares a clear.  A fresh cell reads as count 0, probability 2048, and
every write leaves count >= 1, so each row here has a table of its own
filled with cnt << 12 | p = 2048: the same probabilities.

Output: each row's stream is capped at n + n // 2 + slack bytes (slack
1024, as honours_tpu.native._encode sizes its buffer); a row whose
stream would pass its cap gets length -1 and an all-zero row, never a
truncated stream (rc_encode raises on it).
"""

from __future__ import annotations

import numpy as np
import torch

PROB_BITS = 11
PROB_INIT = 1 << (PROB_BITS - 1)
TOP = 1 << 24
M32 = 0xFFFFFFFF
MODELS = ("o0", "o1", "cm")
#: bytes a row's stream may take beyond n + n // 2 (native._encode's)
SLACK = 1024

# ---- the cm model's constants (rangecoder.c :268-291, :436-438) ----
APM_N = 33
#: count-adaptive rates (CRATE) and each input's cap (MAXR: o0, o1 5; the
#: slow o1 stays at 8; the order-2 counter 5)
CRATE = (1, 2, 2, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5)
#: per-row cells of the plain cm model's 16-bit tables: o0 [256], o1 and
#: the slow o1s [256][256], then the two APMs [256][33]
CM_O0, CM_O1, CM_O1S = 0, 256, 256 + 65536
CM_APM1 = CM_O1S + 65536
CM_APM2 = CM_APM1 + 256 * APM_N
CM_SMALL = CM_APM2 + 256 * APM_N
O2_CELLS = 1 << 24
W_CELLS = 2048 * 4
W_INIT = (1 << 16) // 4
#: the kernels' device state, uint16 cells a row (csrc/rangecoder.cu lays
#: it out alike): o1's [256][256]; cm's o1 and o1s [256][256] and o2
#: [2^16][256].  The rest of a model's state (o0, the APMs, the weights)
#: lives in the kernels' shared memory and is set there.
O1_CELLS = 65536
DEV_O1S = 65536
DEV_O2 = 2 * 65536
DEV_CM_CELLS = DEV_O2 + O2_CELLS
#: device bytes of one row's model state, by model (the kernels' scratch)
STATE_BYTES = {"o0": 0, "o1": 2 * O1_CELLS, "cm": 2 * DEV_CM_CELLS}


def squash_table() -> np.ndarray:
    """SQUASH[t + 4096] for t in [-4096, 4095]: round(4096 / (1 +
    exp(-t / 256))) clamped to [1, 4095], as init_tables builds it
    (float64; every value lies at least 1.7e-4 from a rounding edge)."""
    t = np.arange(-4096, 4096, dtype=np.float64)
    v = 4096.0 / (1.0 + np.exp(-t / 256.0))
    return np.clip(np.floor(v + 0.5), 1, 4095).astype(np.int16)


def stretch_table(squash: np.ndarray) -> np.ndarray:
    """STRETCH[p]: the least t in [-4096, 4095] with SQUASH[t] >= p (4095
    if none), STRETCH[0] = -4096."""
    j = np.searchsorted(squash.astype(np.int64), np.arange(4096),
                        side="left") - 4096
    out = np.minimum(j, 4095).astype(np.int16)
    out[0] = -4096
    return out


SQUASH = squash_table()
STRETCH = stretch_table(SQUASH)


def apm_row() -> np.ndarray:
    """An APM context's 33 initial cells: SQUASH((i - 16) * 256) << 2."""
    idx = np.minimum((np.arange(APM_N) - 16) * 256 + 4096, 8191)
    return (SQUASH[idx].astype(np.int64) << 2).astype(np.int16)


def cm_small_row() -> np.ndarray:
    """One row's initial o0, o1, o1s and APM cells (int16 holding the
    uint16 cells): counters count 0, probability 2048."""
    row = np.full(CM_SMALL, 2048, np.int16)
    row[CM_APM1:] = np.tile(apm_row(), 2 * 256)
    return row


def out_width(N: int, slack: int = SLACK) -> int:
    """Columns of the encoders' output for rows of up to N bytes."""
    return N + N // 2 + slack


# ---------------------------------------------------------------------------
# models: predict(ctx) -> the coder's probability of a 0 bit (11 bits),
# update(bit), next_byte(byte); rows are 0..k-1 of the sorted batch.  A
# step's arithmetic goes through lookup tables built from the C's
# formulas (one gather where the C takes several operations), so that a
# loop pass runs few tensor operations.
# ---------------------------------------------------------------------------


def _crate_next(bit: int, cell: np.ndarray, slow: bool) -> np.ndarray:
    """cm_update of one 16-bit counter cell (cnt << 12 | p) on `bit`:
    rate CRATE[cnt] (8 for the slow o1s), p moved toward the bit, count
    up to 15.  p stays <= 4095 (the C's clamp never binds: the rate is
    at least 1)."""
    cnt, p = cell >> 12, cell & 0xFFF
    r = np.full_like(cnt, 8) if slow else np.array(CRATE)[cnt]
    p = p + ((4096 - p) >> r) if bit else p - (p >> r)
    return (np.minimum(cnt + 1, 15) << 12) | np.minimum(p, 4095)


def _wrap16(x: np.ndarray) -> np.ndarray:
    """uint16 values as the int16 that holds them."""
    return (x.astype(np.int64) & 0xFFFF).astype(np.uint16).view(np.int16)


def _plain_tables() -> dict:
    """The plain versions' lookup tables (numpy), each a C formula over
    its whole domain."""
    cell = np.arange(65536, dtype=np.int64)
    sq = SQUASH.astype(np.int64)
    st = STRETCH.astype(np.int64)
    v = np.arange(4096)
    s = np.arange(8192)
    a = np.arange(16384, dtype=np.int64)
    p = np.arange(2048, dtype=np.int64)
    return {
        "st16": st[cell & 0xFFF],  # stretch of a counter cell
        # [class (o0/o1/o2, slow o1s)][bit][cell] -> the updated cell
        "next16": _wrap16(np.concatenate([
            _crate_next(b, cell, slow) for slow in (False, True)
            for b in (0, 1)])),
        "sq": sq,  # by mixed + 4096
        "ss": st[sq] + 4096,  # stretch(squash(mixed)) + 4096
        # APM interpolation weights by stretch + 4096 (its low 8 bits)
        "wt": np.stack([256 - (s & 255), s & 255], axis=1),
        "st2": st[np.clip(v, 1, 4095)] + 4096,
        "pc": np.clip((4096 - np.clip(v, 1, 4094)) >> 1, 1, 2046),
        # [bit][cell] -> the APM cell moved 1/128 toward 0 or 4095 << 2
        "apm": _wrap16(np.concatenate([a + ((0 - a) >> 7),
                                       a + ((16380 - a) >> 7)])),
        # o0/o1: [bit][p] -> p moved toward the bit by shift 5
        "adapt": np.concatenate([p + ((2048 - p) >> 5), p - (p >> 5)]),
    }


_TABLES: dict = {}


def plain_tables(dev) -> dict:
    """_plain_tables as tensors on `dev` (made once a device)."""
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                        for k, v in _plain_tables().items()}
    return _TABLES[key]


def _col(B: int, dev, fill: int = 0):
    """A [B, 1] int64 column: the per-row state of the loops below."""
    return torch.full((B, 1), fill, dtype=torch.int64, device=dev)


class _Adaptive:
    """o0 / o1: one 11-bit probability of a 0 a tree node, shift 5."""

    def __init__(self, B: int, dev, order1: bool):
        self.S = 65536 if order1 else 256
        self.order1 = order1
        self.t = torch.full((B * self.S,), PROB_INIT, dtype=torch.int64,
                            device=dev)
        self.adapt = plain_tables(dev)["adapt"]
        self.base = torch.arange(B, device=dev)[:, None] * self.S
        self.row = self.base

    def keep(self, k: int):
        self.base, self.row = self.base[:k], self.row[:k]

    def next_byte(self, byte):
        if self.order1:
            self.row = self.base + (byte << 8)

    def predict(self, ctx):
        self.idx = self.row + ctx
        self.p = self.t.take(self.idx)
        return self.p

    def update(self, bit):
        self.t.put_(self.idx, self.adapt.take(self.p + (bit << 11)))


class _Mix:
    """cm: rangecoder.c's cm_predict / cm_update over [k, 1] rows.  A
    row's 16-bit cells sit in one int16 table: the CM_SMALL cells (o0,
    o1, o1s, the APMs), then the order-2 table's 2^24."""

    ROW = CM_SMALL + O2_CELLS

    def __init__(self, B: int, dev):
        t = torch.full((B, self.ROW), 2048, dtype=torch.int16, device=dev)
        t[:, :CM_SMALL] = torch.from_numpy(cm_small_row()).to(dev)
        self.t = t.view(-1)
        self.w = torch.full((B * W_CELLS,), W_INIT, dtype=torch.int32,
                            device=dev)
        self.tab = plain_tables(dev)
        r = torch.arange(B, device=dev)[:, None]
        self.rt, self.rw = r * self.ROW, r * W_CELLS
        # each counter's update class (o0, o1, o1s slow, o2), and the
        # offsets of an APM cell pair
        self.cls = torch.tensor([[0, 0, 2 << 16, 0]], device=dev)
        self.two = torch.arange(2, device=dev)[None, :]
        self.four = torch.arange(4, device=dev)[None, :]
        self.prev1, self.prev2 = _col(B, dev), _col(B, dev)
        self._bases()

    def keep(self, k: int):
        for a in ("rt", "rw", "prev1", "prev2"):
            setattr(self, a, getattr(self, a)[:k])
        self._bases()

    def _bases(self):
        p1, rt = self.prev1, self.rt
        o1 = rt + (p1 << 8)
        self.base4 = torch.cat([rt + CM_O0, o1 + CM_O1, o1 + CM_O1S,
                                rt + CM_SMALL + (p1 << 16)
                                + (self.prev2 << 8)], dim=1)
        self.wbase = self.rw + (p1 >> 5) * 4 + self.four
        self.a1base = rt + CM_APM1 + self.two
        self.a2base = rt + CM_APM2 + p1 * APM_N + self.two

    def next_byte(self, byte):
        self.prev2, self.prev1 = self.prev1, byte
        self._bases()

    def predict(self, ctx):
        tab = self.tab
        self.i4 = self.base4 + ctx
        self.cells = self.t.take(self.i4).to(torch.int64) & 0xFFFF
        self.S = tab["st16"].take(self.cells)
        self.widx = self.wbase + (ctx << 5)
        self.W = self.w.take(self.widx)
        mixed = ((self.W * self.S).sum(dim=1, keepdim=True) >> 16).clamp_(
            -4095, 4095).add_(4096)
        self.pm = tab["sq"].take(mixed)
        s1 = tab["ss"].take(mixed)
        self.a1 = self.a1base + ctx * APM_N + (s1 >> 8)
        self.A1 = self.t.take(self.a1)
        pr = (self.pm + ((self.A1 * tab["wt"].index_select(0, s1.view(-1))
                          ).sum(dim=1, keepdim=True) >> 10)) >> 1
        s2 = tab["st2"].take(pr)
        self.a2 = self.a2base + (s2 >> 8)
        self.A2 = self.t.take(self.a2)
        pa2 = (self.A2 * tab["wt"].index_select(0, s2.view(-1))).sum(
            dim=1, keepdim=True) >> 10
        return tab["pc"].take((pr + pa2) >> 1)

    def update(self, bit):
        tab = self.tab
        self.t.put_(self.i4, tab["next16"].take(self.cells + (bit << 16)
                                                + self.cls))
        err = (bit << 12) - self.pm
        self.w.put_(self.widx, (self.W + ((self.S * err) >> 10)).to(
            torch.int32))  # int wrap, no clamp
        ab = bit << 14
        self.t.put_(self.a1, tab["apm"].take(self.A1 + ab))
        self.t.put_(self.a2, tab["apm"].take(self.A2 + ab))


def _model(model: str, B: int, dev):
    if model == "cm":
        return _Mix(B, dev)
    if model in ("o0", "o1"):
        return _Adaptive(B, dev, model == "o1")
    raise ValueError(f"model {model!r} not in {MODELS}")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


class _Enc:
    """The encoders' state over rows 0..k-1 ([k, 1] columns), and the
    shared output: out [B, W + 1] (column W takes writes past a row's
    width) and ff [B, W + 1], +1 / -1 at the ends of each run of 0xFF
    bytes a carry-free emission leaves (rangecoder.c enc_shift_low)."""

    def __init__(self, B: int, W: int, dev):
        self.W = W
        self.low, self.cache, self.pos = (_col(B, dev), _col(B, dev),
                                          _col(B, dev))
        self.rng = _col(B, dev, M32)
        self.size = _col(B, dev, 1)
        self.rowW = torch.arange(B, device=dev)[:, None] * (W + 1)
        self.out = torch.zeros(B * (W + 1), dtype=torch.uint8, device=dev)
        self.ff = torch.zeros(B * (W + 1), dtype=torch.int32, device=dev)

    def keep(self, k: int):
        for a in ("low", "cache", "pos", "rng", "size", "rowW"):
            setattr(self, a, getattr(self, a)[:k])

    def _at(self, rowW, p):
        return rowW + p.clamp(max=self.W)

    def shift_low(self, m, st=None):
        """enc_shift_low on the rows where m; `st` is a (low, cache,
        size, pos, rowW) subset, or None for all rows."""
        low, cache, size, pos, rowW = st or (self.low, self.cache, self.size,
                                            self.pos, self.rowW)
        carry = low >> 32
        emit = m & (((low & M32) < 0xFF000000) | (carry != 0))
        if bool(emit.any()):
            self.out.put_(torch.where(emit, self._at(rowW, pos), rowW + self.W),
                          ((cache + carry) & 0xFF).to(torch.uint8))
            run = (emit & (carry == 0) & (size > 1)).to(torch.int32)
            self.ff.put_(self._at(rowW, pos + 1), run, accumulate=True)
            self.ff.put_(self._at(rowW, pos + size), -run, accumulate=True)
            pos = torch.where(emit, pos + size, pos)
            size = torch.where(emit, 0, size)
            cache = torch.where(emit, (low >> 24) & 0xFF, cache)
        size = torch.where(m, size + 1, size)
        low = torch.where(m, (low & 0xFFFFFF) << 8, low)
        return low, cache, size, pos

    def bit(self, p, bit):
        bound = (self.rng >> PROB_BITS) * p
        self.low = self.low + bound * bit
        self.rng = torch.where(bit == 1, self.rng - bound, bound)
        for _ in range(2):  # range >= 2^13 after a bit: two shifts at most
            if self.rng.min().item() >= TOP:
                break
            m = self.rng < TOP
            self.low, self.cache, self.size, self.pos = self.shift_low(m)
            self.rng = torch.where(m, self.rng << 8, self.rng)

    def flush(self, lo: int, hi: int):
        """enc_flush of rows [lo, hi): five shifts; returns their
        lengths [hi - lo, 1]."""
        st = [t[lo:hi] for t in (self.low, self.cache, self.size, self.pos,
                                 self.rowW)]
        m = torch.ones((hi - lo, 1), dtype=torch.bool, device=st[0].device)
        for _ in range(5):
            st[:4] = self.shift_low(m, tuple(st))
        return st[3]


def rc_encode_plain(data, n, model: str, slack: int = SLACK):
    """data [B, N] u8, n [B] (bytes of each row, clamped to [0, N]) ->
    (out [B, N + N // 2 + slack] u8, length [B] int64): each row's first
    n bytes coded with `model` ("o0", "o1" or "cm"), as ht_rc0_encode /
    ht_rc1_encode / ht_rccm_encode code them; zeros past each stream.  A
    row whose stream would pass n + n // 2 + slack bytes gets length -1
    and a zero row."""
    B, N = data.shape
    dev = data.device
    W = out_width(N, slack)
    cnt = n.to(torch.int64).clamp(0, N)
    order = torch.argsort(cnt, descending=True, stable=True)
    counts = cnt[order].tolist()
    d = data[order].to(torch.int64)
    enc = _Enc(B, W, dev)
    mdl = _model(model, B, dev)
    length = _col(B, dev)
    shifts = torch.arange(8, -1, -1, device=dev)[None, :]
    k = B
    for i in range(counts[0] if B else 0):
        k_was = k
        while counts[k - 1] <= i:
            k -= 1
        if k < k_was:
            length[k:k_was] = enc.flush(k, k_was)
            enc.keep(k)
            mdl.keep(k)
        byte = d[:k, i: i + 1]
        # the tree contexts and the bits of the byte, MSB first
        ctxs = (byte | 256) >> shifts
        bits = ctxs[:, 1:] & 1
        for j in range(8):
            bit = bits[:, j: j + 1]
            enc.bit(mdl.predict(ctxs[:, j: j + 1]), bit)
            mdl.update(bit)
        mdl.next_byte(byte)
    if k:
        length[:k] = enc.flush(0, k)
    length = length[:, 0]
    out = enc.out.view(B, W + 1)[:, :W]
    out[enc.ff.view(B, W + 1)[:, :W].cumsum(dim=1) > 0] = 0xFF
    over = length > cnt[order] + cnt[order] // 2 + slack
    out[over] = 0
    length = torch.where(over, -1, length)
    inv = torch.argsort(order)
    return out[inv], length[inv]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def rc_decode_plain(stream, off, count, N: int, model: str):
    """stream [B, M] u8, off [B] (the byte each row's coder stream starts
    at, clamped to [0, M]), count [B] (bytes to decode, clamped to [0,
    N]) -> [B, N] u8: ht_rc*_decode of each row's stream, zeros past
    count.  Bytes at or past M read as 0, as dec_byte reads past the end
    of a stream."""
    B, M = stream.shape
    dev = stream.device
    cnt = count.to(torch.int64).clamp(0, N)
    order = torch.argsort(cnt, descending=True, stable=True)
    counts = cnt[order].tolist()
    # a zero byte at the end of each row: what a read past M gives
    flat = torch.nn.functional.pad(stream[order], (0, 1)).reshape(-1)
    base = torch.arange(B, device=dev)[:, None] * (M + 1)
    at = off.to(torch.int64).clamp(0, M)[order][:, None]
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    mdl = _model(model, B, dev)

    def byte(m):
        nonlocal at
        v = flat.take(base + at).to(torch.int64)
        at = at + (m & (at < M)).to(torch.int64)
        return v

    rng = _col(B, dev, M32)
    code = _col(B, dev)
    yes = torch.ones((B, 1), dtype=torch.bool, device=dev)
    byte(yes)  # the encoder's first cache byte
    for _ in range(4):
        code = (code << 8) | byte(yes)
    one = _col(B, dev, 1)
    k = B
    for i in range(counts[0] if B else 0):
        k_was = k
        while counts[k - 1] <= i:
            k -= 1
        if k < k_was:
            mdl.keep(k)
            rng, code, at, base = rng[:k], code[:k], at[:k], base[:k]
        ctx = one[:k]
        for _ in range(8):
            bound = (rng >> PROB_BITS) * mdl.predict(ctx)
            one_ = code >= bound
            bit = one_.to(torch.int64)
            code = code - bound * bit
            rng = torch.where(one_, rng - bound, bound)
            for _ in range(2):
                if rng.min().item() >= TOP:
                    break
                m = rng < TOP
                code = torch.where(m, ((code << 8) | byte(m)) & M32, code)
                rng = torch.where(m, rng << 8, rng)
            mdl.update(bit)
            ctx = (ctx << 1) | bit
        out[:k, i] = ctx[:, 0].to(torch.uint8)
        mdl.next_byte(ctx & 0xFF)
    return out[torch.argsort(order)]
