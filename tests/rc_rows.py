"""Rows for kernels D and E (the range coder, csrc/rangecoder.cu) whose
row keys repeat, shared by the CPU tests, the GPU tests and
chip_smoke.py: numpy only, made from seeds.

A byte's model rows are selected by the previous byte (o1, and cm's o1
and o1s) and the previous two (cm's o2); the cm kernels cache rows in
shared-memory slots by that key, least recently used out, and the o1
kernels code a row in place.  A run repeats both keys at distance 1,
ABAB at 2, ABCABC at 3, a cycle of k distinct bytes at k: past a slot
set's size every key is a miss whose row was written back k bytes
before.  `row_reuse` counts, on the host, the bytes whose rows a slot
set held."""

from collections import OrderedDict

import numpy as np

#: the aliasing patterns, in the order of aliasing_rows
PATTERNS = ("run", "abab", "abcabc", "cycle5", "residual_runs")


def aliasing_row(kind: str, seed: int, n: int = 600) -> np.ndarray:
    """n bytes of pattern `kind` (PATTERNS): a run of one byte, ABAB,
    ABCABC, a cycle of 5 distinct random bytes, or residual-like bytes
    (geometric, mostly small) in runs of 1-12."""
    rng = np.random.default_rng(seed)
    if kind == "residual_runs":
        vals = np.minimum(rng.geometric(0.3, n), 255) - 1
        reps = rng.integers(1, 13, n)
        return np.repeat(vals, reps)[:n].astype(np.uint8)
    k = {"run": 1, "abab": 2, "abcabc": 3, "cycle5": 5}[kind]
    return cycle_row(k, seed, n)


def cycle_row(k: int, seed: int, n: int) -> np.ndarray:
    """n bytes cycling through k distinct random bytes."""
    rng = np.random.default_rng(seed)
    return np.resize(rng.permutation(256)[:k].astype(np.uint8), n)


def aliasing_rows(seed: int, n: int = 600) -> list:
    """One row of each pattern, then cycles of 17, 33 and 9 bytes: past
    cm's 16 o1 slots (17, 33) and its 8 o2 slots (all three), so those
    rows miss every byte, fetched right after their write-back."""
    rows = [aliasing_row(k, seed + i, n) for i, k in enumerate(PATTERNS)]
    return rows + [cycle_row(k, seed + k, n) for k in (17, 33, 9)]


def keys(row: np.ndarray):
    """(prev1, prev1 << 8 | prev2) of each byte of a row: the keys of its
    o1 and o2 rows (the bytes before the first are 0)."""
    b = row.astype(np.int64)
    p1 = np.concatenate([[0], b[:-1]])[: b.size]
    p2 = np.concatenate([[0, 0], b[:-2]])[: b.size]
    return p1, (p1 << 8) | p2


def lru_hits(key_seq, slots: int) -> int:
    """Keys of `key_seq` found in a least-recently-used set of `slots`
    slots (the kernels' Rows), the first key a miss."""
    held: OrderedDict = OrderedDict()
    hits = 0
    for k in key_seq:
        if k in held:
            hits += 1
            held.move_to_end(k)
        else:
            held[k] = None
            if len(held) > slots:
                held.popitem(last=False)
    return hits


def row_reuse(data: np.ndarray, n: np.ndarray, slots) -> list:
    """For each slot set (rangecoder_cuda.SLOTS["cm"]: its o1 and o1s
    rows, then its o2 rows), the share of the rows' bytes whose model row
    a slot held (reused) rather than fetched, over data [B, N] u8 with
    counts n [B]."""
    hits = [0] * len(slots)
    total = 0
    for row, k in zip(data, n):
        row = row[: int(k)]
        total += row.size
        for j, (seq, s) in enumerate(zip(keys(row), slots)):
            hits[j] += lru_hits(seq.tolist(), s)
    return [h / max(total, 1) for h in hits]
