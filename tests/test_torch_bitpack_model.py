"""Kernel I's group packing (csrc/bitpack.cu bitpack_kernel), checked on
the CPU: a numpy model of its work (pack_model: a thread a group of 8
fields packed MSB-first into a 128-bit register pair, b whole bytes a
group and ceil(rem b / 8) for a row's last; warps of 32 consecutive
groups that find their rows by the kernel's searches of the group
prefix; a warp of one row staging its bytes at the output's misalignment
and storing aligned 16-byte words with a byte head and tail, a warp that
straddles rows storing each group's bytes from its thread) writes every
byte of every row exactly once, nothing else, and the bytes of the plain
version (engine/bitpack.py pack_msb_plain) and of the JAX package's host
packer (honours_tpu/kernels/bitpack.py pack_bits, numpy), exactly.
Rows: every width 0-16 at counts 0-17, around multiples of 8 and long,
unaligned value and output offsets; rows shaped like the uint codecs'
(one long row a read), turbopfor's (rows of 128 fields) and
flat_uint_submin's (short rows a segment, widths 0 among them); at
output addresses 0 and 5 mod 16.  No JAX is imported."""

import numpy as np
import pytest
import torch

import raw_rows
from honours_tpu.kernels.bitpack import pack_bits
from honours_tpu_torch.engine.bitpack import pack_msb_plain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

M64 = (1 << 64) - 1
WARP = 32


def group_pack(f, b: int):
    """The kernel's (hi, lo) of 8 fields of width b (1-16): their 8 b bits
    MSB-first, left-aligned in 128 bits."""
    hi = lo = 0
    for v in f:
        hi = ((hi << b) | (lo >> (64 - b))) & M64
        lo = ((lo << b) | (int(v) & ((1 << b) - 1))) & M64
    sh = 128 - 8 * b
    if sh >= 64:
        hi, lo = (lo << (sh - 64)) & M64, 0
    elif sh > 0:
        hi, lo = ((hi << sh) | (lo >> (64 - sh))) & M64, (lo << sh) & M64
    return hi, lo


def group_byte(hi: int, lo: int, j: int) -> int:
    return (hi >> (56 - 8 * j) if j < 8 else lo >> (120 - 8 * j)) & 0xFF


def row_in(off, lo: int, hi: int, t: int) -> int:
    """The kernel's search: r with off[r] <= t < off[r + 1] in [lo, hi)."""
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if off[mid] <= t:
            lo = mid
        else:
            hi = mid
    return lo


def pack_model(values, val_off, count, width, out, out_off, addr: int = 0,
               stats=None):
    """Kernel I on numpy arrays, into out (u8, in place), out's first byte
    at an address addr mod 16.  Returns the times each byte of out was
    written."""
    R = len(count)
    cnt = np.maximum(count, 0).astype(np.int64)
    b_of = np.clip(width, 0, 16).astype(np.int64)
    gp = np.concatenate([[0], np.cumsum(np.where(b_of > 0, (cnt + 7) >> 3,
                                                 0))]).tolist()
    total = gp[-1]
    writes = np.zeros(out.size, np.int64)

    def put(at: int, v: int):
        out[at] = v
        writes[at] += 1

    st = stats if stats is not None else {}
    for base in range(0, total, WARP):
        last = min(base + WARP - 1, total - 1)
        r0, r1 = row_in(gp, 0, R, base), row_in(gp, 0, R, last)
        packed = []
        for g in range(base, last + 1):
            r = r0 if r0 == r1 else row_in(gp, r0, r1 + 1, g)
            b, gl = int(b_of[r]), g - gp[r]
            nf = min(8, int(cnt[r]) - 8 * gl)
            assert b >= 1 and 1 <= nf <= 8
            v0 = int(val_off[r]) + 8 * gl
            if nf == 8 and v0 % 4 == 0:
                st["vector_loads"] = st.get("vector_loads", 0) + 1
            f = [int(values[v0 + i]) if i < nf else 0 for i in range(8)]
            hi, lo = group_pack(f, b)
            packed.append((r, gl, b, (nf * b + 7) >> 3, hi, lo))
        if r0 == r1:
            st["one_row_warps"] = st.get("one_row_warps", 0) + 1
            b = int(b_of[r0])
            g0, gz = base - gp[r0], last - gp[r0]
            fz = min(8, int(cnt[r0]) - 8 * gz)
            n_run = (gz - g0) * b + ((fz * b + 7) >> 3)
            dst = int(out_off[r0]) + g0 * b
            mis = (addr + dst) & 15
            stage = np.zeros(WARP * 16 + 32, np.int64)
            for lane, (_, _, _, nb, hi, lo) in enumerate(packed):
                for j in range(nb):
                    stage[mis + lane * b + j] = group_byte(hi, lo, j)
            zend = mis + n_run
            assert zend <= stage.size
            for k in range(-(-zend // 16)):
                a = 16 * k
                if a >= mis and a + 16 <= zend:
                    st["words"] = st.get("words", 0) + 1
                    assert (addr + dst - mis + a) % 16 == 0
                for j in range(max(a, mis), min(a + 16, zend)):
                    put(dst - mis + j, int(stage[j]))
        else:
            st["straddling_warps"] = st.get("straddling_warps", 0) + 1
            for r, gl, b, nb, hi, lo in packed:
                for j in range(nb):
                    put(int(out_off[r]) + gl * b + j, group_byte(hi, lo, j))
    return writes


def _check(values, val_off, count, width, out_off, O: int, addrs=(0, 5)):
    """The model, at each address, = pack_msb_plain = pack_bits row by
    row; each row byte written once, no other byte; returns the stats."""
    t = torch.from_numpy
    poison = np.full(O, 0xA5, np.uint8)
    want = pack_msb_plain(t(values), t(val_off), t(count), t(width),
                          t(poison.copy()), t(out_off)).numpy()
    rows = np.zeros(O, np.int64)
    for r in range(len(count)):
        b, k = int(np.clip(width[r], 0, 16)), max(int(count[r]), 0)
        host = np.frombuffer(pack_bits(
            values[val_off[r]: val_off[r] + k].astype(np.int64)
            & ((1 << b) - 1), b), np.uint8)
        assert host.size == (k * b + 7) // 8
        got = want[out_off[r]: out_off[r] + host.size]
        assert np.array_equal(got, host), r
        rows[out_off[r]: out_off[r] + host.size] += 1
    assert rows.max(initial=0) <= 1, "rows overlap"
    stats = {}
    for addr in addrs:
        out = poison.copy()
        writes = pack_model(values, val_off, count, width, out, out_off, addr,
                            stats)
        assert np.array_equal(writes, rows), addr
        assert np.array_equal(out, want), addr
    return stats


COUNTS = [*range(18), 23, 24, 25, 31, 32, 33, 63, 64, 65, 127, 128, 129,
          255, 256, 257, 1000]


@pytest.mark.parametrize("b", range(17))
def test_pack_model_every_width(b):
    """Width b at counts 0-17, around multiples of 8 and 1,000, each
    row's values at an odd or even offset, gaps of 0-5 bytes between the
    rows' outputs."""
    rng = np.random.default_rng(b)
    count = np.array(COUNTS, np.int64)
    V = int(count.sum()) + 64
    values = rng.integers(-2 ** 31, 2 ** 31, V, dtype=np.int64).astype(
        np.int32)
    val_off = (np.cumsum(count) - count + rng.integers(0, 8, count.size))
    width = np.full(count.size, b, np.int64)
    out_off, O = raw_rows.layout((count * b + 7) // 8, b)
    stats = _check(values, val_off.astype(np.int64), count, width, out_off,
                   O)
    if b:
        assert stats["one_row_warps"] and stats["straddling_warps"]


@pytest.mark.parametrize("shape", ["uint", "turbopfor", "flats", "ragged"])
def test_pack_model_callers_rows(shape):
    """Rows shaped as each caller of kernel I lays them out."""
    values, val_off, count, width, out_off, O = raw_rows.caller_rows(
        shape, len(shape))
    stats = _check(values, val_off.astype(np.int64), count, width,
                   out_off.astype(np.int64), O)
    if shape == "uint":
        assert stats["words"] and stats["vector_loads"]
    else:
        assert stats["straddling_warps"]
