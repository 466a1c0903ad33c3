"""Kernel 1's plain versions and the port's permute/bits helpers vs
honours_tpu.engine.permute (XLA route) and the Pallas walks in
interpret mode.  Inputs from a seeded numpy generator; outputs are
integers and must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.engine import bits as JB
from honours_tpu.engine import permute as JP
from honours_tpu.engine import permute_pallas as PP
from honours_tpu_torch.engine import bits as TB
from honours_tpu_torch.engine import permute as TP
from honours_tpu_torch.engine import permute_cuda as PC
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

B, N = 8, 300


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "u8": rng.integers(0, 256, (B, N)).astype(np.uint8),
        "i32": rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32),
        "keep": rng.random((B, N)) < 0.6,
    }


@pytest.mark.parametrize("dtype", ["u8", "i32"])
def test_compact_matches_xla_and_pallas(data, dtype):
    v, keep = data[dtype], data["keep"]
    out, cnt = TP.monotone_compact(torch.from_numpy(v), torch.from_numpy(keep))
    jo, jc = JP.monotone_compact(jnp.asarray(v), jnp.asarray(keep))
    _eq(out, jo)
    _eq(cnt, jc)
    po, pc = PP.compact_walk(jnp.asarray(v), jnp.asarray(keep), interpret=True)
    _eq(out, po)
    _eq(cnt, pc)


def test_compaction_shifts_matches_xla_and_pallas(data):
    keep = data["keep"]
    s, c = TP.compaction_shifts(torch.from_numpy(keep))
    js, jc = JP.compaction_shifts(jnp.asarray(keep))
    _eq(s, js)
    _eq(c, jc)
    ps, _ = PP.compaction_shifts_walk(jnp.asarray(keep), interpret=True)
    _eq(s, ps)


@pytest.mark.parametrize("dtype", ["u8", "i32"])
def test_expand_inverts_compact_and_matches(data, dtype):
    v, keep = data[dtype], data["keep"]
    vc, cnt = TP.monotone_compact(torch.from_numpy(v), torch.from_numpy(keep))
    sh, _ = TP.compaction_shifts(torch.from_numpy(keep))
    validc = torch.arange(N)[None, :] < cnt[:, None].to(torch.int64)
    W = 512
    out, cov = TP.monotone_expand(vc, sh, validc, W)
    assert np.array_equal(out.numpy()[:, :N], np.where(keep, v, 0))
    assert np.array_equal(cov.numpy()[:, :N], keep) and not cov[:, N:].any()
    args = (jnp.asarray(vc.numpy()), jnp.asarray(sh.numpy()),
            jnp.asarray(validc.numpy()), W)
    jo, ja = JP.monotone_expand(*args)
    _eq(out, jo)
    _eq(cov, ja)
    po, pa = PP.expand_walk(*args, interpret=True)
    _eq(out, po)
    _eq(cov, pa)


# the tile edges of kernel 1 (permute_cuda.TILE elements per block), rows
# an expansion block takes four and two of, and a row of 2^21 + 5
# columns: the shapes tests/test_torch_gpu.py runs the kernels at, with
# B = 1 and B = 3
T = PC.TILE
EDGE_WIDTHS = [513, T // 2, T - 1, T, T + 1, 3 * T + 5, (1 << 21) + 5]
KEEPS = ["random", "all", "none", "last"]


def edge_case(B, N, kind, seed=0):
    """(u8 values, i32 values, keep) of one edge case."""
    rng = np.random.default_rng(seed + N + B)
    keep = {"random": rng.random((B, N)) < 0.6,
            "all": np.ones((B, N), bool),
            "none": np.zeros((B, N), bool),
            "last": np.arange(N)[None, :].repeat(B, 0) == N - 1}[kind]
    return (rng.integers(0, 256, (B, N)).astype(np.uint8),
            rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32),
            keep)


def edge_targets(B, N, width, lo=0, seed=0):
    """Shifts whose targets rise strictly along each row from `lo` to past
    `width`, with a random valid mask.  (Targets below 0 are outside
    honours_tpu's contract: its routes wrap them, the port drops them.)"""
    rng = np.random.default_rng(seed + N)
    tg = np.sort(rng.choice(np.arange(lo, width + N // 2), N, replace=False))
    shift = np.broadcast_to(tg - np.arange(N), (B, N)).astype(np.int32)
    return shift, rng.random((B, N)) < 0.7


@pytest.mark.parametrize("N", EDGE_WIDTHS)
@pytest.mark.parametrize("B", [1, 3])
def test_edge_widths_match_xla(B, N):
    """Plain compaction, shifts and expansion == the XLA route at the
    kernel's tile edges, on one compile per shape: every keep pattern,
    and at 2^21 + 5 columns the random one and the last-only one."""
    for kind in KEEPS if N < 1 << 21 else ["random", "last"]:
        v, _, keep = edge_case(B, N, kind)
        out, cnt = TP.monotone_compact(torch.from_numpy(v),
                                       torch.from_numpy(keep))
        jo, jc = JP.monotone_compact(jnp.asarray(v), jnp.asarray(keep))
        _eq(out, jo)
        _eq(cnt, jc)
        s, _ = TP.compaction_shifts(torch.from_numpy(keep))
        _eq(s, JP.compaction_shifts(jnp.asarray(keep))[0])
        validc = torch.arange(N)[None, :] < cnt[:, None].to(torch.int64)
        eo, ec = TP.monotone_expand(out, s, validc, N + 3)
        jeo, jec = JP.monotone_expand(jo, jnp.asarray(s.numpy()),
                                      jnp.asarray(validc.numpy()), N + 3)
        _eq(eo, jeo)
        _eq(ec, jec)


@pytest.mark.parametrize("N", EDGE_WIDTHS[:-1])
@pytest.mark.parametrize("B", [1, 3])
def test_edge_widths_match_pallas(B, N):
    """Plain versions == the Pallas walks (interpret mode) at the tile
    edges: both payloads, every keep pattern, and an expansion whose
    targets fall at or past a width above N."""
    for kind in KEEPS:
        v, w, keep = edge_case(B, N, kind)
        for x in (v, w):
            out, cnt = PC.compact_plain(torch.from_numpy(x),
                                        torch.from_numpy(keep))
            po, pc = PP.compact_walk(jnp.asarray(x), jnp.asarray(keep),
                                     interpret=True)
            _eq(out, po)
            _eq(cnt, pc)
        s, _ = PC.compaction_shifts_plain(torch.from_numpy(keep))
        _eq(s, PP.compaction_shifts_walk(jnp.asarray(keep), interpret=True)[0])
    width = N + 700
    shift, valid = edge_targets(B, N, width)
    eo, ec = PC.expand_plain(torch.from_numpy(w), torch.from_numpy(shift),
                             torch.from_numpy(valid), width)
    po, pa = PP.expand_walk(jnp.asarray(w), jnp.asarray(shift),
                            jnp.asarray(valid), width, interpret=True)
    _eq(eo, po)
    _eq(ec, pa)


def test_expand_rejects_narrow_width(data):
    with pytest.raises(ValueError):
        TP.monotone_expand(torch.zeros((2, 8), dtype=torch.uint8),
                           torch.zeros((2, 8), dtype=torch.int32),
                           torch.ones((2, 8), dtype=torch.bool), 4)


def test_expand_plain_drops_out_of_range_targets():
    v = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    sh = torch.tensor([[-1, 0, 1, 5]], dtype=torch.int32)
    out, cov = PC.expand_plain(v, sh, torch.ones_like(v, dtype=torch.bool), 6)
    assert out.tolist() == [[0, 2, 0, 3, 0, 0]]
    assert cov.tolist() == [[False, True, False, True, False, False]]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_rowwise_shift_left_matches(dtype):
    rng = np.random.default_rng(3)
    M, W = 160, 200
    buf = rng.integers(0, 200, (B, M)).astype(dtype)
    shift = rng.integers(0, M + 8, (B,)).astype(np.int32)
    shift[1] = M + 5  # past the end: the whole row drops
    out = TP.rowwise_shift_left(torch.from_numpy(buf), torch.from_numpy(shift), W)
    _eq(out, JP.rowwise_shift_left(jnp.asarray(buf), jnp.asarray(shift), W))


def test_rowwise_concat_dense_and_sparse_matches():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (B, 12)).astype(np.uint8)
    la = rng.integers(0, 13, B).astype(np.int32)
    b = rng.integers(0, 256, (B, 40)).astype(np.uint8)
    kb = rng.random((B, 40)) < 0.3
    c = rng.integers(0, 256, (B, 5)).astype(np.uint8)
    tseg = [(torch.from_numpy(a), torch.from_numpy(la)),
            (torch.from_numpy(b), torch.from_numpy(kb)),
            (torch.from_numpy(c), torch.full((B,), 5))]
    jseg = [(jnp.asarray(a), jnp.asarray(la)), (jnp.asarray(b), jnp.asarray(kb)),
            (jnp.asarray(c), jnp.full((B,), 5, jnp.int32))]
    out, ln = TP.rowwise_concat(tseg, 64)
    jout, jln = JP.rowwise_concat(jseg, 64)
    _eq(out, jout)
    _eq(ln, jln)


def test_forward_fill_and_seg_or_scan_match():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 30, (B, N)).astype(np.int64)
    alive = rng.random((B, N)) < 0.2
    _eq(TP.forward_fill(torch.from_numpy(v), torch.from_numpy(alive)),
        JP.forward_fill(jnp.asarray(v.astype(np.int32)), jnp.asarray(alive)))
    seg = np.sort(rng.integers(0, 40, (B, N)), axis=1).astype(np.int32)
    w = rng.integers(0, 1 << 31, (B, N)).astype(np.int64)
    got = TP.seg_or_scan(torch.from_numpy(w), torch.from_numpy(seg))
    want = JP.seg_or_scan(jnp.asarray(w.astype(np.uint32)), jnp.asarray(seg))
    _eq(got, np.asarray(want).astype(np.int64))


def test_u32_i32_bits_roundtrip():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    y = TP.u32_to_i32(x)
    assert y.dtype == torch.int32
    assert y.tolist() == [0, 1, (1 << 31) - 1, -(1 << 31), -1]
    assert TP.i32_to_u32(y).tolist() == x.tolist()


def test_pack_unpack_fields_match():
    rng = np.random.default_rng(6)
    E, mb = 50, 13
    vals = rng.integers(0, 1 << mb, (B, E)).astype(np.int64)
    count = rng.integers(0, E + 1, B).astype(np.int32)
    pos = np.arange(E)[None, :]
    valid = pos < count[:, None]
    vals = np.where(valid, vals, 0)
    n_words = (E * mb + 31) // 32
    b = np.full((B, 1), mb, np.int32)
    got = TB.pack_fields_msb(torch.from_numpy(vals), torch.from_numpy(b),
                             torch.from_numpy(pos * b), torch.from_numpy(valid),
                             n_words)
    want = JB.pack_fields_msb(jnp.asarray(vals.astype(np.uint32)), jnp.asarray(b),
                              jnp.asarray((pos * b).astype(np.int32)),
                              jnp.asarray(valid), n_words)
    _eq(got, want)
    stream = torch.nn.functional.pad(got, (3, 5))
    base = torch.full((B,), 3)
    back = TB.unpack_fields_msb(stream, base, torch.full((B,), mb),
                                torch.from_numpy(count), E)
    assert np.array_equal(back.numpy(), vals)
    jback = JB.unpack_fields_msb(jnp.asarray(stream.numpy()),
                                 jnp.asarray(base.numpy().astype(np.int32)),
                                 jnp.full((B,), mb, jnp.int32),
                                 jnp.asarray(count), E)
    _eq(back, np.asarray(jback).astype(np.int64))


def test_le_bytes_and_reads_match():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 32, B).astype(np.int64)
    _eq(TB.u32le_bytes(torch.from_numpy(x)),
        JB.u32le_bytes(jnp.asarray(x.astype(np.uint32))))
    _eq(TB.u16le_bytes(torch.from_numpy(x & 0xFFFF)),
        JB.u16le_bytes(jnp.asarray((x & 0xFFFF).astype(np.uint32))))
    s = rng.integers(0, 256, (B, 20)).astype(np.uint8)
    off = rng.integers(-2, 22, B).astype(np.int32)
    _eq(TB.read_u32le(torch.from_numpy(s), torch.from_numpy(off)),
        np.asarray(JB.read_u32le(jnp.asarray(s), jnp.asarray(off))).astype(np.int64))
    _eq(TB.read_u16le(torch.from_numpy(s), torch.from_numpy(off)),
        np.asarray(JB.read_u16le(jnp.asarray(s), jnp.asarray(off))).astype(np.int64))


def test_wrappers_route_cpu_tensors_to_plain(data):
    v, keep = torch.from_numpy(data["u8"]), torch.from_numpy(data["keep"])
    before = {k: PC._COMPACT[k].launches for k in PC._COMPACT}
    out, cnt = PC.compact(v, keep)
    ref, rcnt = PC.compact_plain(v, keep)
    assert torch.equal(out, ref) and torch.equal(cnt, rcnt)
    assert {k: PC._COMPACT[k].launches for k in PC._COMPACT} == before
    with pytest.raises(ValueError, match="mixed"):
        PC.compact(v, keep.to("meta"))


def test_wrapper_checks_rows_and_tiles():
    """The CUDA route's own checks, reachable without a card: rows must be
    [B, N < 2^31] and a launch needs fewer than 2^31 tiles."""
    with pytest.raises(ValueError, match="not \\[B, N"):
        PC._check_rows(torch.zeros(8, dtype=torch.uint8), "values",
                       PC.PAYLOADS)
    with pytest.raises(TypeError):
        PC._check_rows(torch.zeros((2, 8), dtype=torch.int64), "values",
                       PC.PAYLOADS)
    with pytest.raises(ValueError, match="2\\^31 tiles"):
        PC._status(1 << 20, 1 << 11, "cpu")
    st = PC._status(3, PC.compact_tiles(3 * PC.TILE + 5), "cpu")
    assert st.dtype == torch.int64 and st.shape == (3 * 4 + 1,)
    assert not st.any()
    assert PC._status(3, PC.compact_tiles(PC.TILE), "cpu") is None


@pytest.mark.parametrize("N,width,rows", [
    (0, 5, 1), (1, 1, 1), (PC.TILE, PC.TILE, 3), (2048, 2048, 8192),
    (4096, 65536, 256), (4096, 65536, 1), (16384, 262144, 1),
    (65536, 65536, 256), (12293, 12296, 3), (513, 513, 3), (700, 700, 300),
    (2049, 2049, 256)])
def test_expand_tiles_cover_the_row(N, width, rows):
    """An expansion row's tiles: whole per-thread groups of input, at most
    TILE each, every input element in exactly one tile; one tile per
    TILE input elements, and up to one per TILE output columns when the
    rows alone give fewer blocks than the card's 132 SMs.  A block takes
    as many rows of one tile as fit it, each on a power-of-two share of
    whole warps, and one row of several tiles."""
    per, tiles = PC.expand_tiles(N, width, rows, 132)
    rpb = PC.expand_rows_per_block(per, tiles)
    threads = PC.TILE // PC.EPT // rpb
    warps = -(-per // (32 * PC.EPT))
    assert rpb in (1, 2, 4, 8) and threads >= 32 * warps
    if tiles > 1:
        assert rpb == 1
    elif rpb < 8:
        assert threads // 2 < 32 * warps
    assert per % PC.EPT == 0 and 0 < per <= PC.TILE
    assert (tiles - 1) * per < max(N, 1) <= tiles * per
    spread = min(-(-width // PC.TILE), -(-132 // rows), -(-max(N, 1) // PC.EPT))
    assert tiles >= max(-(-N // PC.TILE), spread)
    if rows >= 132:
        assert tiles == max(1, -(-N // PC.TILE))
