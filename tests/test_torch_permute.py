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
