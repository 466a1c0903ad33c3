"""The port's vbbe21 exception container and zd split vs honours_tpu.
Seeded numpy inputs into both packages; integer outputs must be equal
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.engine import pipeline as JPL
from honours_tpu.engine import vbbe21 as JV
from honours_tpu_torch.engine import pipeline as TPL
from honours_tpu_torch.engine import vbbe21 as TV
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _vals(B, L, seed, ex_rate):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256, (B, L))
    ex = rng.random((B, L)) < ex_rate
    v = np.where(ex, rng.integers(256, 65536, (B, L)), v).astype(np.int32)
    n = rng.integers(0, L + 1, B).astype(np.int32)
    n[0], n[1] = L, 1
    return v, n


def _cases():
    return [(8, 512, 0, 0.02, 64), (8, 512, 1, 0.3, 512), (4, 256, 2, 0.0, 64)]


@pytest.mark.parametrize("B,L,seed,rate,emax", _cases())
def test_parts_match(B, L, seed, rate, emax):
    v, n = _vals(B, L, seed, rate)
    tp = TV.vbbe21_parts_batch(torch.from_numpy(v), torch.from_numpy(n), emax)
    jp = JV.vbbe21_parts_batch(jnp.asarray(v), jnp.asarray(n), emax)
    assert np.array_equal(tp["nex"].numpy(), np.asarray(jp["nex"]))
    assert np.array_equal(tp["data"].numpy(), np.asarray(jp["data"]))
    assert np.array_equal(tp["data_len"].numpy(), np.asarray(jp["data_len"]))
    ok = np.asarray(jp["nex"]) <= emax  # capped rows are the caller's
    for (tb, tl), (jb, jl) in zip(tp["exsegs"], jp["exsegs"]):
        tl, jl = np.broadcast_to(tl.numpy(), (B,)), np.broadcast_to(jl, (B,))
        assert np.array_equal(tl[ok], jl[ok])
        for b in np.flatnonzero(ok):
            assert np.array_equal(tb.numpy()[b, : tl[b]],
                                  np.asarray(jb)[b, : jl[b]])


def test_parts_wide_rows_match():
    """L > 2^16 takes the two-compaction branch."""
    v, n = _vals(2, 70000, 3, 0.001)
    tp = TV.vbbe21_parts_batch(torch.from_numpy(v), torch.from_numpy(n), 256)
    jp = JV.vbbe21_parts_batch(jnp.asarray(v), jnp.asarray(n), 256)
    assert np.array_equal(tp["data"].numpy(), np.asarray(jp["data"]))
    for (tb, tl), (jb, jl) in zip(tp["exsegs"], jp["exsegs"]):
        for b in range(2):
            m = int(np.broadcast_to(np.asarray(jl), (2,))[b])
            assert int(np.broadcast_to(tl.numpy(), (2,))[b]) == m
            assert np.array_equal(tb.numpy()[b, :m], np.asarray(jb)[b, :m])


@pytest.mark.parametrize("B,L,seed,rate,emax", _cases())
def test_parse_and_fill_roundtrip_match(B, L, seed, rate, emax):
    v, n = _vals(B, L, seed, rate)
    emax = L  # parse needs every exception
    stream, _ = JV.vbbe21_encode_batch(jnp.asarray(v), jnp.asarray(n), emax)
    st = torch.from_numpy(np.array(stream))
    base = torch.zeros(B, dtype=torch.int64)
    tp = TV.vbbe21_parse_batch(st, base, torch.from_numpy(n), L, emax)
    jp = JV.vbbe21_parse_batch(stream, jnp.zeros(B, jnp.int32), jnp.asarray(n),
                               L, emax)
    for k in ("ex_grid", "ex_mask", "nex", "end_off"):
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    # residual bytes follow the block; fill must rebuild v
    data = torch.stack([
        torch.nn.functional.pad(st[b, int(tp["end_off"][b]):],
                                (0, int(tp["end_off"][b])))[:L]
        for b in range(B)])
    vals = TV.vbbe21_fill_batch(tp, data, torch.from_numpy(n), L)
    valid = np.arange(L)[None, :] < n[:, None]
    assert np.array_equal(vals.numpy(), np.where(valid, v, 0))
    jvals = JV.vbbe21_fill_batch(jp, jnp.asarray(data.numpy()), jnp.asarray(n), L)
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_bitlen_matches():
    x = np.array([0, 1, 2, 3, 255, 256, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                 np.int64)
    assert np.array_equal(TV.bitlen(torch.from_numpy(x)).numpy(),
                          np.asarray(JV.bitlen(jnp.asarray(x.astype(np.uint32)))))


def test_zd_parts_and_merge_match():
    rng = np.random.default_rng(4)
    sig = rng.integers(-32768, 32768, (4, 64)).astype(np.int16)
    n = np.array([64, 1, 0, 30], np.int32)
    for i, m in enumerate(n):
        sig[i, m:] = 0
    t0, tr = TPL._zd_parts(torch.from_numpy(sig), torch.from_numpy(n))
    j0, jr = JPL._zd_parts(jnp.asarray(sig), jnp.asarray(n))
    assert np.array_equal(t0.numpy(), np.asarray(j0))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    out = TPL._zd_merge(t0, tr, torch.from_numpy(n), 64)
    assert out.dtype == torch.int16 and np.array_equal(out.numpy(), sig)
    jout = JPL._zd_merge(j0, jr, jnp.asarray(n), 64)
    assert np.array_equal(out.numpy(), np.asarray(jout))
