"""Kernels 2, 3 and 4: the port's plain versions vs honours_tpu's Pallas
kernels (interpret mode) and its XLA routes.  Inputs from a seeded numpy
generator, fed to both packages; outputs are integers and must be equal
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.engine import drans as jdrans
from honours_tpu.engine import entropy_o1 as jo1
from honours_tpu.engine.rans_encode_pallas import rans_encode_core_pallas
from honours_tpu.engine.rans_o1_pallas import (
    o1_fc_gather_pallas,
    rans_o1_decode_resume_pallas,
)
from honours_tpu.tables.o1 import canned_o1_freqs
from honours_tpu_torch.engine import drans as tdrans
from honours_tpu_torch.engine import entropy_o1 as to1
from honours_tpu_torch.engine import rans_encode_cuda as E
from honours_tpu_torch.engine import rans_o1_cuda as O
from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
from honours_tpu_torch.kernels.rans import K_SHARED as K

B = 8


def _walk(Bn, L, seed=5, burst=97):
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, size=(Bn, L))
    steps[:, ::burst] = rng.integers(-900, 900, size=(Bn, (L + burst - 1) // burst))
    return np.cumsum(steps, axis=1).clip(-2000, 2000).astype(np.int16)


@pytest.fixture(scope="module")
def tabs():
    return canned_o1_device_tables("cpu"), jo1.make_o1_tables(canned_o1_freqs())


@pytest.fixture(scope="module")
def grid_case(tabs):
    """Lane grids of random residual bytes with ragged lengths."""
    rng = np.random.default_rng(12)
    N = 256
    lens = np.array([256, 200, 31, 1, 0, 77, 129, 64], np.int32)
    buf = rng.integers(0, 256, (B, N)).astype(np.uint8)
    buf[np.arange(N)[None, :] >= lens[:, None]] = 0
    Smax = -(-N // K)
    g3, ctx3, act3, S_b = to1._lane_grid(torch.from_numpy(buf),
                                         torch.from_numpy(lens), K, Smax)
    return dict(buf=buf, lens=lens, Smax=Smax, g3=g3, ctx3=ctx3, act3=act3,
                S_b=S_b)


def test_lane_grid_matches(grid_case):
    c = grid_case
    jg, jc, ja, jS = jo1._lane_grid(jnp.asarray(c["buf"]),
                                    jnp.asarray(c["lens"]), K, c["Smax"])
    assert np.array_equal(c["g3"].numpy(), np.asarray(jg))
    assert np.array_equal(c["ctx3"].numpy(), np.asarray(jc))
    assert np.array_equal(c["act3"].numpy(), np.asarray(ja))
    assert np.array_equal(c["S_b"].numpy(), np.asarray(jS))


@pytest.mark.parametrize("table", ["canned", "fitted"])
def test_fc_lookup_matches_pallas(tabs, table):
    """Kernel 2's plain version == o1_fc_gather_pallas (interpret)."""
    rng = np.random.default_rng(5)
    sym = rng.integers(0, 256, (2, 300)).astype(np.int32)
    ctx = rng.integers(0, 257, (2, 300)).astype(np.int32)
    if table == "canned":
        tt, jt = tabs
    else:
        counts = rng.integers(0, 1000, (58, 256)).astype(np.int64)
        tt = tdrans.fit_tables_device(torch.from_numpy(counts))
        jt = jdrans.fit_tables_device(jnp.asarray(counts, jnp.int32))
    want = np.asarray(o1_fc_gather_pallas(
        jnp.asarray(sym), jnp.asarray(ctx), jt["cmap_pad"], jt["fc_tab"],
        interpret=True))
    args = (torch.from_numpy(sym), torch.from_numpy(ctx), tt["cmap"], tt["fc"])
    assert np.array_equal(O.o1_fc_plain(*args).numpy(), want)
    assert np.array_equal(O.o1_fc(*args).numpy(), want)


def test_encode_walk_matches_pallas_and_xla(tabs, grid_case):
    """Kernel 3's plain version == rans_encode_core_pallas (interpret)
    and the XLA encode loop behind encode_from_fc."""
    c = grid_case
    tt, jt = tabs
    Smax = c["Smax"]
    g = c["g3"].reshape(B, -1).to(torch.int32)
    fc3 = O.o1_fc(g, c["ctx3"].reshape(B, -1), tt["cmap"], tt["fc"])
    fc3 = fc3.reshape(B, K, Smax)
    fc = torch.where(c["act3"], fc3, 0).transpose(1, 2).reshape(B, Smax * K)
    cand, keep, states = E.encode_core(fc.contiguous(), Smax, K)

    plane, jstates = rans_encode_core_pallas(jnp.asarray(fc.numpy()), Smax, K,
                                             interpret=True)
    plane = np.asarray(plane)
    assert np.array_equal(cand.numpy(), plane & 255)
    assert np.array_equal(keep.numpy(), (plane >> 8) == 1)
    assert np.array_equal(states.numpy(), np.asarray(jstates))

    f3 = (fc3 & 8191).numpy()
    cc3 = (fc3 >> 13).numpy()
    segs, _ = jo1.encode_from_fc(jnp.asarray(f3), jnp.asarray(cc3),
                                 jnp.asarray(c["act3"].numpy()),
                                 jnp.asarray(c["S_b"].numpy()), K, parts=True)
    tsegs, _ = to1.encode_from_fc(fc3, c["act3"], c["S_b"], K)
    for (tb, tl), (jb, jl) in zip(tsegs, segs):
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        assert np.array_equal(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def dec_case(tabs):
    """A drans batch pressed by the port, parsed for the decode walk."""
    L = 512
    sig = _walk(B, L, seed=9)
    lens = np.array([512, 500, 1, 40, 300, 511, 7, 256], np.int32)
    for i, n in enumerate(lens):
        sig[i, n:] = 0
    tt, _ = tabs
    st, _ = tdrans.press_drans_batch(torch.from_numpy(sig),
                                     torch.from_numpy(lens), tt, L)
    d = tdrans.decode_setup(st, torch.from_numpy(lens), L, L)
    Smax = -(-L // K)
    T1 = -(-Smax // 4)
    return dict(stream=st, d=d, T1=T1, T2=Smax - T1)


def _pallas_resume(c, jt, states, T, lo, hi, cl, off):
    g, s, p = rans_o1_decode_resume_pallas(
        jnp.asarray(c["stream"].numpy()), jnp.asarray(states.numpy()),
        jnp.asarray(c["d"]["dlen"].numpy()), jnp.asarray(c["d"]["S_b"].numpy()),
        jt["cmap_pad"], jt["planes_full"], T, K, jnp.asarray(lo.numpy()),
        jnp.asarray(hi.numpy()), jnp.asarray(cl.numpy()), interpret=True,
        body_off=jnp.asarray(off.numpy()))
    return np.asarray(g), np.asarray(s), np.asarray(p)


def test_decode_walk_matches_pallas_and_xla(tabs, dec_case):
    """Kernel 4's plain version, two resumed phases, == the Pallas resume
    entry (interpret) and _xla_walk_phase."""
    tt, jt = tabs
    c, d = dec_case, dec_case["d"]
    zeros = torch.zeros_like(d["S_b"])
    cl0 = tt["cmap"][256].expand(B, K).contiguous()
    args1 = (c["stream"], d["states"], d["dlen"], d["S_b"], tt["cmap"],
             tt["cum"], c["T1"], zeros, d["T0_b"], cl0, d["body_off"])
    g1, s1, p1 = O.o1_decode_plain(*args1)
    assert all(torch.equal(a, b) for a, b in zip((g1, s1, p1), O.o1_decode(*args1)))
    pg, ps, pp = _pallas_resume(c, jt, d["states"], c["T1"], zeros, d["T0_b"],
                                cl0, d["body_off"])
    assert np.array_equal(g1.numpy(), pg)
    assert np.array_equal(s1.numpy(), ps)
    assert np.array_equal(p1.numpy(), pp)

    # XLA walk: body aligned to column 0, relative pointer, context bytes
    from honours_tpu.engine.permute import rowwise_shift_left

    sj = jnp.asarray(c["stream"].numpy())
    body = rowwise_shift_left(sj, jnp.asarray(d["body_off"].numpy()), sj.shape[1])
    xg, xs, xp, xctx = jdrans._xla_walk_phase(
        body, jnp.asarray(d["states"].numpy()).astype(jnp.uint32),
        jnp.zeros((B,), jnp.int32), jnp.full((B, K), 256, jnp.int32),
        jt["cum_ext"], jnp.asarray(d["S_b"].numpy()),
        jnp.asarray(d["dlen"].numpy()), jnp.zeros((B,), jnp.int32),
        jnp.asarray(d["T0_b"].numpy()), c["T1"], K)
    assert np.array_equal(g1.numpy(), np.asarray(xg))
    assert np.array_equal(s1.numpy(), np.asarray(xs).astype(np.int32))
    assert np.array_equal(p1.numpy(), np.asarray(xp) + d["body_off"].numpy())

    include = d["parsed"]["nex"] <= 512
    counts = tdrans.prefix_counts(g1, d, include)
    fit = tdrans.fit_tables_device(counts)
    cl2 = tdrans.phase2_setup(g1, d, fit)
    args2 = (c["stream"], s1, d["dlen"], d["S_b"], fit["cmap"], fit["cum"],
             c["T2"], d["T0_b"], d["S_b"], cl2, p1)
    g2, s2, p2 = O.o1_decode_plain(*args2)
    # the JAX device fit numbers its clusters by bucket, as the port does
    jt2 = jdrans.fit_tables_device(jnp.asarray(counts.numpy(), jnp.int32))
    pg2, ps2, pp2 = _pallas_resume(c, jt2, s1, c["T2"], d["T0_b"], d["S_b"],
                                   cl2, p1)
    assert np.array_equal(g2.numpy(), pg2)
    assert np.array_equal(s2.numpy(), ps2)
    assert np.array_equal(p2.numpy(), pp2)

    xg2, xs2, xp2, _ = jdrans._xla_walk_phase(
        body, xs, xp, xctx, jt2["cum_ext"], jnp.asarray(d["S_b"].numpy()),
        jnp.asarray(d["dlen"].numpy()), jnp.asarray(d["T0_b"].numpy()),
        jnp.asarray(d["S_b"].numpy()), c["T2"], K)
    t = np.arange(c["T2"])[None, None, :] + d["T0_b"].numpy()[:, None, None]
    lanes = np.arange(K)[None, :, None]
    act = (t < d["S_b"].numpy()[:, None, None]) & (
        lanes * d["S_b"].numpy()[:, None, None] + t
        < d["dlen"].numpy()[:, None, None])
    assert np.array_equal(np.where(act, g2.numpy(), 0),
                          np.where(act, np.asarray(xg2), 0))
    assert np.array_equal(s2.numpy(), np.asarray(xs2).astype(np.int32))
    assert np.array_equal(p2.numpy(), np.asarray(xp2) + d["body_off"].numpy())
