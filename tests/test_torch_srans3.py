"""srans3 (nibble-factorized order-1 rANS, wire format v4) in the port:
the nibble tables, kernels 7 and 8's plain versions, the v4 body and
the srans3_vbbe21_zd pipeline, held against honours_tpu's tables, its
Pallas kernels (interpret mode), its engine, its host coders and the
registry codec.  Inputs from seeded numpy generators; outputs are bytes
and integers and must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.codecs.base import get as get_codec
from honours_tpu.engine import entropy_o1n as jn
from honours_tpu.engine import pipeline as jpipe
from honours_tpu.engine.bits import read_u32le as j_read_u32le
from honours_tpu.engine.permute import rowwise_shift_left
from honours_tpu.engine.rans_n4_pallas import (
    o1n_fc_gather_pallas,
    rans_n4_decode_pallas,
)
from honours_tpu.kernels.rans import rans_decode_o1n, rans_encode_o1n
from honours_tpu.tables import o1 as jo1tab
from honours_tpu.tables.o1n import canned_nibble_tables as j_nibble
from honours_tpu_torch.engine import entropy_o1n as tn
from honours_tpu_torch.engine import rans_n4_cuda as R
from honours_tpu_torch.engine.bits import rowwise_concat
from honours_tpu_torch.engine.entropy_o1 import _ungrid
from honours_tpu_torch.engine.pipeline import (
    canned_o1n_device_tables,
    depress_srans3_batch,
    press_srans3_batch,
)
from honours_tpu_torch.kernels.rans import K_SHARED as K
from honours_tpu_torch.tables import o1 as to1tab
from honours_tpu_torch.tables.o1n import canned_nibble_tables as t_nibble

CODEC = "srans3_vbbe21_zd"


@pytest.fixture(scope="module")
def tabs():
    return canned_o1n_device_tables("cpu"), jn.canned_o1n_device_tables()


def _tt(t):
    return t["cmap"], t["lo_assign"], t["fcH"], t["fcL"]


def _host_streams(datas):
    """Host-coded v4 bodies packed into one [B, W] u8 buffer."""
    nib = j_nibble()
    hosts = [rans_encode_o1n(d, nib, K=K) for d in datas]
    buf = np.zeros((len(datas), max(len(h) for h in hosts)), np.uint8)
    for i, h in enumerate(hosts):
        buf[i, : len(h)] = np.frombuffer(h, np.uint8)
    return hosts, buf


@pytest.mark.parametrize("r", [4, 64])
def test_cluster_contexts_copy_is_exact(r):
    rng = np.random.default_rng(r)
    counts = rng.gamma(0.5, 30.0, (300, 16)) + 1e-9
    a1, c1 = to1tab._cluster_contexts(counts, r)
    a2, c2 = jo1tab._cluster_contexts(counts, r)
    assert np.array_equal(a1, a2) and np.array_equal(c1, c2)


def test_canned_nibble_tables_equal(tabs):
    a, b = t_nibble(), j_nibble()
    for k in ("H", "L", "cmap", "lo_assign"):
        assert np.array_equal(a[k], b[k]), k
    tt, jt = tabs
    for mine, theirs in (("cmap", "flat_cmap"), ("lo_assign", "flat_lo"),
                         ("fcH", "flat_fcH"), ("fcL", "flat_fcL")):
        assert tt[mine].dtype == torch.int32
        assert np.array_equal(tt[mine].numpy(), np.asarray(jt[theirs])), mine


def test_o1n_fc_matches_pallas(tabs):
    """Kernel 7's plain version == o1n_fc_gather_pallas (interpret)."""
    tt, jt = tabs
    rng = np.random.default_rng(17)
    sym = rng.integers(0, 256, (2, 300)).astype(np.int32)
    ctx = rng.integers(0, 257, (2, 300)).astype(np.int32)
    fh, fl = o1n_fc_gather_pallas(
        jnp.asarray(sym), jnp.asarray(ctx), jt["cmap_pad"],
        jt["lo_assign_pad"], jt["fcH_tab"], jt["fcL_tab"], interpret=True)
    args = (torch.from_numpy(sym), torch.from_numpy(ctx), *_tt(tt))
    for got in (R.o1n_fc_plain(*args), R.o1n_fc(*args)):
        assert np.array_equal(got[0].numpy(), np.asarray(fh))
        assert np.array_equal(got[1].numpy(), np.asarray(fl))


def test_n4_decode_matches_pallas_and_host(tabs):
    """Kernel 8's plain version == rans_n4_decode_pallas (interpret) on
    host-coded streams, and its grid un-grids to the host's bytes."""
    tt, jt = tabs
    rng = np.random.default_rng(16)
    N = 256
    Smax = N // K
    lens = [256, 250, 31, 1, 0, 129, 64, 200]
    datas = [rng.integers(0, 256, m).astype(np.uint8) for m in lens]
    hosts, buf = _host_streams(datas)
    dl = np.array(lens, np.int32)
    states = np.stack([np.frombuffer(h, "<u4", K, offset=4).astype(np.int32)
                       for h in hosts])
    S_b = np.array([np.frombuffer(h, "<u4", 1)[0] for h in hosts], np.int32)
    grid = R.n4_decode_plain(
        torch.from_numpy(buf), torch.from_numpy(states), torch.from_numpy(dl),
        torch.from_numpy(S_b), torch.full((8,), 4 + 4 * K, dtype=torch.int32),
        *_tt(tt), Smax)
    stream = jnp.asarray(buf)
    base = jnp.zeros((8,), jnp.int32)
    jgrid = rans_n4_decode_pallas(
        rowwise_shift_left(stream, base + 4 + 4 * K, buf.shape[1]),
        jnp.asarray(states), jnp.asarray(dl),
        j_read_u32le(stream, base).astype(jnp.int32), jt, Smax, K,
        interpret=True)
    assert grid.shape == (8, K, Smax) and grid.dtype == torch.uint8
    assert np.array_equal(grid.numpy(), np.asarray(jgrid))
    out = _ungrid(grid, torch.from_numpy(S_b), torch.from_numpy(dl), K, Smax,
                  N).numpy()
    for i, d in enumerate(datas):
        assert np.array_equal(out[i, : d.size], d), i
        assert np.array_equal(rans_decode_o1n(hosts[i], d.size, j_nibble()),
                              d), i


def test_o1n_body_encode_matches_engine_and_host(tabs):
    """The port's v4 body (kernel 7 + kernel 3 at 2*Smax steps) ==
    honours_tpu's engine and the host coder, ragged lengths."""
    tt, jt = tabs
    rng = np.random.default_rng(13)
    N = 512
    lens = (512, 500, 31, 33, 1, 0, 256)
    buf = np.zeros((len(lens), N), np.uint8)
    for i, m in enumerate(lens):
        buf[i, :m] = rng.integers(0, 256, m)
    dl = np.array(lens, np.int32)
    segs, planew = tn.rans_o1n_encode_batch(torch.from_numpy(buf),
                                            torch.from_numpy(dl), tt)
    st, sl = rowwise_concat(segs, 4 + 4 * K + planew)
    jst, jsl = jn.rans_o1n_encode_batch(jnp.asarray(buf), jnp.asarray(dl), jt)
    assert np.array_equal(sl.numpy(), np.asarray(jsl))
    assert np.array_equal(st.numpy(), np.asarray(jst))
    for i, m in enumerate(lens):
        assert st[i, : sl[i]].numpy().tobytes() == rans_encode_o1n(
            buf[i, :m], j_nibble(), K=K), i


def test_o1n_body_decode_matches_engine(tabs):
    tt, jt = tabs
    rng = np.random.default_rng(14)
    N = 512
    datas = [rng.integers(0, 256, m).astype(np.uint8)
             for m in (512, 500, 31, 1, 0, 64)]
    _, buf = _host_streams(datas)
    # the bodies at an offset, as they sit behind the exception block
    buf = np.pad(buf, ((0, 0), (3, 0)))
    dl = np.array([d.size for d in datas], np.int32)
    off = torch.full((len(datas),), 3)
    got = tn.rans_o1n_decode_batch(torch.from_numpy(buf), off,
                                   torch.from_numpy(dl), tt, N).numpy()
    want = np.asarray(jn.rans_o1n_decode_batch(
        jnp.asarray(buf), jnp.full((len(datas),), 3, jnp.int32),
        jnp.asarray(dl), jt, N))
    for i, d in enumerate(datas):
        assert np.array_equal(got[i, : d.size], d), i
        assert np.array_equal(want[i, : d.size], d), i


def test_pipeline_matches_jax_and_registry(fixture_reads, tabs):
    tt, jt = tabs
    L = 1024
    rng = np.random.default_rng(15)
    sigs = [
        fixture_reads[0][:L],
        fixture_reads[1][500: 500 + L // 2],
        np.array([256, 5, -3, 700, 0, 0, 0, 1], np.int16),
        rng.integers(-600, 600, 321).astype(np.int16),
        np.zeros(5, np.int16),
        np.array([9], np.int16),
    ]
    sig, n = jpipe.pad_batch(sigs, L)
    sig_t, n_t = torch.from_numpy(np.array(sig)), torch.from_numpy(
        np.array(n))
    st, sl = press_srans3_batch(sig_t, n_t, tt)
    jst, jsl = jpipe.press_srans3_batch(sig, n, jt)
    jst, jsl = np.asarray(jst), np.asarray(jsl)
    assert np.array_equal(sl.numpy(), jsl)
    codec = get_codec(CODEC)
    for i, s in enumerate(sigs):
        b = st[i, : sl[i]].numpy().tobytes()
        assert b == jst[i, : jsl[i]].tobytes() == codec.press(s), i
    out = depress_srans3_batch(st, n_t, tt, L).numpy()
    jout = np.asarray(jpipe.depress_srans3_batch(jnp.asarray(st.numpy()), n,
                                                 jt, L))
    for i, s in enumerate(sigs):
        assert np.array_equal(out[i, : s.size], s), i
        assert np.array_equal(jout[i, : s.size], s), i
        assert not out[i, s.size:].any(), i


def test_capped_rows_give_invalid_streams_the_runner_detects(tabs):
    """With emax below a row's exception count the batch stream of that
    row is not the host's, and its header says so (the runner's rule)."""
    tt, _ = tabs
    s = np.tile(np.array([0, 30000], np.int16), 300)
    sig = torch.zeros((1, 1024), dtype=torch.int16)
    sig[0, : s.size] = torch.from_numpy(s)
    st, sl = press_srans3_batch(sig, torch.tensor([s.size]), tt, 64)
    blob = st[0, : sl[0]].numpy().tobytes()
    assert int.from_bytes(blob[2:6], "little") > 64
    assert blob != get_codec(CODEC).press(s)
