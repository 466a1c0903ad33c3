"""Order-0 srans (format v2) and canned order-1 srans2 (format v3) in the
port: the canned order-0 table, kernel 4b's plain version, the v2 body
encode and decode, srans2's single-walk decode, and both pipelines,
held against honours_tpu's table, its Pallas kernel (interpret mode),
its XLA routes, its host coders and the registry codecs.  Inputs from
seeded numpy generators; outputs are bytes and integers and must be
equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.codecs import srans as jsrans
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.engine import entropy as jent
from honours_tpu.engine import entropy_o1 as jo1
from honours_tpu.engine import pipeline as jpipe
from honours_tpu.engine.rans_o1_pallas import rans_decode_shared_pallas
from honours_tpu.kernels.rans import (
    rans_decode_o1,
    rans_decode_shared,
    rans_encode_o1,
    rans_encode_shared,
)
from honours_tpu.tables.na12878_freq import NA12878_ZD_FREQ as J_FREQ
from honours_tpu.tables.o1 import canned_o1_freqs
from honours_tpu_torch.engine import entropy as tent
from honours_tpu_torch.engine import entropy_o1 as to1
from honours_tpu_torch.engine import rans_o1_cuda as O
from honours_tpu_torch.engine import pipeline as tpipe
from honours_tpu_torch.engine.bits import rowwise_concat
from honours_tpu_torch.kernels.rans import K_SHARED as K
from honours_tpu_torch.tables import na12878_freq as tfreq
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

#: tests/test_rans_pallas.py's ragged lengths (0, 1 and 32 among them)
LENS = [1000, 999, 0, 1, 32, 640, 1000, 128]
N = 1000


def test_canned_freqs_copy_is_exact():
    assert tfreq.NA12878_ZD_FREQ == list(J_FREQ)
    ours = tfreq.canned_freqs()
    assert ours.dtype == jsrans.canned_freqs().dtype
    assert np.array_equal(ours, jsrans.canned_freqs())
    tabs = tent.make_tables(ours, "cpu")
    jf, jc = jent.make_tables(jsrans.canned_freqs())
    assert np.array_equal(tabs["freqs"].numpy(), np.asarray(jf))
    assert np.array_equal(tabs["cum"][:256].numpy(), np.asarray(jc))
    assert int(tabs["cum"][256]) == 4096


@pytest.fixture(scope="module")
def v2_case():
    """Host-coded v2 streams of canned-distribution bytes, each placed
    after `pad` junk bytes of its row."""
    rng = np.random.default_rng(0)
    freqs = jsrans.canned_freqs()
    datas = [rng.choice(256, size=m, p=freqs / freqs.sum()).astype(np.uint8)
             for m in LENS]
    hosts = [rans_encode_shared(d, freqs) for d in datas]
    return datas, hosts


def _place(hosts, pad):
    buf = np.zeros((len(hosts), pad + max(len(h) for h in hosts)), np.uint8)
    buf[:, :pad] = 0xA5
    for i, h in enumerate(hosts):
        buf[i, pad: pad + len(h)] = np.frombuffer(h, np.uint8)
    return buf


@pytest.mark.parametrize("pad", [0, 5])
def test_o0_decode_matches_pallas_xla_and_host(v2_case, pad):
    """Kernel 4b's plain version == rans_decode_shared_pallas
    (interpret), the XLA route and the host decoder."""
    datas, hosts = v2_case
    freqs = jsrans.canned_freqs()
    buf = _place(hosts, pad)
    dl = np.array(LENS, np.int32)
    states = np.stack([np.frombuffer(h, "<u4", K).astype(np.int64)
                       .astype(np.int32) for h in hosts])
    tabs = tent.make_tables(freqs, "cpu")
    body_off = torch.full((8,), pad + 4 * K, dtype=torch.int32)
    args = (torch.from_numpy(buf), torch.from_numpy(states),
            torch.from_numpy(dl), tabs["cum"], N, body_off)
    got = O.o0_decode_plain(*args)
    assert got.shape == (8, N) and got.dtype == torch.uint8
    assert torch.equal(O.o0_decode(*args), got)
    base = torch.full((8,), pad)
    assert torch.equal(tent.rans_decode_batch(args[0], base, args[2], tabs, N),
                       got)

    cume = np.concatenate([[0], np.cumsum(freqs)]).astype(np.int32)
    pallas = np.asarray(rans_decode_shared_pallas(
        jnp.asarray(buf), jnp.asarray(states), jnp.asarray(dl),
        jnp.asarray(cume), N, K, interpret=True,
        body_off=jnp.asarray(body_off.numpy())))
    jf, jc = jent.make_tables(freqs)
    xla = np.asarray(jent.rans_decode_batch(
        jnp.asarray(buf), jnp.full((8,), pad, jnp.int32), jnp.asarray(dl),
        jf, jc, N))
    got = got.numpy()
    for i, d in enumerate(datas):
        m = d.size
        assert np.array_equal(got[i, :m], d), i
        assert not got[i, m:].any(), i
        assert np.array_equal(pallas[i, :m], d), i
        assert np.array_equal(xla[i, :m], d), i
        assert np.array_equal(rans_decode_shared(hosts[i], m, freqs), d), i


def test_v2_encode_matches_engine_and_host():
    """The port's v2 body (kernel 2 on the single-cluster table, then
    kernel 3) == honours_tpu's XLA encode and the host coder."""
    rng = np.random.default_rng(3)
    Nb = 512
    lens = (512, 500, 31, 33, 1, 0, 256, 511)
    buf = np.zeros((len(lens), Nb), np.uint8)
    for i, m in enumerate(lens):
        buf[i, :m] = rng.integers(0, 256, m)
    dl = np.array(lens, np.int32)
    freqs = tfreq.canned_freqs()
    segs, planew = tent.rans_encode_batch(torch.from_numpy(buf),
                                          torch.from_numpy(dl),
                                          tent.make_tables(freqs, "cpu"))
    st, sl = rowwise_concat(segs, 4 * K + planew)
    jf, jc = jent.make_tables(freqs)
    jst, jsl = jent.rans_encode_batch(jnp.asarray(buf), jnp.asarray(dl), jf, jc)
    assert np.array_equal(sl.numpy(), np.asarray(jsl))
    assert np.array_equal(st.numpy(), np.asarray(jst))
    for i, m in enumerate(lens):
        assert st[i, : sl[i]].numpy().tobytes() == rans_encode_shared(
            buf[i, :m], freqs), i


def test_o1_single_walk_decode_matches_engine_and_host():
    """srans2's body decode (one full walk of kernel 4) == honours_tpu's
    rans_o1_decode_batch and the host decoder, bodies at an offset."""
    rng = np.random.default_rng(4)
    Nb = 512
    ft = canned_o1_freqs()
    datas = [rng.integers(0, 256, m).astype(np.uint8)
             for m in (512, 500, 31, 1, 0, 64, 33, 300)]
    hosts = [rans_encode_o1(d, ft, K=K) for d in datas]
    buf = _place(hosts, 3)
    dl = np.array([d.size for d in datas], np.int32)
    got = to1.rans_o1_decode_batch(
        torch.from_numpy(buf), torch.full((8,), 3), torch.from_numpy(dl),
        tpipe.canned_o1_device_tables("cpu"), Nb).numpy()
    want = np.asarray(jo1.rans_o1_decode_batch(
        jnp.asarray(buf), jnp.full((8,), 3, jnp.int32), jnp.asarray(dl),
        jo1.make_o1_tables(ft), Nb))
    for i, d in enumerate(datas):
        assert np.array_equal(got[i, : d.size], d), i
        assert np.array_equal(want[i, : d.size], d), i
        assert np.array_equal(rans_decode_o1(hosts[i], d.size, ft, K=K), d), i


PIPES = {
    "srans_vbbe21_zd": (
        lambda: tpipe.canned_rans_tables("cpu"), tpipe.press_srans_batch,
        tpipe.depress_srans_batch,
        lambda sig, n, emax: jpipe.press_srans_batch(
            sig, n, *jpipe.canned_rans_tables(), emax),
        lambda st, n, L: jpipe.depress_srans_batch(
            st, n, *jpipe.canned_rans_tables(), L)),
    "srans2_vbbe21_zd": (
        lambda: tpipe.canned_o1_device_tables("cpu"),
        tpipe.press_srans2_batch, tpipe.depress_srans2_batch,
        lambda sig, n, emax: jpipe.press_srans2_batch(
            sig, n, jpipe.canned_o1_device_tables(), emax),
        lambda st, n, L: jpipe.depress_srans2_batch(
            st, n, jpipe.canned_o1_device_tables(), L)),
}

L = 1024


@pytest.fixture(scope="module")
def pipe_sigs(fixture_reads):
    rng = np.random.default_rng(15)
    return [
        fixture_reads[0][:L],
        fixture_reads[1][500: 500 + L // 2],
        np.array([256, 5, -3, 700, 0, 0, 0, 1], np.int16),
        np.tile(np.array([0, 30000], np.int16), 300),  # 599 exceptions
        rng.integers(-600, 600, 321).astype(np.int16),
        np.zeros(5, np.int16),
        np.array([9], np.int16),
        rng.integers(400, 700, 1000).astype(np.int16),
    ]


@pytest.mark.parametrize("codec", sorted(PIPES))
def test_pipeline_matches_jax_and_registry(pipe_sigs, codec):
    tables, press, depress, jpress, jdepress = PIPES[codec]
    tabs = tables()
    sig, n = jpipe.pad_batch(pipe_sigs, L)
    sig_t, n_t = torch.from_numpy(np.array(sig)), torch.from_numpy(np.array(n))
    st, sl = press(sig_t, n_t, tabs)
    jst, jsl = jpress(sig, n, None)
    jst, jsl = np.asarray(jst), np.asarray(jsl)
    assert st.shape == jst.shape
    assert np.array_equal(sl.numpy(), jsl)
    host = get_codec(codec)
    for i, s in enumerate(pipe_sigs):
        b = st[i, : sl[i]].numpy().tobytes()
        assert b == jst[i, : jsl[i]].tobytes() == host.press(s), i
    out = depress(st, n_t, tabs, L).numpy()
    jout = np.asarray(jdepress(jnp.asarray(st.numpy()), n, L))
    for i, s in enumerate(pipe_sigs):
        assert np.array_equal(out[i, : s.size], s), i
        assert np.array_equal(jout[i, : s.size], s), i
        assert not out[i, s.size:].any(), i


@pytest.mark.parametrize("codec", sorted(PIPES))
def test_capped_rows_match_jax_and_the_runner_detects_them(pipe_sigs, codec):
    """With emax = 64, the 599-exception row's batch stream is JAX's same
    invalid stream, not the host's, and its header says nex > emax (the
    runner's rule for the one-row path)."""
    tables, press, _, jpress, _ = PIPES[codec]
    sig, n = jpipe.pad_batch(pipe_sigs, L)
    st, sl = press(torch.from_numpy(np.array(sig)),
                   torch.from_numpy(np.array(n)), tables(), 64)
    jst, jsl = jpress(sig, n, 64)
    assert np.array_equal(st.numpy(), np.asarray(jst))
    assert np.array_equal(sl.numpy(), np.asarray(jsl))
    blob = st[3, : sl[3]].numpy().tobytes()
    assert int.from_bytes(blob[2:6], "little") == 599
    assert blob != get_codec(codec).press(pipe_sigs[3])
