"""The port's svb32, vb exception containers (vb_batch.py), ex-zd and
rice encode vs honours_tpu's engine functions and host codecs, at
L = 1024 on tests/test_engine_vb.py's batch plus an empty row and a row
of random samples (every value an exception), with emax = L.  Stream
bytes, lengths and samples must be equal (tolerance 0)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.codecs import base as registry
from honours_tpu.engine import exzd as jexzd
from honours_tpu.engine import rice as jrice
from honours_tpu.engine import svb32 as jsvb32
from honours_tpu.engine import vb_batch as jvb
from honours_tpu.kernels.svb import svb0124_encode, svb32_encode
from honours_tpu_torch.engine import exzd, rice, svb32, vb_batch
from honours_tpu_torch.transforms.core import find_qts
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

L = 1024


@pytest.fixture(scope="module")
def batch(fixture_reads):
    """tests/test_engine_vb.py's rows (n = 1 among them), an empty row
    and a row of random samples."""
    rng = np.random.default_rng(13)
    sigs = [
        fixture_reads[0][:L],
        fixture_reads[1][500: 500 + L // 2],
        np.array([256, 5, -3, 700, 0, 0, 0, 1], np.int16),
        np.zeros(5, np.int16),
        rng.integers(-600, 600, 321).astype(np.int16),
        np.tile(np.array([0, 30000], np.int16), 200),
        np.array([5], np.int16),
        np.array([5, 700], np.int16),
        np.zeros(0, np.int16),
        rng.integers(-32768, 32768, L).astype(np.int16),
    ]
    sig = np.zeros((len(sigs), L), np.int16)
    n = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        sig[i, : s.size] = s
        n[i] = s.size
    return sigs, sig, n


def _rows(st, sl):
    st, sl = np.asarray(st), np.asarray(sl)
    return [st[i, : sl[i]].tobytes() for i in range(len(sl))]


def _same_streams(ours, theirs):
    """Equal lengths and bytes per row -> the rows' bytes."""
    assert np.array_equal(np.asarray(ours[1]), np.asarray(theirs[1]))
    rows = _rows(*ours)
    assert rows == _rows(*theirs)
    return ours[0], rows


@pytest.mark.parametrize("variant", ["1234", "0124"])
def test_svb32_matches_jax_and_host(variant):
    rng = np.random.default_rng(2)
    vals = [
        rng.integers(0, 1 << 8, 64).astype(np.uint32),
        rng.integers(0, 1 << 16, 100).astype(np.uint32),
        rng.integers(0, 1 << 32, 128, dtype=np.uint64).astype(np.uint32),
        np.zeros(5, np.uint32),
        np.array([0], np.uint32),
        np.zeros(0, np.uint32),
        np.array([2 ** 31, 2 ** 32 - 1, 0, 255, 256, 65535, 65536,
                  2 ** 24 - 1, 2 ** 24, 2 ** 31 - 1], np.uint32),
    ]
    N = 128
    buf = np.zeros((len(vals), N), np.uint32)
    n = np.zeros(len(vals), np.int32)
    for i, v in enumerate(vals):
        buf[i, : v.size] = v
        n[i] = v.size
    ser = svb32_encode if variant == "1234" else svb0124_encode
    st, rows = _same_streams(
        svb32.svb32_encode_batch(torch.from_numpy(buf.astype(np.int64)),
                                 torch.from_numpy(n), variant),
        jsvb32.svb32_encode_batch(jnp.asarray(buf), jnp.asarray(n), variant))
    assert rows == [ser(v) for v in vals]
    out = svb32.svb32_decode_batch(st, torch.from_numpy(n), N, variant)
    assert out.dtype == torch.int64
    assert np.array_equal(out.numpy(), buf.astype(np.int64))
    theirs = jsvb32.svb32_decode_batch(jnp.asarray(st.numpy()),
                                       jnp.asarray(n), N, variant)
    assert np.array_equal(out.numpy(), np.asarray(theirs).astype(np.int64))


def _check_host(rows, sigs, codec):
    host = registry.get(codec)
    for i, s in enumerate(sigs):
        if s.size:
            assert rows[i] == host.press(s), i


@pytest.mark.parametrize("kind", ["vb1e2", "vbe21", "vbbe21", "vbsbe21",
                                  "vbsse21"])
def test_vb_zd_matches_jax_and_host(batch, kind):
    sigs, sig, n = batch
    st, rows = _same_streams(
        vb_batch.press_vb_zd_batch(torch.from_numpy(sig), torch.from_numpy(n),
                                   kind),
        jvb.press_vb_zd_batch(jnp.asarray(sig), jnp.asarray(n), kind))
    _check_host(rows, sigs, f"{kind}_zd")
    out = vb_batch.depress_vb_zd_batch(st, torch.from_numpy(n), kind, L)
    assert out.dtype == torch.int16 and np.array_equal(out.numpy(), sig)
    theirs = jvb.depress_vb_zd_batch(jnp.asarray(st.numpy()), jnp.asarray(n),
                                     kind, L)
    assert np.array_equal(out.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("kind", ["vb1e2", "vbe21", "vbsbe21", "vbsse21"])
def test_container_encoders_are_the_zd_payload(batch, kind):
    """The containers' own encoders on zd[1:] with n - 1 values give
    press_vb_zd_batch's streams after their 2-byte zd0 header, also with
    emax = 64 (rows past it included)."""
    from honours_tpu_torch.engine.pipeline import _zd_parts

    _, sig, n = batch
    sig, n = torch.from_numpy(sig), torch.from_numpy(n).to(torch.int64)
    encode = {
        "vb1e2": vb_batch.vb1e2_encode_batch,
        "vbe21": vb_batch.vbe21_encode_batch,
        "vbsbe21": partial(vb_batch.vbs_encode_batch, val_svb=False),
        "vbsse21": partial(vb_batch.vbs_encode_batch, val_svb=True),
    }[kind]
    for emax in (None, 64):
        rows = _rows(*encode(_zd_parts(sig, n)[1], n - 1, emax))
        zd = _rows(*vb_batch.press_vb_zd_batch(sig, n, kind, emax))
        assert rows == [r[2:] for r in zd]


@pytest.mark.parametrize("variant", ["1234", "0124"])
def test_svb_zd_matches_jax_and_host(batch, variant):
    sigs, sig, n = batch
    st, rows = _same_streams(
        vb_batch.press_svb_zd_batch(torch.from_numpy(sig),
                                    torch.from_numpy(n), variant),
        jvb.press_svb_zd_batch(jnp.asarray(sig), jnp.asarray(n), variant))
    _check_host(rows, sigs, "svb_zd" if variant == "1234" else "svb0124_zd")
    out = vb_batch.depress_svb_zd_batch(st, torch.from_numpy(n), L, variant)
    assert out.dtype == torch.int16 and np.array_equal(out.numpy(), sig)


def test_exzd_matches_jax_and_host(batch):
    sigs, sig, n = batch
    st, rows = _same_streams(
        exzd.press_exzd_batch(torch.from_numpy(sig), torch.from_numpy(n)),
        jexzd.press_exzd_batch(jnp.asarray(sig), jnp.asarray(n)))
    _check_host(rows, sigs, "hasgam_vbsse21_zdq")
    out = exzd.depress_exzd_batch(st, torch.from_numpy(n), L)
    assert out.dtype == torch.int16 and np.array_equal(out.numpy(), sig)
    theirs = jexzd.depress_exzd_batch(jnp.asarray(st.numpy()),
                                      jnp.asarray(n), L)
    assert np.array_equal(out.numpy(), np.asarray(theirs))


def test_exzd_qts_shift():
    """Samples sharing trailing zero bits take q = 1..5; an empty row
    takes 5."""
    rng = np.random.default_rng(5)
    sig = np.zeros((7, 64), np.int16)
    n = np.array([64, 64, 64, 64, 64, 64, 0], np.int32)
    for q in range(6):
        sig[q] = (rng.integers(-500, 500, 64) << q).astype(np.int16) | (
            1 << q)
    ours = find_qts(torch.from_numpy(sig), torch.from_numpy(n))
    assert ours.tolist() == [0, 1, 2, 3, 4, 5, 5]
    theirs = jexzd._qts_batch(jnp.asarray(sig), jnp.asarray(n))
    assert ours.tolist() == np.asarray(theirs).tolist()


def test_rice_encode_matches_jax_and_host():
    """Byte rows of every k's taste (all 0, small, large, uniform), an
    empty row and the runner's empty-read length -1."""
    rng = np.random.default_rng(9)
    N = 256
    data = np.stack([
        np.zeros(N), rng.integers(0, 4, N), rng.integers(0, 40, N),
        rng.integers(200, 256, N), rng.integers(0, 256, N),
        rng.integers(0, 256, N), rng.integers(0, 256, N),
    ]).astype(np.int32)
    dlen = np.array([N, N, 200, N, 1, 0, -1], np.int32)
    _, rows = _same_streams(
        rice.rice_encode_batch(torch.from_numpy(data), torch.from_numpy(dlen)),
        jrice.rice_encode_batch(jnp.asarray(data), jnp.asarray(dlen)))
    from honours_tpu.codecs.rice import rice_encode

    for i in range(5):
        assert rows[i] == rice_encode(data[i, : dlen[i]].astype(np.uint8)), i


@pytest.mark.parametrize("kind", ["vbe21", "vbbe21", "vbsbe21", "vbsse21"])
def test_rice_zd_matches_jax_and_host(batch, kind):
    sigs, sig, n = batch
    _, rows = _same_streams(
        rice.press_rice_vb_zd_batch(torch.from_numpy(sig),
                                    torch.from_numpy(n), kind),
        jrice.press_rice_vb_zd_batch(jnp.asarray(sig), jnp.asarray(n), kind))
    _check_host(rows, sigs, f"rice_{kind}_zd")
