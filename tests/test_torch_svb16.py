"""Kernels 5 and 6: the port's svb16 plain versions (and the engine
module around them) vs honours_tpu's fused Pallas kernels (interpret
mode), its XLA route and the host coder.  Inputs from a seeded numpy
generator, fed to both packages; outputs are bytes and integers and must
be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.engine import svb16 as jsvb
from honours_tpu.engine.svb16_fused import (
    svb16_decode_fused,
    svb16_encode_fused,
)
from honours_tpu.kernels.svb import svb16_encode as host_encode
from honours_tpu.transforms.core import zigdelta as host_zigdelta
from honours_tpu_torch.engine import svb16_cuda as S
from honours_tpu_torch.engine.svb16 import (
    svb16_decode_batch,
    svb16_encode_batch,
)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ZD = pytest.mark.parametrize("zd", [True, False], ids=["zd", "raw"])


def _batch(seed, B, L):
    """tests/test_svb16_fused.py's ragged batch: rows with n of 0 and 1,
    nanopore-like rows, all-two-byte rows and 0/3000 alternations."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((B, L), np.int16)
    n = np.zeros(B, np.int32)
    for i in range(B):
        kind = i % 4
        ni = int(rng.integers(0, L + 1)) if kind == 0 else L
        if kind == 1:
            row = rng.integers(400, 700, ni)
        elif kind == 2:
            row = rng.integers(-(2 ** 15), 2 ** 15, ni)
        else:
            row = rng.integers(0, 2, ni) * 3000
        sig[i, :ni] = row.astype(np.int16)
        n[i] = ni
    n[0] = 0
    n[1] = 1
    return sig, n


def _port_encode(sig, n, zd):
    st, ln = S.svb16_encode(torch.from_numpy(sig), torch.from_numpy(n), zd)
    return st.numpy(), ln.numpy()


@ZD
def test_encode_matches_pallas_interpret(zd):
    sig, n = _batch(0, 8, 256)
    st, ln = _port_encode(sig, n, zd)
    jst, jln = svb16_encode_fused(jnp.asarray(sig), jnp.asarray(n), zd=zd,
                                  interpret=True)
    assert np.array_equal(ln, np.asarray(jln))
    assert np.array_equal(st, np.asarray(jst))


@ZD
def test_encode_matches_xla_route_and_host(zd):
    sig, n = _batch(2, 8, 512)
    st, ln = _port_encode(sig, n, zd)
    jst, jln = jsvb.svb16_encode_batch(jnp.asarray(sig), jnp.asarray(n), zd=zd)
    assert np.array_equal(ln, np.asarray(jln))
    assert np.array_equal(st, np.asarray(jst))
    for i in range(8):
        row = sig[i, : n[i]]
        v = host_zigdelta(row) if zd else row.astype(np.int64) % (1 << 16)
        ref = host_encode(v.astype(np.uint16))
        assert st[i, : ln[i]].tobytes() == ref, i
        assert not st[i, ln[i]:].any(), i


@ZD
def test_decode_matches_pallas_interpret(zd):
    sig, n = _batch(1, 8, 256)
    jst, _ = svb16_encode_fused(jnp.asarray(sig), jnp.asarray(n), zd=zd,
                                interpret=True)
    want = np.asarray(svb16_decode_fused(jst, jnp.asarray(n), 256, zd=zd,
                                         interpret=True))
    got = S.svb16_decode(torch.from_numpy(np.array(jst)),
                         torch.from_numpy(n), 256, zd)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)
    expect = sig.copy()
    for i in range(8):
        expect[i, n[i]:] = 0
    assert np.array_equal(got.numpy(), expect)


@ZD
def test_decode_of_xla_streams_and_truncated_rows(zd):
    """The port decodes the XLA route's streams (cut to a 128-multiple
    width, as the runner packs them); a stream cut short decodes to
    garbage without raising."""
    sig, n = _batch(3, 8, 512)
    jst, jln = jsvb.svb16_encode_batch(jnp.asarray(sig), jnp.asarray(n), zd=zd)
    W = -(-int(np.asarray(jln).max()) // 128) * 128
    buf = torch.from_numpy(np.asarray(jst)[:, :W].copy())
    out = svb16_decode_batch(buf, torch.from_numpy(n.astype(np.int64)), 512,
                             zd)
    want = np.asarray(jsvb.svb16_decode_batch(jst, jnp.asarray(n), 512, zd=zd))
    assert np.array_equal(out.numpy(), want)
    short = S.svb16_decode(buf[:, :20], torch.from_numpy(n), 512, zd)
    empty = S.svb16_decode(buf[:, :0], torch.from_numpy(n), 512, zd)
    assert short.shape == empty.shape == (8, 512)
    assert not empty[:, 0].any()


@pytest.mark.parametrize("L", [8, 1024, 4104])
def test_engine_round_trip_at_other_widths(L):
    sig, n = _batch(L, 6, L)
    st, ln = svb16_encode_batch(torch.from_numpy(sig),
                                torch.from_numpy(n.astype(np.int64)))
    assert st.shape == (6, S.stream_width(L)) and ln.dtype == torch.int32
    out = svb16_decode_batch(st, torch.from_numpy(n), L).numpy()
    for i in range(6):
        assert np.array_equal(out[i, : n[i]], sig[i, : n[i]]), i
        assert not out[i, n[i]:].any(), i


def test_encode_rejects_width_not_multiple_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        S.svb16_encode(torch.zeros((2, 12), dtype=torch.int16),
                       torch.tensor([3, 4], dtype=torch.int32))
