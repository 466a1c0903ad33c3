"""honours_tpu_torch tables and transforms vs honours_tpu.

Inputs are made with numpy from a seed and fed to both packages; every
output is an integer and must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.engine import drans as jdrans
from honours_tpu.engine import entropy_o1 as jo1
from honours_tpu.tables import drans as jtab
from honours_tpu.tables.o1 import canned_o1_freqs as j_canned
from honours_tpu.transforms.core import jnp_unzigdelta, jnp_zigdelta
from honours_tpu_torch.engine import drans as tdrans
from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
from honours_tpu_torch.kernels import rans as trans
from honours_tpu_torch.tables import drans as ttab
from honours_tpu_torch.tables.o1 import canned_o1_freqs as t_canned
from honours_tpu_torch.transforms.core import unzigdelta, zigdelta


def _fc_grid(tabs):
    """[257, 256] (f, c) per (ctx, sym) through the port's cluster map."""
    fc = tabs["fc"].to(torch.int64)[tabs["cmap"].to(torch.int64)]
    return (fc & 8191).numpy(), (fc >> 13).numpy()


def test_canned_table_copy_is_bit_equal():
    a, b = t_canned(), j_canned()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_constants_match():
    from honours_tpu.kernels import rans as jr

    for name in ("PROB_BITS", "M", "RANS_L", "K_SHARED", "CTX0"):
        assert getattr(trans, name) == getattr(jr, name), name
    for name in ("NB", "W_FIT", "PREFIX_DEN"):
        assert getattr(ttab, name) == getattr(jtab, name), name


@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_and_dnorm_match(seed):
    from honours_tpu.kernels.rans import normalize_freqs

    rng = np.random.default_rng(seed)
    for _ in range(20):
        e = rng.integers(0, 1 << 20, 256).astype(np.int64)
        e[rng.random(256) < 0.5] = 0
        e[0] += 1
        assert np.array_equal(trans.normalize_freqs(e), normalize_freqs(e))
        assert np.array_equal(ttab.dnorm(e), jtab.dnorm(e))


def test_bucket_map_and_base_rows():
    ctx = np.arange(257, dtype=np.int64)
    assert np.array_equal(ttab.bucket_of(ctx), jtab.bucket_of(ctx))
    tb = ttab.bucket_of(torch.arange(257))
    assert np.array_equal(tb.numpy(), jtab.bucket_of(ctx))
    assert np.array_equal(ttab.base_rows(), jtab.base_rows())
    for S in (0, 1, 3, 4, 5, 2048):
        assert ttab.prefix_steps(S) == jtab.prefix_steps(S)


def test_fit_freqs_matches():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 1 << 20, size=(ttab.NB, 256)).astype(np.int64)
    counts[rng.random((ttab.NB, 256)) < 0.5] = 0
    assert np.array_equal(ttab.fit_freqs(counts), jtab.fit_freqs(counts))


@pytest.mark.parametrize("seed", [3, 4])
def test_fit_tables_device_matches_host_fit(seed):
    """The port's device fit gives every (ctx, sym) the (f, c) of the
    host fit (tests/test_drans.py's device-fit check, against the port)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 1 << 20, size=(ttab.NB, 256)).astype(np.int64)
    counts[rng.random((ttab.NB, 256)) < 0.5] = 0
    dev = tdrans.fit_tables_device(torch.from_numpy(counts))
    host = jdrans.make_drans_tables(jtab.fit_freqs(counts))
    f, c = _fc_grid(dev)
    assert np.array_equal(f.reshape(-1), np.asarray(host["flat_f"]))
    assert np.array_equal(c.reshape(-1), np.asarray(host["flat_c"]))
    cum = dev["cum"].to(torch.int64)[dev["cmap"].to(torch.int64)].numpy()
    assert np.array_equal(cum, np.asarray(host["cum_ext"]))
    # and the JAX engine's own device fit
    jdev = jdrans.fit_tables_device(jnp.asarray(counts, jnp.int32))
    assert np.array_equal(f.reshape(-1), np.asarray(jdev["flat_f"]))


def test_make_o1_tables_matches_canned():
    tabs = make_o1_tables(t_canned(), "cpu")
    jt = jo1.make_o1_tables(j_canned())
    f, c = _fc_grid(tabs)
    assert np.array_equal(f.reshape(-1), np.asarray(jt["flat_f"]))
    assert np.array_equal(c.reshape(-1), np.asarray(jt["flat_c"]))
    assert np.array_equal(tabs["cmap"].numpy(), np.asarray(jt["cmap"]))
    assert np.array_equal(
        tabs["fc"].numpy().reshape(-1),
        np.asarray(jt["fc_tab"]).reshape(-1)[: tabs["fc"].numel()])


def test_zigdelta_roundtrip_matches():
    rng = np.random.default_rng(7)
    x = rng.integers(-32768, 32768, (4, 300)).astype(np.int16)
    x[0, :50] = 500
    z = zigdelta(torch.from_numpy(x))
    assert np.array_equal(z.numpy(), np.asarray(jnp_zigdelta(jnp.asarray(x))))
    back = unzigdelta(z)
    assert back.dtype == torch.int16 and np.array_equal(back.numpy(), x)
    assert np.array_equal(
        back.numpy(), np.asarray(jnp_unzigdelta(jnp.asarray(z.numpy()))))
