"""The port's batched drans_vbbe21_zd engine vs honours_tpu's engine and
host codec.  Seeded numpy inputs into both packages; stream bytes and
decoded samples must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.codecs.drans import drans_press_reads
from honours_tpu.engine import drans as JD
from honours_tpu.engine.pipeline import canned_o1_device_tables as j_tables
from honours_tpu.engine.pipeline import pad_batch
from honours_tpu_torch.engine import drans as TD
from honours_tpu_torch.engine.pipeline import canned_o1_device_tables


def _walk(B, L, seed=5, burst=97):
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, size=(B, L))
    steps[:, ::burst] = rng.integers(-900, 900, size=(B, (L + burst - 1) // burst))
    return np.cumsum(steps, axis=1).clip(-2000, 2000).astype(np.int16)


@pytest.fixture(scope="module")
def tabs():
    return canned_o1_device_tables("cpu")


def _rows(st, sl):
    return [st[b, : int(sl[b])].numpy().tobytes() for b in range(st.shape[0])]


@pytest.mark.parametrize(
    "lens", [[4096] * 8, [4096, 1, 2, 100, 4095, 777, 4000, 8]])
def test_engine_bytes_match_jax_and_host(tabs, lens):
    B, L = 8, 4096
    sig = _walk(B, L)
    sigs = [sig[i, :n] for i, n in enumerate(lens)]
    sigj, nj = pad_batch(sigs, L)
    emax = L // 16
    st, sl = TD.press_drans_batch(torch.from_numpy(np.array(sigj)),
                                  torch.from_numpy(np.array(nj)), tabs, emax)
    ours = _rows(st, sl)
    js, jl = JD.press_drans_batch(sigj, nj, j_tables(), emax)
    assert ours == [np.asarray(js[b, : int(jl[b])]).tobytes() for b in range(B)]
    assert ours == drans_press_reads(sigs)
    out = TD.depress_drans_batch(st, torch.from_numpy(np.array(nj)), tabs, L,
                                 emax=emax)
    assert np.array_equal(out.numpy(), np.asarray(sigj))
    # and the JAX engine's streams decode in the port
    out2 = TD.depress_drans_batch(torch.from_numpy(np.array(js)),
                                  torch.from_numpy(np.array(nj)), tabs, L,
                                  emax=emax)
    assert np.array_equal(out2.numpy(), np.asarray(sigj))


def test_heavy_exceptions(tabs):
    B, L = 8, 2048
    sig = _walk(B, L, seed=9, burst=13)  # ~8% exceptions
    n = torch.full((B,), L)
    st, sl = TD.press_drans_batch(torch.from_numpy(sig), n, tabs, L)
    assert _rows(st, sl) == drans_press_reads([sig[b] for b in range(B)])
    out = TD.depress_drans_batch(st, n, tabs, L, emax=L)
    assert np.array_equal(out.numpy(), sig)


def test_member_mask_matches_jax(tabs):
    B, L = 8, 1024
    sig = _walk(B, L, seed=11)
    n = np.full(B, L, np.int32)
    member = np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    st, sl = TD.press_drans_batch(torch.from_numpy(sig), torch.from_numpy(n),
                                  tabs, L, member=torch.from_numpy(member))
    js, jl = JD.press_drans_batch(jnp.asarray(sig), jnp.asarray(n), j_tables(),
                                  L, member=jnp.asarray(member))
    assert _rows(st, sl) == [np.asarray(js[b, : int(jl[b])]).tobytes()
                             for b in range(B)]
    out = TD.depress_drans_batch(st, torch.from_numpy(n), tabs, L,
                                 member=torch.from_numpy(member))
    assert np.array_equal(out.numpy()[member], sig[member])


def test_group_mismatch_raises(tabs):
    """A stream must refuse to decode in another grouping than its
    encoder's: the G header makes it a ValueError."""
    sigs = [_walk(1, 2000, seed=i)[0] for i in range(3)]
    sts = drans_press_reads(sigs)
    L = 2048
    W = -(-max(len(s) for s in sts[:2]) // 128) * 128
    buf = np.zeros((8, W), np.uint8)
    for j, blob in enumerate(sts[:2]):
        buf[j, : len(blob)] = np.frombuffer(blob, np.uint8)
    n = np.zeros(8, np.int64)
    n[:2] = [s.size for s in sigs[:2]]
    with pytest.raises(ValueError, match="group mismatch"):
        TD.depress_drans_batch(torch.from_numpy(buf), torch.from_numpy(n),
                               tabs, L)
    # the full group decodes
    W = -(-max(len(s) for s in sts) // 128) * 128
    buf = np.zeros((3, W), np.uint8)
    for j, blob in enumerate(sts):
        buf[j, : len(blob)] = np.frombuffer(blob, np.uint8)
    out = TD.depress_drans_batch(torch.from_numpy(buf),
                                 torch.tensor([s.size for s in sigs]), tabs, L)
    for j, s in enumerate(sigs):
        assert np.array_equal(out[j, : s.size].numpy(), s)


def test_prefix_hist_and_fit_match_jax(tabs):
    """The exact bincount histogram == the JAX one-hot matmul histogram."""
    from honours_tpu_torch.engine.entropy_o1 import _lane_grid

    rng = np.random.default_rng(2)
    B, N, K = 4, 600, 32
    data = rng.integers(0, 256, (B, N)).astype(np.uint8)
    dlen = np.array([600, 17, 0, 333], np.int32)
    Smax = -(-N // K)
    g3, ctx3, act3, S_b = _lane_grid(torch.from_numpy(data),
                                     torch.from_numpy(dlen), K, Smax)
    T0 = -torch.div(-S_b, 4, rounding_mode="floor")
    counts = TD.o1_prefix_hist(g3, ctx3, act3, T0)
    jc = JD.o1_prefix_hist(jnp.asarray(g3.numpy().astype(np.int32)),
                           jnp.asarray(ctx3.numpy()), jnp.asarray(act3.numpy()),
                           jnp.asarray(S_b.numpy().astype(np.int32)),
                           jnp.asarray(T0.numpy().astype(np.int32)))
    assert np.array_equal(counts.numpy(), np.asarray(jc))
