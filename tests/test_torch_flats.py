"""flat_uint_submin in the port (engine/flats.py: the plain partition,
kernel K's plain version, and the codec's assembly and parse over the
plain versions of kernels I and J) vs honours_tpu's host codec
(codecs/flats.py partition_flats and FlatUintSubminCodec).  The host's
partition is O(m^2) in Python (about 1 s a read at m = 1,000 chunks), so
it is compared on reads of at most about 20,000 samples (and one of
70,005 for a segment longer than 2^16); a longer read's plain partition
is held to a brute force of the DP written here.  HTPU_FLATS_STEP moves
the partition: the port reads it at press time (utils/config.py), the
host codec takes its step when it is made.  Cuts, bytes and samples
must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import honours_tpu.utils.config as jconfig
import honours_tpu_torch.utils.config as tconfig
import raw_rows
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.codecs.flats import FlatUintSubminCodec, partition_flats
from honours_tpu_torch.engine import flats, runner
from honours_tpu_torch.engine.bounds import bound
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

STEPS = [64, 17]


def _cuts(cut_row, n: int, step: int):
    """A cut row of flats_partition_plain -> the boundary positions."""
    m = -(-n // step)
    return [min(int(k) * step, n)
            for k in np.nonzero(cut_row[: m + 1].numpy())[0]]


def _reads(seed: int):
    rng = np.random.default_rng(seed)
    return raw_rows.flats_reads(seed) + [
        (np.cumsum(rng.integers(-5, 6, 20000)) + 100).astype(np.int16),
        np.repeat(rng.integers(0, 300, 500), 25).astype(np.int16)]


@pytest.mark.parametrize("step", STEPS)
def test_partition_plain_equals_partition_flats(step):
    """Cut for cut, in one batch: empty and one-sample reads, flat runs,
    the tie read repeated (the least i wins each tie), small alphabets,
    walks, full-range noise, lengths no multiple of the step."""
    reads = _reads(step)
    sig, n = raw_rows.pad_rows(reads)
    cut = flats.flats_partition_plain(torch.from_numpy(sig),
                                      torch.from_numpy(n), step)
    assert cut.shape == (len(reads), -(-sig.shape[1] // step) + 1)
    for i, r in enumerate(reads):
        want = partition_flats(r.view(np.uint16), step) if r.size else [0]
        assert _cuts(cut[i], r.size, step) == want, i


def test_tie_takes_the_least_i():
    read, step = raw_rows.tie_read()
    assert partition_flats(read.view(np.uint16), step) == [0, 16]
    cut = flats.flats_partition_plain(torch.from_numpy(read)[None],
                                      torch.tensor([16]), step)
    assert cut[0].tolist() == [1, 0, 1]


def _brute_force(u: np.ndarray, step: int):
    """The DP of codecs/flats.py, an i-vector a step: the range of chunks
    i..j-1 from running extremes of the chunks' extremes."""
    n = u.size
    bounds = list(range(0, n, step)) + [n]
    m = len(bounds) - 1
    cmin = np.array([u[a:b].min() for a, b in zip(bounds, bounds[1:])],
                    np.int64)
    cmax = np.array([u[a:b].max() for a, b in zip(bounds, bounds[1:])],
                    np.int64)
    at = np.array(bounds[:-1], np.int64)
    best = np.zeros(m + 1, np.int64)
    prev = np.zeros(m + 1, np.int64)
    for j in range(1, m + 1):
        lo = np.minimum.accumulate(cmin[:j][::-1])[::-1]
        hi = np.maximum.accumulate(cmax[:j][::-1])[::-1]
        bits = np.array([int(d).bit_length() for d in hi - lo])
        cost = best[:j] + 3 + ((bounds[j] - at[:j]) * bits + 7) // 8
        prev[j] = int(np.argmin(cost))  # the first minimum
        best[j] = cost[prev[j]]
    cuts = [m]
    while cuts[-1]:
        cuts.append(prev[cuts[-1]])
    return [bounds[c] for c in reversed(cuts)]


def test_partition_plain_on_a_long_read():
    """A 100,000-sample read (m = 1,563): the plain partition equals the
    brute force."""
    from honours_tpu_torch.synth import synthesize_corpus

    read = synthesize_corpus(100_000, seed=12)
    cut = flats.flats_partition_plain(torch.from_numpy(read)[None],
                                      torch.tensor([read.size]), 64)
    assert _cuts(cut[0], read.size, 64) == _brute_force(
        read.view(np.uint16), 64)


def _use_step(monkeypatch, step):
    for k in ("HTPU_FLATS_STEP",):
        monkeypatch.delenv(k, raising=False)
    if step is not None:
        monkeypatch.setenv("HTPU_FLATS_STEP", str(step))
    monkeypatch.setattr(jconfig, "_CONFIG", None)
    monkeypatch.setattr(tconfig, "_CONFIG", None)


@pytest.mark.parametrize("step", [None, 17, 256])
def test_codec_equals_the_host_codec(monkeypatch, step):
    """flat_uint_submin through the runner with HTPU_FLATS_STEP unset
    (64), 17 and 256: the host codec's bytes for every read (n = 0: 00 00
    00 00), the port decodes its streams and the host decodes them."""
    _use_step(monkeypatch, step)
    host = FlatUintSubminCodec()
    assert host.step == (step or 64) == tconfig.get_config().flats_step
    reads = _reads(3)
    ours = runner.press_signals(reads, "flat_uint_submin", device="cpu")
    assert ours == [host.press(r) for r in reads]
    assert ours[0] == b"\x00\x00\x00\x00"
    back = runner.depress_signals(ours, [r.size for r in reads],
                                  "flat_uint_submin", device="cpu")
    for r, s, b in zip(reads, ours, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
        if r.size:
            assert np.array_equal(host.depress(s, r.size), r)


def test_segment_longer_than_2_16():
    """A flat run of 70,000 samples is one segment whose length svb32
    codes in 3 bytes, as the host does."""
    rng = np.random.default_rng(4)
    read = np.concatenate([np.full(70_000, 300), rng.integers(0, 4000, 5)])
    read = read.astype(np.int16)
    host = get_codec("flat_uint_submin")
    (ours,) = runner.press_signals([read], "flat_uint_submin", device="cpu")
    assert ours == host.press(read)
    assert ours[4] & 3 == 2  # the first length takes 3 bytes
    (back,) = runner.depress_signals([ours], [read.size],
                                     "flat_uint_submin", device="cpu")
    assert np.array_equal(back, read)


def test_bound_equals_the_host_codec():
    for n in (0, 1, 7, 1024, 1025, 155185, 3_000_001):
        b = bound("flat_uint_submin", n)
        assert b == get_codec("flat_uint_submin").bound(n) and type(b) is int
