"""Reads longer than 262,144 samples, and buckets coded in row slices.

- The port's CPU route against the JAX package's host codec (`press`,
  numpy; no JAX compile) for each of the 19 per-read codecs on one
  synthetic read of 300,001 samples (bucket L = 2^19), and its round
  trip.
- A bucket coded in slices of 3 rows against the same bucket unsliced,
  for all 21 codecs at [10, 4096] (runner.press_bucket /
  depress_bucket, keyword `rows`), encode and decode; drans_vbbe21_zd
  sliced also against the JAX runner (press_signals_tpu, max_b = 10).
- The drans G check still raises ValueError with slices.
- The slice rule (runner.slice_rows) and press_signals taking it.
Stream bytes and samples must be equal (tolerance 0)."""

import numpy as np
import pytest

from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu_torch.engine import runner
from honours_tpu_torch.synth import synthesize_bucket, synthesize_corpus
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

GROUPED = ["drans_vbbe21_zd", "dstall_drans"]
PER_READ = [c for c in runner.engine_codec_names() if c not in GROUPED]
B, L = 10, 4096


@pytest.fixture(scope="module")
def long_read():
    return synthesize_corpus(300_001, seed=17)


@pytest.mark.parametrize("codec", PER_READ)
def test_long_read_matches_host_codec(long_read, codec):
    (ours,) = runner.press_signals([long_read], codec, device="cpu")
    assert ours == registry.get(codec).press(long_read)
    (back,) = runner.depress_signals([ours], [long_read.size], codec,
                                     device="cpu")
    assert np.array_equal(back, long_read)


@pytest.fixture(scope="module")
def bucket():
    """[10, 4096]: synthetic rows, an empty row, a one-sample row and a
    row of full-range random samples that overflows the exception cap
    (the one-row path)."""
    sig, n = synthesize_bucket(B, L, seed=3)
    n[2], n[5] = 0, 1
    sig[2], sig[5, 1:] = 0, 0
    rng = np.random.default_rng(4)
    n[7] = 3000
    sig[7] = 0
    sig[7, :3000] = rng.integers(-32768, 32768, 3000)
    return sig, n


@pytest.mark.parametrize("codec", runner.engine_codec_names())
def test_sliced_bucket_equals_unsliced(bucket, codec):
    sig, n = bucket
    whole = runner.press_bucket(sig, n, codec, "cpu", rows=B)
    assert runner.press_bucket(sig, n, codec, "cpu", rows=3) == whole
    want = runner.depress_bucket(whole, n, L, codec, "cpu", rows=B)
    got = runner.depress_bucket(whole, n, L, codec, "cpu", rows=3)
    for j in range(B):
        assert np.array_equal(want[j], sig[j, : n[j]]), j
        assert np.array_equal(got[j], want[j]), j


def _reads_of_one_bucket():
    """10 reads with lengths in (2048, 4096]: one bucket of the JAX
    runner's at max_b = 10."""
    sig, n = synthesize_bucket(B, L, seed=9)
    return [sig[j, : n[j]] for j in range(B)], sig, n


def test_sliced_drans_matches_jax_runner():
    reads, sig, n = _reads_of_one_bucket()
    theirs = jrunner.press_signals_tpu(reads, "drans_vbbe21_zd", max_b=B)
    ours = runner.press_bucket(sig, n, "drans_vbbe21_zd", "cpu", rows=3)
    assert ours == theirs
    back = runner.depress_bucket(theirs, n, L, "drans_vbbe21_zd", "cpu",
                                 rows=3)
    for j in range(B):
        assert np.array_equal(back[j], reads[j]), j


@pytest.mark.parametrize("codec", GROUPED)
def test_group_mismatch_raises_with_slices(codec):
    """Streams of a 10-row group decoded as a group of 7 rows, in slices
    of 3: the G headers disagree with the group, whichever slice holds
    them."""
    _, sig, n = _reads_of_one_bucket()
    streams = runner.press_bucket(sig, n, codec, "cpu", rows=3)
    with pytest.raises(ValueError, match="group mismatch"):
        runner.depress_bucket(streams[:7], n[:7], L, codec, "cpu", rows=3)


@pytest.mark.parametrize("codec", runner.engine_codec_names())
def test_slice_rule(codec, monkeypatch):
    """Rows a slice: a third of the device's memory over the codec's
    bytes a slot times L; on an 80 GB card, a [256, 2^21] bucket of the
    four heaviest codecs takes more than one slice, and one of 2^19 of
    any codec but rice and shuffman takes one."""
    gb80 = 85_017_493_504  # an H100 80GB HBM3's total_memory

    class Card:
        type = "cuda"

    monkeypatch.setattr(runner, "device_memory", lambda dev: gb80)
    rows = {w: runner.slice_rows(codec, w, Card())
            for w in (1 << 19, 1 << 21, 1 << 22)}
    per = runner.BYTES_A_SLOT[codec]
    for w, r in rows.items():
        assert r == max(1, int(gb80 * runner.SLICE_SHARE) // (per * w))
        assert r * per * w <= gb80 / 3 or r == 1
    if codec in ("rice_vbbe21_zd", "shuffman_vbbe21_zd", "drans_vbbe21_zd",
                 "dstall_drans"):
        assert rows[1 << 21] < 256
    if not codec.startswith(("rice", "shuffman")):
        assert rows[1 << 19] >= 256


def test_press_signals_slices_by_the_rule(bucket, monkeypatch):
    """With a device memory that holds 3 rows of the bucket a slice,
    press_signals and depress_signals code it in slices of 3 rows and
    give the unsliced bytes and samples."""
    sig, n = bucket
    codec = "drans_vbbe21_zd"
    reads = [sig[j, : n[j]] for j in range(B) if n[j] > 2048]
    want = runner.press_signals(reads, codec, device="cpu")
    per = runner.BYTES_A_SLOT[codec] * L
    monkeypatch.setattr(runner, "device_memory",
                        lambda dev: int(3 * per / runner.SLICE_SHARE) + 1)
    assert runner.slice_rows(codec, L, None) == 3
    assert runner.press_signals(reads, codec, device="cpu") == want
    back = runner.depress_signals(want, [r.size for r in reads], codec,
                                  device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(back, reads))
