"""honours_tpu_torch's bench driver (python -m honours_tpu_torch.bench) and
held-out table build vs honours_tpu's.

The table build must give honours_tpu's integers exactly; each
section's stream bytes are held to honours_tpu's host codecs at the
bench's full width (the three unique fixture chunks at L = 65536) and to
its engines at a small batch; the JSON line keeps bench.py's schema and
skip ledger.  Every comparison is exact (tolerance 0).  No JAX dstall
engine is compiled: the dstall sections are held to the host codecs."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honours_tpu.tables import o1 as jo1
from honours_tpu_torch.bench import driver
from honours_tpu_torch.tables import o1 as to1
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--batch", "8", "--width", "4096"]
FLAGS = ("svb16_lossless", "srans2_lossless", "srans2_host_parity",
         "drans_lossless", "drans_host_parity", "srans_lossless",
         "srans3_lossless", "srans3_host_parity", "dstall_lossless",
         "heldout_lossless", "dstall_drans_lossless",
         "dstall_drans_host_parity")


@pytest.fixture(autouse=True)
def _repo_root(monkeypatch):
    # the bench reads tests/data/three-reads.blow5 from the working dir
    monkeypatch.chdir(REPO)


def _once(b, fn, reps=driver.REPS):
    fn()
    return 1.0


# ---- the order-1 table build ----

def test_fixture_streams_equal_reference():
    ours, theirs = to1.fixture_streams(), jo1.fixture_streams()
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8
        assert a.tobytes() == b.tobytes()


def test_build_regenerates_committed_table():
    tab = to1.build_o1_freqs(to1.fixture_streams())
    assert tab.dtype == np.int64
    assert np.array_equal(tab, to1.canned_o1_freqs())
    for name in ("SHRINK", "R_CLUSTERS", "_SCALE"):
        assert getattr(to1, name) == getattr(jo1, name), name


def test_heldout_table_equals_reference():
    ours = to1.heldout_o1_freqs()
    assert np.array_equal(ours, jo1.heldout_o1_freqs())
    assert not np.array_equal(ours, to1.canned_o1_freqs())
    assert not ours.flags.writeable and to1.heldout_o1_freqs() is ours


def test_pad_batch_equals_reference():
    from honours_tpu.engine.pipeline import pad_batch as jpad
    from honours_tpu_torch.engine.pipeline import pad_batch

    sigs = [np.arange(n, dtype=np.int16) - 7 for n in (1, 13, 9)]
    for L in (None, 13, 30):
        sig, n = pad_batch(sigs, L, device="cpu")
        js, jn = jpad(sigs, L)
        assert sig.dtype == torch.int16 and n.dtype == torch.int32
        assert np.array_equal(sig.numpy(), np.asarray(js))
        assert np.array_equal(n.numpy(), np.asarray(jn))


# ---- the sections at the bench's width, against the host codecs ----

@pytest.fixture(scope="module")
def full_width():
    """The sections on the CPU route at L = 65536 over the three unique
    fixture chunks (B = 3), each timed call made once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        mp.setattr(driver.Bench, "timed", _once)
        b = driver.Bench().load("cpu", 3, driver.L)
        for name, _, fn in driver.plan():
            if name not in ("vbz_ratio", "synthetic"):
                driver.section(b, name, 0, fn)
    return b


def _host_lengths(name, chunks):
    from honours_tpu.codecs.base import get as get_codec
    from honours_tpu.codecs.drans import drans_press_reads
    from honours_tpu.codecs.dstall_drans import dstall_drans_press_reads

    if name == "drans":
        return [len(s) for s in drans_press_reads(chunks)]
    if name == "dstall_drans":
        return [len(s) for s in dstall_drans_press_reads(chunks)]
    codec = get_codec({"srans2": "srans2_vbbe21_zd", "srans": "srans_vbbe21_zd",
                       "srans3": "srans3_vbbe21_zd",
                       "dstall": "dstall_srans2"}[name])
    return [len(codec.press(c)) for c in chunks]


@pytest.mark.parametrize("name", ["srans2", "drans", "srans", "srans3",
                                  "dstall", "dstall_drans"])
def test_unique_chunk_lengths_equal_host_codecs(full_width, name):
    b = full_width
    assert b.skipped == [] and b.n_unique == 3
    chunks = [b.base[i] for i in range(3)]
    assert b.lengths[name] == _host_lengths(name, chunks)


def test_full_width_ratios_and_flags(full_width):
    """srans2 3.0130 and drans 2.9951 (BENCH_r05; BENCH_r04's drans
    2.9952 came from an older tree); every flag true."""
    x = full_width.extra
    assert (x["srans2_ratio"], x["drans_ratio"]) == (3.013, 2.9951)
    assert 393216 / sum(full_width.lengths["srans2"]) == 3.0130108960507562
    assert 393216 / sum(full_width.lengths["drans"]) == 2.9950870992558287
    assert all(x[k] for k in FLAGS)


# ---- main at a small batch, and each section against the JAX engines ----

@pytest.fixture(scope="module")
def small_run():
    """main on the CPU at [8, 4096], one synthetic batch: (last stdout
    line, the run)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        mp.setenv("HTPU_SYNTH_BATCHES", "1")
        with contextlib.redirect_stdout(out):
            b = driver.main(SMALL)
    return out.getvalue().strip().splitlines()[-1], b


def test_main_prints_one_json_line(small_run):
    text, b = small_run
    line = json.loads(text)
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert line["metric"] == "vbz_svb16zd_enc_dec_GBps_per_chip"
    assert line["unit"] == "GB/s" and line["value"] > 0
    x = line["extra"]
    assert x["skipped"] == [] and all(x[k] is True for k in FLAGS)
    assert x["batch"] == [8, 4096] and x["card"] == "cpu"
    assert x["corpus_unique_bytes"] == 8 * 4096 * 2
    assert x["synth_batches"] == 1 and x["synth_raw_bytes"] == 8 * 4096 * 2
    assert x["vbz_ratio"] > 1 and x["synth_vbz_ratio"] > 1


def _jax_batch(b):
    return jnp.asarray(b.base), jnp.full((b.B,), b.L, jnp.int32)


def _jax_lengths(name, b):
    from honours_tpu.engine import drans as JD
    from honours_tpu.engine import entropy_o1 as JO1
    from honours_tpu.engine import pipeline as JP

    sig, n = _jax_batch(b)
    if name == "srans2":
        return JP.press_srans2_batch(sig, n, JP.canned_o1_device_tables(),
                                     b.emax)[1]
    if name == "heldout":
        tabs = JO1.make_o1_tables(jo1.heldout_o1_freqs())
        return JP.press_srans2_batch(sig, n, tabs, b.emax)[1]
    if name == "srans":
        return JP.press_srans_batch(sig, n, *JP.canned_rans_tables(),
                                    b.emax)[1]
    if name == "srans3":
        return JP.press_srans3_batch(sig, n, JP.canned_o1n_device_tables(),
                                     b.emax)[1]
    if name == "drans_tiled":
        return JD.press_drans_batch(sig, n, JP.canned_o1_device_tables(),
                                    b.emax)[1]
    assert name == "drans"
    sj, nj = JP.pad_batch([b.base[i] for i in range(b.n_unique)]
                          + [np.zeros(1, np.int16)] * (8 - b.n_unique), b.L)
    return JD.press_drans_batch(sj, nj, JP.canned_o1_device_tables(),
                                b.emax)[1]


@pytest.mark.parametrize("name", ["srans2", "heldout", "srans", "srans3",
                                  "drans", "drans_tiled"])
def test_small_section_lengths_equal_jax_engine(small_run, name):
    _, b = small_run
    want = np.asarray(_jax_lengths(name, b))[: b.n_unique].tolist()
    assert b.lengths[name] == want


@pytest.mark.parametrize("name", ["dstall", "dstall_drans"])
def test_small_dstall_lengths_equal_host_codecs(small_run, name):
    _, b = small_run
    chunks = [b.base[i] for i in range(b.n_unique)]
    assert b.lengths[name] == _host_lengths(name, chunks)


def test_small_vbz_bytes_equal_jax_svb16(small_run):
    import zstandard

    from honours_tpu.engine.svb16 import svb16_encode_batch

    _, b = small_run
    st, ol = svb16_encode_batch(*_jax_batch(b), zd=True)
    st, ol = np.asarray(st), np.asarray(ol)
    cctx = zstandard.ZstdCompressor(level=1)
    want = sum(len(cctx.compress(st[i, : ol[i]].tobytes())) + 4
               for i in range(b.n_unique))
    assert b.lengths["vbz_ratio"] == [want]


def test_small_synthetic_equals_jax_engine(small_run):
    from honours_tpu.analysis import synthesize_corpus
    from honours_tpu.engine import drans as JD
    from honours_tpu.engine import pipeline as JP

    _, b = small_run
    sig = jnp.asarray(synthesize_corpus(b.B * b.L, seed=100).reshape(b.B, b.L))
    n = jnp.full((b.B,), b.L, jnp.int32)
    tabs = JP.canned_o1_device_tables()
    s2 = int(jnp.sum(JP.press_srans2_batch(sig, n, tabs, b.emax)[1]))
    dr = int(jnp.sum(JD.press_drans_batch(sig, n, tabs, b.emax)[1]))
    assert (b.lengths["synth_srans2"], b.lengths["synth_drans"]) == ([s2],
                                                                     [dr])


def test_tiled_drans_fit_equals_jax_engine(monkeypatch):
    """drans_ratio_tiled fits one model over a batch that repeats rows:
    [16, 16384] holds 14 unique chunks and two repeats."""
    from honours_tpu.engine import drans as JD
    from honours_tpu.engine import pipeline as JP

    monkeypatch.setattr(driver.Bench, "timed", _once)
    b = driver.Bench().load("cpu", 16, 16384)
    assert b.n_unique == 14
    assert np.array_equal(b.base[14:], b.base[:2])
    driver.sec_drans(b)
    assert b.extra["drans_lossless"] and b.extra["drans_host_parity"]
    _, jl = JD.press_drans_batch(*_jax_batch(b), JP.canned_o1_device_tables(),
                                 b.emax)
    assert b.lengths["drans_tiled"] == np.asarray(jl)[:14].tolist()
    # 14 unique rows: the unique batch needs no padding rows
    assert b.lengths["drans"] == _host_lengths(
        "drans", [b.base[i] for i in range(14)])


# ---- the skip ledger, the budget and a missing zstandard ----

def test_failing_section_is_ledgered_and_the_rest_run(monkeypatch):
    def boom(b):
        raise RuntimeError("no such kernel")

    want = {n: (n, 0, f) for n, _, f in driver.plan()}
    monkeypatch.setattr(driver, "plan", lambda: [
        want["svb16"], ("srans", 0, boom), want["heldout"]])
    b = driver.Bench().load("cpu", 8, 4096)
    line = driver.run(b)
    assert line["extra"]["skipped"] == [
        {"section": "srans", "reason": "RuntimeError: no such kernel"}]
    assert line["extra"]["svb16_lossless"] and line["extra"]["heldout_lossless"]
    assert line["value"] > 0


def test_sections_past_the_budget_are_skipped():
    b = driver.Bench(budget_s=5).load("cpu", 8, 4096)
    line = driver.run(b)
    assert [s["section"] for s in line["extra"]["skipped"]] == [
        n for n, _, _ in driver.plan()]
    assert {s["reason"] for s in line["extra"]["skipped"]} == {"budget"}
    assert line["value"] == 0


def test_alarm_prints_the_sentinel_line():
    """A wall-clock budget that runs out outside the sections: the
    sentinel line, then exit 0 (os._exit, as bench.py)."""
    code = ("import time\n"
            "from honours_tpu_torch.bench import driver\n"
            "driver.Bench.load = lambda self, *a: time.sleep(60)\n"
            f"driver.main({SMALL!r})\n")
    env = dict(os.environ, HTPU_BENCH_BUDGET_S="2",
               PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["extra"]["error"] == "timeout: wall-clock budget"
    assert line["extra"]["skipped"] == [] and line["value"] == 0


def test_without_zstandard_vbz_is_skipped_and_synthetic_reports(
        monkeypatch, small_run):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setenv("HTPU_SYNTH_BATCHES", "1")
    want = {n: (n, 0, f) for n, _, f in driver.plan()}
    monkeypatch.setattr(driver, "plan", lambda: [
        want["svb16"], want["vbz_ratio"], want["synthetic"]])
    b = driver.Bench().load("cpu", 8, 4096)
    x = driver.run(b)["extra"]
    (skip,) = x["skipped"]
    assert skip["section"] == "vbz_ratio" and "zstandard" in skip["reason"]
    assert "zstandard" in x["synth_vbz_ratio_missing"]
    assert "synth_vbz_ratio" not in x and "vbz_ratio" not in x
    # the same ratios as the run with zstandard
    full = small_run[1]
    assert (x["synth_srans2_ratio"], x["synth_drans_ratio"]) == (
        full.extra["synth_srans2_ratio"], full.extra["synth_drans_ratio"])
