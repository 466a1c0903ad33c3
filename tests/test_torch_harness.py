"""The port's bench harness (bench/harness.py), its bounds
(engine/bounds.py) and the CLI's `bench` and `analyze` on the CPU vs
honours_tpu: the TSV header, each row's pressbound, press, ratio and
depress columns against the JAX harness's host rows (run_method) for
the codecs whose streams are per read, and against the port's own
runner streams for the two group codecs (drans_vbbe21_zd,
dstall_drans); svb12_zd against the JAX `--tpu` route only at
tests/test_runner.py's call; the bounds against every host codec's; the
`analyze` JSON against `python -m honours_tpu analyze`'s.  Columns
other than the times must be equal (tolerance 0); times are never
compared.  No JAX engine is compiled beyond tests/test_runner.py's."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from honours_tpu import cli as jcli
from honours_tpu.bench import harness as jharness
from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu.io import blow5 as jb
from honours_tpu_torch import cli
from honours_tpu_torch.bench import harness
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from test_torch_analysis import same
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "three-reads.blow5"
GROUP = ("drans_vbbe21_zd", "dstall_drans")
PER_READ = [m for m in runner.engine_codec_names() if m not in GROUP]


@pytest.fixture(scope="module")
def reads(fixture_reads):
    """Reads of n >= 1: fixture cuts, a read past the exception cap,
    short reads, and two stall reads (which the dstall codecs split)."""
    rng = np.random.default_rng(21)
    stall = [np.concatenate([460 + rng.integers(-4, 5, m),
                             rng.integers(300, 900, 3000)]).astype(np.int16)
             for m in (800, 2000)]
    return [fixture_reads[0][:3000], fixture_reads[1][2000:4500],
            np.tile(np.array([0, 30000], np.int16), 300),
            np.array([5], np.int16), np.array([256, 5, -3, 700], np.int16),
            rng.integers(-600, 600, 900).astype(np.int16), *stall]


@pytest.fixture(scope="module")
def src(tmp_path_factory, reads):
    """A BLOW5 of the reads (zlib records, svb-zd signals)."""
    f5 = jb.Blow5File(version=(0, 2, 0), record_press=1, signal_press=1,
                      num_read_groups=1, header=b"#\n", reads=[
                          jb.Blow5Read(read_id=f"r{i}", read_group=0,
                                       digitisation=2048.0, offset=0.0,
                                       range=1.0, sampling_rate=4000.0,
                                       signal=s, aux=b"")
                          for i, s in enumerate(reads)])
    path = tmp_path_factory.mktemp("harness") / "src.blow5"
    jb.write_blow5(str(path), f5)
    return path


def _rows(text: str):
    """TSV lines -> rows of the non-time columns (the first five)."""
    return [line.split("\t")[:5] for line in text.strip().splitlines()]


def _port_rows(path, methods):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert harness.main([str(path), "--methods", ",".join(methods),
                             "--device", "cpu"]) == 0
    return _rows(out.getvalue())


def test_header_is_the_reference():
    assert harness.HDR == jharness.HDR


@pytest.mark.parametrize("codec", runner.engine_codec_names())
def test_bound_equals_the_host_codec(codec):
    for n in (0, 1, 7, 1024, 1025, 155185):
        b = bound(codec, n)
        assert b == registry.get(codec).bound(n) and type(b) is int, n
    with pytest.raises(NotImplementedError):
        bound("no_such_codec", 5)


def test_rows_equal_the_host_rows(src, reads):
    rows = _port_rows(src, PER_READ)
    assert rows[0] == jharness.HDR.split("\t")[:5]
    out = io.StringIO()
    for m in PER_READ:
        jharness.run_method(registry.get(m), reads, out=out)
    assert rows[1:] == _rows(out.getvalue())


def test_group_codec_rows_equal_the_runner_streams(src, reads):
    rows = _port_rows(src, GROUP)[1:]
    raw = sum(2 * r.size for r in reads)
    for m, row in zip(GROUP, rows):
        press = sum(map(len, runner.press_signals(reads, m, device="cpu")))
        assert row == [m, f"{sum(bound(m, r.size) for r in reads):.1f}",
                       f"{press:.1f}", f"{raw / press:.6f}", f"{raw:.1f}"]
    assert [r[0] for r in rows] == list(GROUP)


def test_svb12_zd_equals_the_jax_engine_route(capsys):
    """tests/test_runner.py::test_harness_tpu_tsv's call, whose engine
    compile the JAX tests already make."""
    assert jharness.main([str(FIXTURE), "--tpu", "--methods",
                          "svb12_zd"]) == 0
    theirs = _rows(capsys.readouterr().out)
    assert _port_rows(FIXTURE, ["svb12_zd"]) == theirs


def test_lossless_check_raises(monkeypatch, reads):
    real = runner.depress_signals

    def corrupt(*a, **k):
        out = real(*a, **k)
        out[1] = out[1] + 1
        return out

    monkeypatch.setattr(runner, "depress_signals", corrupt)
    with pytest.raises(AssertionError, match="lossless check failed read 1"):
        harness.run_method_tpu("vbbe21_zd", reads, out=io.StringIO(),
                               device="cpu")


def test_cli_bench_and_list(src, capsys):
    assert cli.main(["bench", str(src), "--list"]) == 0
    assert capsys.readouterr().out.split() == jrunner.engine_codec_names()
    assert cli.main(["bench", str(src), "--methods", "svb_zd,vb1e2_zd",
                     "--device", "cpu"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r[0] for r in rows] == ["method", "svb_zd", "vb1e2_zd"]
    with pytest.raises(NotImplementedError):
        cli.main(["bench", str(src), "--methods", "no_such_codec",
                  "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["bench", str(src), "--methods", "svb_zd"])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["analyze", str(src)])


@pytest.mark.parametrize("per_read", [False, True])
def test_cli_analyze_equals_the_reference(src, capsys, per_read):
    opt = ["--per-read"] if per_read else []
    assert cli.main(["analyze", str(src), "--device", "cpu", *opt]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(["analyze", str(src), *opt]) == 0
    theirs = capsys.readouterr().out
    same(json.loads(ours), json.loads(theirs))
    assert ours.count("\n") == theirs.count("\n")


def test_module_entry_points_run(src):
    """python -m honours_tpu_torch bench|analyze and python -m
    honours_tpu_torch.bench.harness, as a user runs them."""
    for args in (["honours_tpu_torch", "bench", str(src), "--methods",
                  "svb12_zd", "--device", "cpu"],
                 ["honours_tpu_torch", "analyze", str(src), "--device",
                  "cpu"],
                 ["honours_tpu_torch.bench.harness", str(src), "--list"]):
        out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip()


def test_phase_timer_and_trace(tmp_path):
    """PhaseTimer accumulates and reports as honours_tpu's does (name,
    seconds, count a line, sorted by name); cuda_trace writes a Chrome
    trace of its region (here the CPU's ops)."""
    from honours_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
    from honours_tpu_torch.utils.profiling import PhaseTimer, cuda_trace

    ours, theirs = PhaseTimer(), JaxPhaseTimer()
    for timer in (ours, theirs):
        for name in ("press", "depress", "press"):
            with timer.phase(name):
                pass
    lines = ours.report().splitlines()
    assert [(ln.split("\t")[0], ln.split("\t")[2]) for ln in lines] == [
        (ln.split("\t")[0], ln.split("\t")[2])
        for ln in theirs.report().splitlines()] == [("depress", "1x"),
                                                    ("press", "2x")]
    assert all(ln.split("\t")[1].endswith("s") for ln in lines)
    with cuda_trace(str(tmp_path / "trace")):
        with ours.phase("sum", "cpu"):
            torch.arange(1000).sum()
    assert ours.counts["sum"] == 1
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("sum" in e.get("name", "") for e in events["traceEvents"])
