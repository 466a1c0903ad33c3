"""The port's runner (press_signals / depress_signals) vs honours_tpu's
runner and registry codec, the one-row path for capped-overflow and
per-read rows, and the port's isolation from JAX.  Stream bytes and
samples must be equal (tolerance 0)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from honours_tpu.codecs import base as registry
from honours_tpu.engine import runner as jrunner
from honours_tpu_torch.engine import runner

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAME = "drans_vbbe21_zd"


@pytest.fixture(scope="module")
def mixed_reads(fixture_reads):
    """tests/test_runner.py's mixed read set."""
    rng = np.random.default_rng(21)
    return [
        fixture_reads[0][:3000],
        rng.integers(400, 700, 1500).astype(np.int16),
        np.array([256, 5, -3, 700, 0, 0, 0, 1], np.int16),
        np.zeros(5, np.int16),
        fixture_reads[1][2000:4500],
        np.tile(np.array([0, 30000], np.int16), 300),  # nex > emax row
        np.array([5], np.int16),
        rng.integers(-600, 600, 900).astype(np.int16),
        rng.integers(450, 520, 2048).astype(np.int16),
    ]


@pytest.fixture(scope="module")
def pressed(mixed_reads):
    return runner.press_signals(mixed_reads, NAME, max_b=4, device="cpu")


def test_press_matches_jax_runner_and_registry(mixed_reads, pressed):
    assert pressed == jrunner.press_signals_tpu(mixed_reads, NAME, max_b=4)
    # the capped-overflow row went through the one-row path: host bytes
    codec = registry.get(NAME)
    assert pressed[5] == codec.press(mixed_reads[5])


def test_streams_cross_decode(mixed_reads, pressed):
    lens = [s.size for s in mixed_reads]
    ours = runner.depress_signals(pressed, lens, NAME, max_b=4, device="cpu")
    theirs = jrunner.depress_signals_tpu(pressed, lens, NAME, max_b=4)
    for i, s in enumerate(mixed_reads):
        assert np.array_equal(ours[i], s), i
        assert np.array_equal(theirs[i], s), i
    # per-read host streams (G <= 1) decode row by row in the port
    codec = registry.get(NAME)
    host = [codec.press(np.asarray(s, np.int16)) for s in mixed_reads]
    back = runner.depress_signals(host, lens, NAME, max_b=4, device="cpu")
    for i, s in enumerate(mixed_reads):
        assert np.array_equal(back[i], s), i


def test_fixture_ratio_equals_jax(fixture_reads):
    ours = runner.press_signals(fixture_reads, device="cpu")
    theirs = jrunner.press_signals_tpu(fixture_reads, NAME)
    assert ours == theirs
    raw = sum(2 * s.size for s in fixture_reads)
    ratio = raw / sum(len(s) for s in ours)
    assert ratio == raw / sum(len(s) for s in theirs) and ratio > 2.99
    back = runner.depress_signals(ours, [s.size for s in fixture_reads],
                                  device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(back, fixture_reads))


def test_unported_codec_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.press_signals([np.zeros(3, np.int16)], "srans2_vbbe21_zd",
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.depress_signals([b""], [3], "vbbe21_zd", device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.press_signals([np.zeros(3, np.int16)])
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.depress_signals([b""], [3])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_reference():
    files = sorted((ROOT / "honours_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "honours_tpu"), (f, mod)


def test_cpu_press_loads_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from honours_tpu_torch.engine.runner import press_signals, "
        "depress_signals\n"
        "r = [np.arange(300, dtype=np.int16), np.array([7], np.int16)]\n"
        "s = press_signals(r, device='cpu')\n"
        "o = depress_signals(s, [300, 1], device='cpu')\n"
        "assert all((a == b).all() for a, b in zip(r, o))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'honours_tpu')]\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
