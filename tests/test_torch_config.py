"""The port's utils/config.py vs honours_tpu/utils/config.py (its eight
fields; HTPU_FLATS_STEP reaching flat_uint_submin is held in
tests/test_torch_flats.py), the HTPU_ZLIB_LEVEL / HTPU_ZSTD_LEVEL /
HTPU_BZIP2_LEVEL / HTPU_LZMA2_PRESET overrides reaching the port's byte
layers (engine/layers.py), and the HTPU_STALL_THRESHOLD /
HTPU_STALL_MARGIN / HTPU_DSTALL_THRESHOLD overrides reaching the port's
stall splits: under each setting the
port's _split_batch and its dstall_srans2 and dstall_drans streams equal
the JAX package's host codecs (codecs/dstall.py _split and press,
through the C segmenter; codecs/dstall_drans.py), which
tests/test_dstall.py and tests/test_dstall_drans.py hold equal to the
JAX engines, and the stall-fz split (engine/stall_fz.py split_batch)
equals codecs/stall.py's (native.find_stall, its threshold and margin).
Both packages' cached configs are reset for each case.  No JAX engine is
compiled.  Splits and streams must be equal (tolerance 0)."""

import dataclasses
import struct

import numpy as np
import pytest
import torch

import honours_tpu.codecs.dstall as jdstall
from honours_tpu import native
import honours_tpu.codecs.dstall_drans as dd
import honours_tpu.utils.config as jconfig
from honours_tpu.codecs.base import get as get_codec
import honours_tpu_torch.utils.config as tconfig
from honours_tpu_torch.engine import dstall_drans as tdd
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.dstall import _split_batch, press_dstall_batch
from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
from honours_tpu_torch.engine.stall_fz import split_batch
from honours_tpu_torch.synth import stall_set
from stall_rows import knife_cases
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TABS = canned_o1_device_tables("cpu")
ENV = [f"HTPU_{f.name.upper()}" for f in dataclasses.fields(jconfig.Config)]

#: settings under which the split moves: a wider margin (every split's
#: start and length), a threshold above the 800-sample stall and the
#: knife-edge stalls but below the 2,000-sample one, and one above the
#: stall set's 30,000-sample stall
SETTINGS = {
    "defaults": {},
    "margin60": {"HTPU_STALL_MARGIN": "60"},
    "threshold1000": {"HTPU_STALL_THRESHOLD": "1000"},
    "threshold40000_margin5": {"HTPU_STALL_THRESHOLD": "40000",
                               "HTPU_STALL_MARGIN": "5"},
}
#: and for the stall-fz splits, dstall_fz_1500's threshold below the
#: stall set's and the 800- and 2,000-sample stalls
FZ_SETTINGS = {**SETTINGS,
               "dstall_threshold500": {"HTPU_DSTALL_THRESHOLD": "500"}}


def _stall_signal(rng, n_stall, n_rest=3000):
    """tests/test_dstall.py's read: a flat stall, then active signal."""
    return np.concatenate([460 + rng.integers(-4, 5, n_stall),
                           rng.integers(300, 900, n_rest)]).astype(np.int16)


@pytest.fixture(scope="module")
def reads(fixture_reads):
    """Reads of at most 4096 samples: fixture cuts, stall reads (which
    dstall_srans2 splits at the defaults), knife-edge reads."""
    rng = np.random.default_rng(21)
    return ([fixture_reads[0][:4096], fixture_reads[1][:4000],
             fixture_reads[2][:3000], _stall_signal(rng, 800),
             _stall_signal(rng, 2000, 1000)]
            + [s for _, s in knife_cases() if s.size < 4096])


@pytest.fixture(scope="module")
def stalls():
    """The stall set's first four reads (a 30,000-sample stall each)."""
    return stall_set(0)[:4]


def _rows(reads):
    L = max(r.size for r in reads)
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    n = np.array([r.size for r in reads], np.int32)
    return torch.from_numpy(sig), torch.from_numpy(n)


def _use(monkeypatch, env: dict):
    """Set the environment and drop both packages' cached configs."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jconfig, "_CONFIG", None)
    monkeypatch.setattr(tconfig, "_CONFIG", None)


def test_defaults_equal_the_reference(monkeypatch):
    _use(monkeypatch, {})
    ours = dataclasses.asdict(tconfig.Config.default())
    theirs = dataclasses.asdict(jconfig.Config.default())
    assert ours == {k: theirs[k] for k in ours}
    cfg = tconfig.get_config()
    assert tconfig.get_config() is cfg
    assert (cfg.stall_threshold, cfg.dstall_threshold,
            cfg.stall_margin, cfg.flats_step) == (140, 1500, 20, 64)
    assert (cfg.zlib_level, cfg.zstd_level, cfg.bzip2_level,
            cfg.lzma2_preset) == (-1, 1, 9, 6)


def test_every_field_parses_like_the_reference(monkeypatch):
    """Every HTPU_* variable set: the port's fields take the values the
    JAX Config takes; a value that is no integer raises in both."""
    env = {k: str(-3 + 7 * i) for i, k in enumerate(ENV)}
    _use(monkeypatch, env)
    ours = dataclasses.asdict(tconfig.Config.default())
    theirs = dataclasses.asdict(jconfig.Config.default())
    assert list(ours) == ["zlib_level", "zstd_level", "bzip2_level",
                          "lzma2_preset", "stall_threshold",
                          "dstall_threshold", "stall_margin", "flats_step"]
    assert ours == {k: theirs[k] for k in ours}
    assert ours == {k: int(env[f"HTPU_{k.upper()}"]) for k in ours}
    monkeypatch.setenv("HTPU_STALL_MARGIN", "twenty")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            mod.Config.default()


#: a setting of each layer level: the layer's bytes move under it
LAYER_SETTINGS = {
    "zlib_level": ("zlib_uint_zd", {"HTPU_ZLIB_LEVEL": "9"}),
    "zstd_level": ("zstd_vbbe21_zd", {"HTPU_ZSTD_LEVEL": "19"}),
    "bzip2_level": ("bzip2_svb12_zd", {"HTPU_BZIP2_LEVEL": "1"}),
    "lzma2_preset": ("fast_lzma2_uint_zd", {"HTPU_LZMA2_PRESET": "0"}),
}


@pytest.mark.parametrize("field", sorted(LAYER_SETTINGS))
def test_layer_levels_reach_the_layers(monkeypatch, reads, field):
    """Under HTPU_ZLIB_LEVEL, HTPU_ZSTD_LEVEL, HTPU_BZIP2_LEVEL and
    HTPU_LZMA2_PRESET the port's layer compresses its inner stream at that
    level: its streams differ from the defaults' and equal the library's
    at the setting (zlib's and bzip2's equal the host codecs', which read
    the level at each press; the JAX zstd and LZMA2 layers take theirs at
    import) and decode back."""
    import bz2
    import lzma
    import zlib

    from honours_tpu_torch.engine import layers

    codec, env = LAYER_SETTINGS[field]
    if "zstd" in codec:
        zstandard = pytest.importorskip("zstandard")
    layer, inner, with_nin = layers.COMPOSED[codec]
    cut = [r[:3000] for r in reads[:3]]
    _use(monkeypatch, {})
    default = runner.press_signals(cut, codec, device="cpu")
    _use(monkeypatch, env)
    level = int(next(iter(env.values())))
    assert getattr(tconfig.get_config(), field) == level
    ours = runner.press_signals(cut, codec, device="cpu")
    assert ours != default
    press = {
        "zlib": lambda b: zlib.compress(b, level),
        "zstd": lambda b: zstandard.ZstdCompressor(level=level).compress(b),
        "bzip2": lambda b: bz2.compress(b, level),
        "fast_lzma2": lambda b: lzma.compress(
            b, format=lzma.FORMAT_RAW,
            filters=[{"id": lzma.FILTER_LZMA2, "preset": level}]),
    }[layer]
    inner_streams = runner.press_signals(cut, inner, device="cpu")
    assert ours == [press(struct.pack("<I", r.size) + s if with_nin else s)
                    for r, s in zip(cut, inner_streams)]
    if layer in ("zlib", "bzip2"):
        assert ours == [get_codec(codec).press(r) for r in cut]
    back = runner.depress_signals(ours, [r.size for r in cut], codec,
                                  device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(back, cut))


@pytest.mark.parametrize("setting", SETTINGS)
def test_split_equals_host_split(monkeypatch, reads, stalls, setting):
    _use(monkeypatch, SETTINGS[setting])
    for batch in (reads, stalls):
        ok, start, length = _split_batch(*_rows(batch))
        assert list(zip(ok.tolist(), start.tolist(), length.tolist())) == [
            tuple(jdstall._split(x)) for x in batch]


def _host_fz_split(x, threshold: int):
    """codecs/stall.py _stall_press's split of one read."""
    exists, start, length = native.find_stall(x)
    if length < threshold or not exists:
        return (False, 0, 0)
    margin = jconfig.get_config().stall_margin
    return (True, start + margin, length - 2 * margin)


@pytest.mark.parametrize("setting", FZ_SETTINGS)
def test_stall_fz_split_equals_host_split(monkeypatch, reads, stalls,
                                          setting):
    """rccm_svbbe21_zd's and dstall_fz's split (stall_threshold) and
    dstall_fz_1500's (dstall_threshold) follow the settings as
    codecs/stall.py's do."""
    _use(monkeypatch, FZ_SETTINGS[setting])
    cfg = jconfig.get_config()
    for threshold in (cfg.stall_threshold, cfg.dstall_threshold):
        for batch in (reads, stalls):
            ok, start, length = split_batch(*_rows(batch), threshold)
            assert list(zip(ok.tolist(), start.tolist(),
                            length.tolist())) == [
                _host_fz_split(x, threshold) for x in batch]


def _split_flags(streams):
    return [s[0] for s in streams]


@pytest.mark.parametrize("setting", SETTINGS)
def test_dstall_srans2_streams_equal_host(monkeypatch, reads, setting):
    _use(monkeypatch, {})
    at_defaults = [get_codec("dstall_srans2").press(x) for x in reads]
    _use(monkeypatch, SETTINGS[setting])
    host = [get_codec("dstall_srans2").press(x) for x in reads]
    if setting != "defaults":
        assert host != at_defaults  # the setting moves some split
    sig, n = _rows(reads)
    st, sl = press_dstall_batch(sig, n, TABS, sig.shape[1])
    assert [st[i, : int(sl[i])].numpy().tobytes()
            for i in range(len(reads))] == host
    assert runner.press_signals(reads, "dstall_srans2", device="cpu") == host


def test_dstall_drans_streams_equal_host(monkeypatch, reads):
    """dstall_drans shares _split_batch: under a wider margin its streams
    follow the host codec's too."""
    _use(monkeypatch, SETTINGS["margin60"])
    part = reads[:5]
    sig, n = _rows(part)
    st, sl = tdd.press_dstall_drans_batch(sig, n, TABS, sig.shape[1])
    host = dd.dstall_drans_press_reads(part)
    assert [st[i, : int(sl[i])].numpy().tobytes()
            for i in range(len(part))] == host
    assert any(_split_flags(host))
