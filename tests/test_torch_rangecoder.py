"""The port's range coder (engine/rangecoder.py, the plain versions of
kernels D and E, reached through rangecoder_cuda.py's wrappers on CPU
tensors) vs honours_tpu/native/rangecoder.c, byte for byte in both
directions: the port's streams equal ht_rc0/rc1/rccm_encode's, the port
decodes the C's streams and the C decodes the port's, for rows of 0, 1,
7, 300 and 1,500 bytes, all-255, a ramp and random bytes (numpy, seeded),
and rows whose model-row keys repeat (tests/rc_rows.py: a run, ABAB,
ABCABC, a cycle of 5, residual-like runs).  Also SQUASH / STRETCH against
init_tables' formula, the stream cap, cut streams, offsets, the layout and
slot counts the CUDA source shares and the host's count of reused rows.
No JAX; the plain cm coder takes a few ms a byte, so rows stay short."""

import re

import numpy as np
import pytest
import rc_rows
import torch

from honours_tpu import native
from honours_tpu_torch import _build
from honours_tpu_torch.engine import rangecoder as R
from honours_tpu_torch.engine import rangecoder_cuda as RC
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ENCODE = {"o0": native.rc0_encode, "o1": native.rc1_encode,
          "cm": native.rccm_encode}
DECODE = {"o0": native.rc0_decode, "o1": native.rc1_decode,
          "cm": native.rccm_decode}


def _byte_rows():
    rng = np.random.default_rng(18)
    residual = np.minimum(rng.geometric(0.12, 1500), 255).astype(np.uint8)
    return [
        np.zeros(0, np.uint8),
        np.array([200], np.uint8),
        rng.integers(0, 256, 7).astype(np.uint8),
        np.minimum(rng.geometric(0.3, 300), 255).astype(np.uint8),
        residual,
        np.full(600, 255, np.uint8),
        (np.arange(700) % 256).astype(np.uint8),  # a ramp
        rng.integers(0, 256, 800).astype(np.uint8),  # random bytes
    ]


def _matrix(rows, width=None):
    width = width or max(max(r.size for r in rows), 1)
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        out[i, : r.size] = np.frombuffer(bytes(r), np.uint8)
    return torch.from_numpy(out)


@pytest.fixture(scope="module")
def rows():
    return _byte_rows()


@pytest.fixture(scope="module")
def port_streams(rows):
    """Each model's encode of the rows, made once."""
    n = torch.tensor([r.size for r in rows], dtype=torch.int32)
    return {m: RC.rc_encode(_matrix(rows), n, m) for m in R.MODELS}


def test_squash_stretch_are_the_c_tables():
    t = np.arange(-4096, 4096, dtype=np.float64)
    v = 4096.0 / (1.0 + np.exp(-t / 256.0))
    # the rounding never sits near a .5 edge, so no libm's exp moves it
    assert np.abs(v - np.floor(v) - 0.5).min() > 1.7e-4
    want = np.clip((v + 0.5).astype(np.int64), 1, 4095)
    assert np.array_equal(R.SQUASH, want)
    stretch = np.empty(4096, np.int64)
    j = -4096
    for p in range(1, 4096):  # init_tables' loop
        while j < 4095 and want[j + 4096] < p:
            j += 1
        stretch[p] = j
    stretch[0] = -4096
    assert np.array_equal(R.STRETCH, stretch)
    apm = [want[min((i - 16) * 256 + 4096, 8191)] << 2 for i in range(33)]
    assert R.apm_row().tolist() == apm


@pytest.mark.parametrize("model", R.MODELS)
def test_encode_equals_the_c_coder(rows, port_streams, model):
    out, length = port_streams[model]
    assert out.shape[1] == R.out_width(max(r.size for r in rows))
    for i, r in enumerate(rows):
        want = ENCODE[model](r)
        assert out[i, : length[i]].numpy().tobytes() == want, i
        assert not out[i, length[i]:].any(), i


@pytest.mark.parametrize("model", R.MODELS)
def test_decode_reads_the_c_coder_streams(rows, model):
    host = [np.frombuffer(ENCODE[model](r), np.uint8) for r in rows]
    n = torch.tensor([r.size for r in rows], dtype=torch.int32)
    N = max(r.size for r in rows)
    got = RC.rc_decode(_matrix(host), torch.zeros_like(n), n, N, model)
    assert got.shape == (len(rows), N) and got.dtype == torch.uint8
    for i, r in enumerate(rows):
        assert np.array_equal(got[i, : r.size].numpy(), r), i
        assert not got[i, r.size:].any(), i


@pytest.mark.parametrize("model", R.MODELS)
def test_c_coder_decodes_the_port_streams(rows, port_streams, model):
    out, length = port_streams[model]
    for i, r in enumerate(rows):
        stream = out[i, : length[i]].numpy().tobytes()
        assert np.array_equal(DECODE[model](stream, r.size), r), i


@pytest.mark.parametrize("model", R.MODELS)
def test_cut_streams_and_offsets_read_as_the_c_does(rows, model):
    """A stream cut short decodes as the C decodes it (bytes past the end
    read as 0), from any offset into its row, and counts past N clamp."""
    r = rows[3]
    full = ENCODE[model](r)
    cuts = [full[:k] for k in (0, 3, 9, len(full) // 2, len(full) - 1)]
    offs = [0, 5, 17, 1, 40]
    stream = _matrix([np.frombuffer(b"\xaa" * o + c, np.uint8)
                      for o, c in zip(offs, cuts)], width=len(full) + 48)
    n = torch.full((len(cuts),), r.size, dtype=torch.int32)
    got = RC.rc_decode(stream, torch.tensor(offs, dtype=torch.int32), n,
                       r.size, model)
    for i, c in enumerate(cuts):
        # the row's bytes past the cut are zero, as reads past the end
        assert np.array_equal(got[i].numpy(), DECODE[model](c, r.size)), i
    big = RC.rc_decode(stream[:1], torch.zeros(1, dtype=torch.int32),
                       torch.tensor([r.size + 50], dtype=torch.int32), 20,
                       model)
    assert np.array_equal(big[0].numpy(), DECODE[model](cuts[0], 20))


@pytest.mark.parametrize("model", R.MODELS)
def test_a_stream_past_its_cap_raises(model):
    """A row's stream is capped at n + n // 2 + slack bytes (1024, as
    native._encode sizes its buffer): with slack 0 a one-byte row's
    stream (6 bytes at least) passes it, comes back zeroed with length
    -1 from the launch, and rc_encode raises; the other rows stand."""
    data = _matrix([np.array([9], np.uint8), np.arange(40, dtype=np.uint8)])
    n = torch.tensor([1, 40], dtype=torch.int32)
    out, length = RC.rc_encode_launch(data, n, model, slack=0)
    assert length[0] == -1 and not out[0].any()
    want = ENCODE[model](np.arange(40, dtype=np.uint8))
    assert length[1] == len(want) <= 60
    assert out[1, : length[1]].numpy().tobytes() == want
    with pytest.raises(ValueError, match="would pass"):
        RC.rc_encode(data, n, model, slack=0)
    with pytest.raises(ValueError, match="model"):
        RC.rc_encode(data, n, "o2")


def _cuda_constants() -> dict:
    text = (_build.CSRC / "rangecoder.cu").read_text()
    return dict(re.findall(r"constexpr (?:long long|int) (\w+) = ([^;]+);",
                           text))


def test_layout_matches_the_cuda_source():
    """The device state the wrapper fills is the one the kernels index:
    rangecoder.cu's layout constants are rangecoder.py's, and the state a
    row (STATE_BYTES) is those cells; the plain cm model's own row starts
    as the C's cm_new."""
    consts = _cuda_constants()
    env = {}
    for name in ("APM_N", "W_CELLS", "W_INIT", "O1_CELLS", "DEV_O1S",
                 "DEV_O2", "O2_CELLS", "DEV_CM_CELLS"):
        env[name] = eval(re.sub(r"(\d)LL\b", r"\1", consts[name]), {}, env)
        assert env[name] == getattr(R, name), name
    assert R.STATE_BYTES == {"o0": 0, "o1": 2 * 65536,
                             "cm": 2 * (2 * 65536 + (1 << 24))}
    row = R.cm_small_row()
    assert (row[: R.CM_APM1] == 2048).all()
    assert (row[R.CM_APM2: R.CM_APM2 + 33] == R.apm_row()).all()


def test_slot_counts_match_the_cuda_source():
    """rangecoder_cuda.SLOTS (the host's model of the kernels' row slots,
    chip_smoke.py's reuse count) are rangecoder.cu's."""
    consts = _cuda_constants()
    assert RC.SLOTS == {"cm": (int(consts["CM_O1_SLOTS"]),
                               int(consts["CM_O2_SLOTS"]))}
    assert all(2 <= s <= 32 for v in RC.SLOTS.values() for s in v)


def test_row_reuse_counts_the_slots_hits():
    """rc_rows.row_reuse: a run of b reuses every row but those of its
    first bytes (o1 keys 0, b; o2 keys (0, 0), (b, 0), (b, b)); a cycle
    one past a slot set misses always, one within it hits from its
    second lap on."""
    run = rc_rows.aliasing_row("run", 3, 100)[None, :]
    n = np.array([100])
    assert rc_rows.row_reuse(run, n, (16, 8)) == [98 / 100, 97 / 100]
    c17 = rc_rows.cycle_row(17, 4, 170)[None, :]
    # o1 keys: 0, then the 17 bytes in turn (a miss each lap past 16);
    # o2 pairs: period 17 as well, 8 slots
    assert rc_rows.row_reuse(c17, np.array([170]), (16, 8)) == [0.0, 0.0]
    assert rc_rows.row_reuse(c17, np.array([170]), (32,)) == [(170 - 18) / 170]
    assert rc_rows.lru_hits([1, 2, 1, 3, 2, 1], 2) == 1


@pytest.mark.parametrize("model", R.MODELS)
@pytest.mark.parametrize("pattern", rc_rows.PATTERNS)
def test_aliasing_rows_match_the_c_coder(pattern, model):
    """A row whose model-row keys repeat (rc_rows.PATTERNS; 600 bytes,
    cm 300: its plain coder takes a few ms a byte, and 300 still passes
    its 16 o1 and 8 o2 row slots many times over): the plain encode
    gives the C's stream, the plain decode gives the row back from the
    C's stream, and the C decodes the plain stream."""
    r = rc_rows.aliasing_row(pattern, 22, 300 if model == "cm" else 600)
    want = ENCODE[model](r)
    n = torch.tensor([r.size], dtype=torch.int32)
    out, length = RC.rc_encode(_matrix([r]), n, model)
    assert out[0, : length[0]].numpy().tobytes() == want
    assert not out[0, length[0]:].any()
    got = RC.rc_decode(_matrix([np.frombuffer(want, np.uint8)]),
                       torch.zeros_like(n), n, r.size, model)
    assert np.array_equal(got[0].numpy(), r)
    assert np.array_equal(DECODE[model](want, r.size), r)
