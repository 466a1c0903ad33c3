"""Kernel A's design (csrc/segment.cu), as a numpy model of its phases at
the kernel's own constants (tests/stall_rows.py): chunk sums and parity
tables over binades, group tables, the composition with its walked
chunks, the in-band masks, each chunk's map of the run machine's 7
control states and their composition, each chunk's attempt ends with the
running maxima that complete the ones begun in earlier chunks, and the
ends taken in order with the stop at nsegs == 2.  The model is held to the plain version
(segment_cuda.find_stall_plain) and to the C oracle
honours_tpu.native.find_stall on every row of tests/stall_rows.py, and
its two float32 sums on their own to np.add.accumulate(..., float32),
the serial sum; all equal (tolerance 0).  The rows are the ones
tests/test_torch_gpu.py runs through the kernel on the card.  No JAX
function is called."""

import re

import numpy as np
import pytest
import torch

import stall_rows as R
from honours_tpu import native
from honours_tpu_torch._build import CSRC
from honours_tpu_torch.segment import segment_cuda
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

NAMES = R.row_names()


def _plain(row):
    ex, st, ln = segment_cuda.find_stall_plain(
        torch.from_numpy(row[None]), torch.tensor([row.size],
                                                  dtype=torch.int32))
    return bool(ex[0]), int(st[0]), int(ln[0])


def test_constants_match_source():
    """segment_cuda's THREADS, CHUNK, TILE, GROUP and GUESS, which the
    model reads, are segment.cu's."""
    text = (CSRC / "segment.cu").read_text()
    ints = dict(re.findall(
        r"constexpr int (THREADS|CHUNK|GROUP|MAX_ERR|WINDOW|SEG_DIST) = "
        r"(\d+);", text))
    assert int(ints["THREADS"]) == segment_cuda.THREADS == R.THREADS
    assert int(ints["CHUNK"]) == segment_cuda.CHUNK == R.CHUNK
    assert int(ints["GROUP"]) == segment_cuda.GROUP == R.GROUP
    assert "constexpr int TILE = THREADS * CHUNK;" in text
    assert segment_cuda.TILE == R.TILE == R.THREADS * R.CHUNK
    assert (int(ints["MAX_ERR"]), int(ints["WINDOW"]),
            int(ints["SEG_DIST"])) == (R.MAX_ERR, R.WINDOW, R.SEG_DIST)
    guess = re.search(r"constexpr double GUESS = (\d+)\.0 / (\d+)\.0;", text)
    assert int(guess[1]) / int(guess[2]) == segment_cuda.GUESS == R.GUESS


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_plain_and_c(name):
    """(exists, start, length) of the model, the plain version and the C
    oracle (which truncates start and length to uint16)."""
    row = R.stall_row(name)
    got = R.model_find_stall(row)
    assert got == _plain(row)
    ex, st, ln = native.find_stall(row)
    assert (got[0], got[1] & 0xFFFF, got[2] & 0xFFFF) == (ex, st, ln)


@pytest.mark.parametrize("name", NAMES)
def test_model_sums_are_serial(name):
    """Both composed sums equal the serial float32 sums."""
    row = R.stall_row(name)
    if row.size == 0:
        return
    a = R.clamped(row)
    s1 = R.model_sum(a, 1)
    assert s1 == np.add.accumulate(a, dtype=np.float32)[-1]
    mean = np.float32(s1 / np.float32(a.size))
    t = R.terms(a, 2, mean)
    assert R.model_sum(t, 2) == np.add.accumulate(t, dtype=np.float32)[-1]


def test_rows_take_every_path():
    """Across the rows the composition takes group steps, chunk steps and
    walks, the run machine crosses several tiles and keeps ends that can
    emit; the exact prefix crossing 2^24 at a chunk end takes no walk in
    sum 1, one sample later it does."""
    total = {}
    for name in NAMES:
        st = {}
        R.model_find_stall(R.stall_row(name), st)
        for k, v in st.items():
            total[k] = total.get(k, 0) + v
    for k in ("sum1_group", "sum1_chunk", "sum1_walked", "sum2_group",
              "sum2_chunk", "sum2_walked", "jumps", "kept"):
        assert total[k] > 0, k
    assert total["tiles"] > len(NAMES)
    at, beside = {}, {}
    R.model_find_stall(R.stall_row("sum_2^24_at_chunk"), at)
    R.model_find_stall(R.stall_row("sum_2^24_at_chunk+1"), beside)
    assert at["sum1_walked"] == 0 and beside["sum1_walked"] == 1


def test_wrong_guess_costs_walks_only(monkeypatch):
    """No result rests on the guess of the binade: with tables for the
    binades of P / 64 every chunk misses and is walked, and both sums are
    still the serial ones."""
    row = R.stall_row("sum_2^26_at_tile-1")
    a = R.clamped(row)
    want = np.add.accumulate(a, dtype=np.float32)[-1]
    monkeypatch.setattr(R, "GUESS", 1 / 64)
    st = {}
    assert R.model_sum(a, 1, st) == want
    assert st["sum1_walked"] >= st["sum1_misses"] > 0


@pytest.mark.parametrize("name", ["6th_oob_at_chunk+0", "6th_oob_at_tile-1",
                                  "excursions_to_tile", "second_at_49",
                                  "open_across_a_whole_tile"])
def test_band_rows_hold_their_mask(name):
    """The rows built on alternating extremes have 460 +- 4 in band and
    every extreme out of band."""
    row = R.stall_row(name)
    a = R.clamped(row)
    _, top, bot = R.thresholds(a)
    inb = (a < top) & (a > bot)
    mid = (row >= 400) & (row <= 500)
    assert np.array_equal(inb, mid) and mid.any() and not mid.all()


def _control_states(inb):
    """The C's (inseg, err) before each sample, as the 7 control states
    (0 FREE, 1 + err inside an attempt), by a serial walk."""
    out = np.empty(inb.size + 1, np.int64)
    inseg = err = 0
    for i, b in enumerate(inb.tolist()):
        out[i] = 1 + err if inseg else 0
        if b:
            inseg = 1
        elif inseg and err < R.MAX_ERR:
            err += 1
        elif inseg:
            inseg = err = 0
    out[-1] = 1 + err if inseg else 0
    return out


@pytest.mark.parametrize("name", ["fixture1", "open_across_a_whole_tile",
                                  "excursions_to_chunk", "u16start"])
def test_chunk_maps_compose_to_the_serial_states(name):
    """Each chunk's map of the 7 control states, composed in chunk order
    from FREE, gives the serial machine's state at every chunk start (the
    block scan of step 5), across tiles too."""
    row = R.stall_row(name)
    a = R.clamped(row)
    _, top, bot = R.thresholds(a)
    inb = (a < top) & (a > bot)
    want = _control_states(inb)
    st = R.FREE
    for T0 in range(0, inb.size, R.TILE):
        maps = R.chunk_maps(inb[T0: T0 + R.TILE])
        for t, f in enumerate(maps):
            assert st == want[T0 + t * R.CHUNK], (T0, t)
            st = f[st]
    assert st == want[-1]
