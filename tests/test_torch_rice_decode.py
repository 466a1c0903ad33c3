"""The port's rice decode (the plain version of kernel B, which the CPU
route runs, and the rice_vb*_zd decode of the runner) vs honours_tpu's
host decoder, codecs.rice.rice_decode and RiceVbZdCodec.depress, the
JAX package's only rice decode.  Values and samples must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

from honours_tpu.codecs import base as registry
from honours_tpu.codecs.rice import rice_decode, rice_encode, rice_find_k
from honours_tpu.codecs.vb import exblock_len
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.rice_cuda import rice_decode_plain
from test_torch_runner import mixed_reads  # noqa: F401  (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

RICE = ["rice_vbe21_zd", "rice_vbbe21_zd", "rice_vbsbe21_zd",
        "rice_vbsse21_zd"]


def _k(blob: bytes) -> int:
    return (blob[0] & 1) << 2 | (blob[0] >> 1 & 1) << 1 | (blob[0] >> 2 & 1)


def byte_rows(seed=0):
    """Residual byte rows whose rice streams take every k in 0..7, runs
    of 255 under k = 0 and 1 (unary runs of 255 and 127 ones), all-255
    rows, one value and none."""
    rng = np.random.default_rng(seed)
    rows = [rng.geometric(1 / s, 700).clip(1, 256).astype(np.int64) - 1
            for s in (1.2, 2, 4, 8, 16, 32, 64, 110, 200)]
    for k_lo in (0, 1, 2):
        r = rng.integers(0, 1 << k_lo, 300)
        r[::150] = 255
        rows.append(r)
    rows += [np.full(500, 255), np.full(33, 255), np.array([200]),
             np.array([0]), np.zeros(0, np.int64)]
    return [r.astype(np.uint8) for r in rows]


def test_byte_rows_take_every_k():
    ks = {rice_find_k(r) for r in byte_rows() if r.size}
    assert ks == set(range(8))


@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_plain_decode_matches_host(pad):
    """Each row's stream starts `pad` + (row % 4) bytes into its row,
    with garbage before it and zeros after; blobs of every length mod 4,
    so some end on a word edge."""
    rows = byte_rows()
    blobs = [rice_encode(r) for r in rows]
    assert {len(b) % 4 for b in blobs} == {0, 1, 2, 3}
    M = max(len(b) for b in blobs) + pad + 3
    st = np.zeros((len(rows), M), np.uint8)
    off = np.zeros(len(rows), np.int32)
    for i, b in enumerate(blobs):
        o = pad + i % 4
        st[i, :o] = 0xFF
        st[i, o: o + len(b)] = np.frombuffer(b, np.uint8)
        off[i] = o
    cnt = np.array([r.size for r in rows], np.int32)
    N = 701
    out = rice_decode_plain(torch.from_numpy(st), torch.from_numpy(off),
                            torch.from_numpy(cnt), N).numpy()
    assert out.shape == (len(rows), N) and out.dtype == np.uint8
    for i, (r, b) in enumerate(zip(rows, blobs)):
        assert np.array_equal(out[i, : r.size], r), (i, _k(b))
        assert np.array_equal(rice_decode(b, r.size), r), i
        assert not out[i, r.size:].any(), i


def test_plain_decode_in_row_groups(monkeypatch):
    """Rows past the table budget decode in groups, with the same
    values as one group."""
    from honours_tpu_torch.engine import rice_cuda

    rows = byte_rows()
    blobs = [rice_encode(r) for r in rows]
    st = np.zeros((len(rows), max(map(len, blobs))), np.uint8)
    for i, b in enumerate(blobs):
        st[i, : len(b)] = np.frombuffer(b, np.uint8)
    args = (torch.from_numpy(st), torch.zeros(len(rows), dtype=torch.int32),
            torch.tensor([r.size for r in rows], dtype=torch.int32), 700)
    whole = rice_decode_plain(*args)
    monkeypatch.setattr(rice_cuda, "PLAIN_TABLE_BYTES", 1)
    assert torch.equal(rice_decode_plain(*args), whole)


def test_plain_decode_of_cut_streams_reads_zeros():
    """A stream cut short reads zeros past its row: values past the cut
    decode as 0 with no fault; counts are clamped to [0, N]."""
    r = np.full(40, 200, np.uint8)
    b = rice_encode(r)
    cut = np.frombuffer(b[: len(b) // 2], np.uint8)[None, :].copy()
    cut = torch.from_numpy(cut)
    zero = torch.zeros(1, dtype=torch.int32)
    out = rice_decode_plain(cut, zero, torch.tensor([40]).int(), 40)
    assert out.shape == (1, 40)
    assert torch.equal(out, rice_decode_plain(cut, zero,
                                              torch.tensor([400]).int(), 40))
    far = rice_decode_plain(cut, torch.tensor([99]).int(),
                            torch.tensor([5]).int(), 8)
    assert far.shape == (1, 8) and not far.any()


@pytest.fixture(scope="module")
def reads(mixed_reads):
    """The mixed reads plus reads whose residual bytes take k = 0 with
    runs of 255 (one step of -128 in a flat read), k = 7, all 255 (steps
    of -128 throughout), and one sample."""
    rng = np.random.default_rng(12)
    flat = np.full(1200, 300, np.int64)
    flat[::600] = 172
    walk7 = np.cumsum(rng.integers(64, 128, 900) * rng.choice([-1, 1], 900))
    return mixed_reads + [
        flat.astype(np.int16),
        (walk7 % 20000).astype(np.int16),
        (-128 * np.arange(200)).astype(np.int16),
        np.array([-9], np.int16),
    ]


@pytest.mark.parametrize("codec", RICE)
def test_runner_depress_matches_host(reads, codec):
    """The port decodes its own streams and the host codec's, each to
    what the host codec decodes (tests/test_torch_runner_rice.py decodes
    the JAX runner's, which compile there)."""
    host = registry.get(codec)
    lens = [s.size for s in reads]
    ours = runner.press_signals(reads, codec, max_b=4, device="cpu")
    hstreams = [host.press(s) for s in reads]
    for streams in (ours, hstreams):
        out = runner.depress_signals(streams, lens, codec, max_b=4,
                                     device="cpu")
        for i, s in enumerate(reads):
            want = host.depress(streams[i], s.size)
            assert out[i].dtype == np.int16
            assert np.array_equal(out[i], want) and np.array_equal(
                out[i], s), i
    # the flat, the k = 7 and the all-255 reads' rice blobs
    kind = codec[len("rice_"):-len("_zd")]
    assert [_k(st[2 + exblock_len(st, 2, kind):])
            for st in ours[-4:-1]] == [0, 7, 7]
