"""flac in the port (engine/flac.py: the batched press over
engine/bits.py pack_fields_lsb and kernel 1, and kernel N's plain
version, engine/flac_cuda.py flac_decode_plain) vs honours_tpu's host
codec (codecs/flac.py FlacCodec): the streams equal the host's press
byte for byte for every read, n = 0 included, and both decodes give the
reads back from either package's streams.  The reads: every length
around the 4,096-sample blocks (0-5, 127-129, 4,095-4,097, 8,193),
full-range samples (verbatim blocks), a flat block with one spike of
20,000 (unary runs of thousands of ones), a block of varied content,
ramps, walks of several steps, the main-path fixture reads.  The plain
decode is also held to a row-by-row numpy model of the host's walk
(tests/block_rows.py flac_decode_np) on cut streams (a byte past a row
reads as 0), headers the press never writes and unary runs longer than
the plain version's first window and than the row, and on kernel N's
edge streams (block_rows.flac_edge_rows).  The press's k
choice equals the host's _best_k on random blocks (its integer mean is
the host's float mean truncated).  Bytes and samples must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

import block_rows
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.codecs.flac import _best_k as host_best_k
from honours_tpu.codecs.flac import _fixed_residual, _zigzag64
from honours_tpu_torch.engine import runner
from honours_tpu_torch.engine.bounds import bound
from honours_tpu_torch.engine.flac import (
    _best_k,
    depress_flac_batch,
    press_flac_batch,
)
from honours_tpu_torch.engine.flac_cuda import (
    WINDOW,
    flac_decode,
    flac_decode_plain,
)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

HOST = get_codec("flac")


def _round(reads):
    ours = runner.press_signals(reads, "flac", device="cpu")
    assert ours == [HOST.press(r) for r in reads]
    back = runner.depress_signals(ours, [r.size for r in reads], "flac",
                                  device="cpu")
    for r, b in zip(reads, back):
        assert b.dtype == np.int16 and np.array_equal(b, r)
    return ours


@pytest.mark.parametrize("seed", [0, 1])
def test_streams_equal_the_host_codec(seed):
    ours = _round(block_rows.block_reads(seed))
    assert ours[0] == b""


def test_fixture_reads(fixture_reads):
    """The three main-path fixture reads; the host decodes the port's
    streams."""
    ours = _round(list(fixture_reads))
    for r, s in zip(fixture_reads, ours):
        assert np.array_equal(HOST.depress(s, r.size), r)


def test_verbatim_and_spike_blocks():
    """Full-range samples give verbatim blocks (mode 15); the spike's
    block is coded with a predictor whose unary runs pass 1,000 ones."""
    rng = np.random.default_rng(3)
    noise = rng.integers(-32768, 32768, 4096).astype(np.int16)
    spike = block_rows.spike_read()
    s_noise, s_spike = _round([noise, spike])
    assert s_noise[0] == 15 and len(s_noise) == 1 + 2 * 4096
    order, k = s_spike[0], s_spike[1]
    assert order <= 4
    z = _zigzag64(_fixed_residual(spike, order))
    assert int((z >> np.uint64(k)).max()) > 1000


@pytest.mark.parametrize("L", [4097, 8192, 12289])
def test_batched_press_and_depress_at_several_widths(L):
    """press_flac_batch / depress_flac_batch on one bucket at widths no
    multiple of the block and one: the host's streams, zeros past n."""
    reads = [r for r in block_rows.block_reads(5) if r.size <= 4097]
    want = [HOST.press(r) for r in reads]
    sig, n = block_rows.pad_rows(reads, L)
    st, sl = press_flac_batch(torch.from_numpy(sig), torch.from_numpy(n))
    assert [st[i, : int(sl[i])].numpy().tobytes()
            for i in range(len(n))] == want
    out = depress_flac_batch(torch.from_numpy(block_rows.stream_rows(want)),
                             torch.from_numpy(n), L)
    assert out.shape == (len(reads), L) and out.dtype == torch.int16
    assert np.array_equal(out.numpy(), sig)


def test_k_choice_equals_the_host():
    """3,000 random blocks (orders 0-4, lengths 1-4,096, full-range,
    walk and small samples): the press's k and Rice bits are _best_k's,
    with k0 from the integer mean."""
    rng = np.random.default_rng(11)
    for trial in range(6):
        zs, ks, bits = [], [], []
        for _ in range(500):
            n = int(rng.integers(1, 4097))
            kind = trial % 3
            x = (rng.integers(-32768, 32768, n) if kind == 0 else
                 np.cumsum(rng.integers(-300, 301, n)) if kind == 1 else
                 rng.integers(-3, 4, n)).astype(np.int16)
            o = int(rng.integers(0, min(5, n)))
            z = _zigzag64(_fixed_residual(x, o))
            k = host_best_k(z)
            zs.append(z)
            ks.append(k)
            bits.append(int((z >> np.uint64(k)).sum()) + z.size * (1 + k))
        w = max(z.size for z in zs)
        zt = torch.zeros((1, len(zs), w), dtype=torch.int64)
        for i, z in enumerate(zs):
            zt[0, i, : z.size] = torch.from_numpy(z.astype(np.int64))
        cnt = torch.tensor([[z.size for z in zs]])
        k, b = _best_k(zt, cnt)
        assert k[0].tolist() == ks and b[0].tolist() == bits


def _plain_and_model(rows, n, L):
    got = flac_decode_plain(torch.from_numpy(rows), torch.from_numpy(n), L)
    assert got.shape == (rows.shape[0], L) and got.dtype == torch.int16
    for b in range(rows.shape[0]):
        want = block_rows.flac_decode_np(rows[b], int(n[b]), L)
        assert np.array_equal(got[b].numpy(), want), b
    return got


def test_plain_decode_equals_the_model_on_cut_streams():
    """Streams of a three-block read cut at bytes 0-3, inside a warm-up,
    inside the first block's Rice bits and at the second block's header:
    each decodes as the model reads it, the missing bytes as 0."""
    rng = np.random.default_rng(4)
    read = np.concatenate([block_rows.walk(rng, 4096, 30),
                           rng.integers(-32768, 32768, 4096),
                           block_rows.walk(rng, 1000, 5)]).astype(np.int16)
    s = HOST.press(read)
    assert s[0] <= 4
    first = 2 + 2 * s[0]
    cuts = [s[:m] for m in (0, 1, 2, 3, first - 1, first + 5, first + 700)]
    rows = block_rows.stream_rows(cuts)
    _plain_and_model(rows, np.full(len(cuts), read.size, np.int32), 9300)


def test_plain_decode_equals_the_model_on_odd_headers():
    """Headers the press never writes end a row's walk (mode 5-14, k 31,
    an order not below its block's length), a row of 0xFF (mode 255),
    zero rows (mode 0, k 0: samples 0), a unary run of 72,000 ones (past
    the plain version's first window) and one that runs off the row's
    end, and counts 0, 1 and past L."""
    rng = np.random.default_rng(6)
    M = 12000
    rows = np.zeros((9, M), np.uint8)
    rows[0, :4] = [7, 3, 1, 2]
    rows[1, :2] = [1, 31]
    rows[2, :12] = [4, 2, 5, 0, 6, 0, 7, 0, 8, 0, 255, 0]
    rows[3] = 0xFF
    rows[5, :2] = [0, 0]
    rows[5, 2: 2 + 9000] = 0xFF  # 72,000 ones, then zeros
    rows[6, :2] = [2, 3]
    rows[6, 2:6] = [1, 0, 2, 0]
    rows[6, 6:] = 0xFF  # a run to the row's end and past it
    rows[7] = rng.integers(0, 256, M).astype(np.uint8)
    rows[7, :2] = [1, 4]
    rows[8, :3] = [15, 1, 2]
    n = np.array([100, 100, 3, 50, 0, 5000, 200, 4200, 6000], np.int32)
    assert 9000 > WINDOW
    out = _plain_and_model(rows, n, 6000)
    assert not out[0].any() and not out[3].any() and not out[4].any()
    assert out[2, :3].tolist() == [0, 0, 0]


def test_plain_decode_equals_the_model_on_random_rows():
    """Random rows behind valid and hand-made headers (orders 0-4, k up to
    30) at a few lengths."""
    rng = np.random.default_rng(7)
    B, M = 12, 3000
    rows = rng.integers(0, 256, (B, M)).astype(np.uint8)
    rows[:, 0] = rng.integers(0, 5, B)
    rows[:, 1] = rng.integers(0, 31, B)
    rows[: B // 2, 2:] &= 0x0F  # shorter runs
    n = rng.integers(0, 400, B).astype(np.int32)
    _plain_and_model(rows, n, 400)


def test_plain_decode_equals_the_model_on_edge_blocks():
    """Kernel N's edge streams (tests/block_rows.py flac_edge_rows): k = 0
    and k = 30 blocks, order = blen - 1 on a short last block, a valid
    block before a header the press never writes, and Rice regions ending
    on a chunk edge, a tile edge and the first tile's reach; the host
    codec decodes the valid ones to the same samples."""
    streams, n, valid = block_rows.flac_edge_rows(8)
    out = _plain_and_model(block_rows.stream_rows(streams, 5), n, 8200)
    for i, s in enumerate(streams):
        if valid[i]:
            assert np.array_equal(out[i, : n[i]], HOST.depress(s, int(n[i])))
    assert not out[3, 4096:].any() and not out[4, 4096:].any()


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    reads = block_rows.block_reads(8)[:10]
    rows = block_rows.stream_rows([HOST.press(r) for r in reads])
    n = torch.tensor([r.size for r in reads], dtype=torch.int32)
    assert torch.equal(flac_decode(torch.from_numpy(rows), n, 4200),
                       flac_decode_plain(torch.from_numpy(rows), n, 4200))


def test_bound_equals_the_host_codec():
    for n in (0, 1, 4095, 4096, 4097, 155185, 3_000_001):
        b = bound("flac", n)
        assert b == HOST.bound(n) == 3 * n + 64 and type(b) is int
