"""honours_tpu_torch's CUDA kernels vs their plain versions on the card,
and its sharded engines (shard/) in multi-rank worlds on the card.

Marked `gpu`; run on a CUDA machine with
    python -m pytest -m gpu tests/test_torch_gpu.py
Elsewhere every test skips (the `cuda` fixture decides, at run time).
Outputs are integers and must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

import chunked_rows as rows
import rc_rows
import stall_rows
from chunked_rows import place as chunked_place
from entropy_rows import fib_hist, long_code_read, tie_histograms

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


TILE = 4096  # permute_cuda.TILE (tests/test_torch_build.py holds it to permute.cu)
WIDTHS = [1, 513, 700, TILE // 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 5,
          1 << 21, (1 << 21) + 5]


def _keep(kind, B, N, g):
    if kind == "random":
        return torch.rand((B, N), generator=g) < 0.6
    if kind == "last":
        return (torch.arange(N) == N - 1).expand(B, N).contiguous()
    return torch.full((B, N), kind == "all", dtype=torch.bool)


@pytest.mark.parametrize("kind", ["random", "all", "none", "last"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("N", WIDTHS)
def test_permute_kernels_match_plain(cuda, dtype, N, B, kind):
    """Kernel 1's five entries at the tile edges (one tile, one element
    either side, several tiles, 2^21 + 5 columns) and on rows an
    expansion block takes 2, 4 or 8 of, with every keep
    pattern; expansions with a width past N and targets below 0 and at or
    past the width."""
    from honours_tpu_torch.engine import permute_cuda as P

    assert P.TILE == TILE
    g = torch.Generator().manual_seed(N + B)
    hi = 256 if dtype == torch.uint8 else 1 << 30
    v = torch.randint(0, hi, (B, N), generator=g).to(dtype).to(cuda)
    keep = _keep(kind, B, N, g).to(cuda)
    _same(P.compact(v, keep), P.compact_plain(v, keep))
    _same(P.compaction_shifts(keep), P.compaction_shifts_plain(keep))
    sh, cnt = P.compaction_shifts(keep)
    valid = torch.arange(N, device=cuda)[None, :] < cnt[:, None]
    vc, _ = P.compact(v, keep)
    for W in (N, N + 3, N + 5000):
        _same(P.expand(vc, sh, valid, W), P.expand_plain(vc, sh, valid, W))
    # strictly rising targets from -N/3 to past the width, random valid
    tg = torch.randperm(N + N // 3 + N // 2 + 1, generator=g)[:N].sort().values
    sh2 = (tg - N // 3 - torch.arange(N)).to(torch.int32).expand(B, N)
    sh2 = sh2.contiguous().to(cuda)
    val2 = (torch.rand((B, N), generator=g) < 0.7).to(cuda)
    for W in (max(1, N // 2), N, 2 * N + 7):
        _same(P.expand(v, sh2, val2, W), P.expand_plain(v, sh2, val2, W))


def _rejects(cuda):
    """(wrapper call, error) pairs for tensors the kernels cannot take."""
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    u8 = torch.zeros((2, 8), dtype=torch.uint8, device=cuda)
    keep = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    sh = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    i32 = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    t = canned_o1_device_tables(cuda)
    return {
        "dtype": (lambda: P.compact(u8.to(torch.int64), keep), TypeError),
        "not_rows": (lambda: P.compact(u8[0], keep[0]), ValueError),
        "keep_not_contiguous": (
            lambda: P.compact(u8, torch.ones((8, 2), dtype=torch.bool,
                                             device=cuda).t()), ValueError),
        "shifts_not_rows": (lambda: P.compaction_shifts(keep[0]), ValueError),
        "shift_dtype": (lambda: P.expand(u8, sh.to(torch.int64), keep, 8),
                        TypeError),
        "negative_width": (lambda: P.expand(u8, sh, keep, -1), ValueError),
        "width_2_31": (lambda: P.expand(u8, sh, keep, 1 << 31), ValueError),
        "mixed_devices": (lambda: P.compact(u8, keep.cpu()), ValueError),
        "fc_dtype": (lambda: O.o1_fc(i32.to(torch.int64), i32, t["cmap"],
                                     t["fc"]), TypeError),
        "fc_not_contiguous": (lambda: O.o1_fc(i32.t(), i32.t(), t["cmap"],
                                              t["fc"]), ValueError),
        "fc_table_shape": (lambda: O.o1_fc(i32, i32, t["cmap"],
                                           t["fc"][:, :128].contiguous()),
                           ValueError),
    }


REJECTS = ["dtype", "not_rows", "keep_not_contiguous", "shifts_not_rows",
           "shift_dtype", "negative_width", "width_2_31", "mixed_devices",
           "fc_dtype", "fc_not_contiguous", "fc_table_shape"]


@pytest.mark.parametrize("case", REJECTS)
def test_kernel_rejects_other_dtypes(cuda, case):
    call, err = _rejects(cuda)[case]
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("off,tail", [(0, 0), (1, 0), (3, 1), (2, 3)])
def test_fc_and_encode_kernels_match_plain(cuda, off, tail):
    """Kernel 2 on the whole grid and on views starting `off` elements
    into their storage with n % 4 == (4 - tail) % 4; kernel 3 after it."""
    from honours_tpu_torch.engine import rans_encode_cuda as E
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    tabs = canned_o1_device_tables(cuda)
    g = torch.Generator().manual_seed(1)
    B, Smax, K = 8, 96, 32
    sym = torch.randint(0, 256, (B, Smax * K), generator=g, dtype=torch.int32)
    ctx = torch.randint(0, 257, (B, Smax * K), generator=g, dtype=torch.int32)
    sym, ctx = sym.to(cuda), ctx.to(cuda)
    fc = O.o1_fc(sym, ctx, tabs["cmap"], tabs["fc"])
    _same(fc, O.o1_fc_plain(sym, ctx, tabs["cmap"], tabs["fc"]))
    n = sym.numel() - 4 - tail
    sv = sym.reshape(-1)[off:off + n]
    cv = ctx.reshape(-1)[4 - off:4 - off + n]
    assert sv.data_ptr() % 16 == 4 * off
    fv = O.o1_fc(sv, cv, tabs["cmap"], tabs["fc"])
    _same(fv, O.o1_fc_plain(sv, cv, tabs["cmap"], tabs["fc"]))
    fc = torch.where(torch.rand(fc.shape, generator=g).to(cuda) < 0.9, fc, 0)
    _same(E.encode_core(fc, Smax, K), E.encode_core_plain(fc, Smax, K))


def _svb_batch(seed, B, L):
    """Ragged rows: n of 0 and 1, nanopore-like, all-two-byte, and 0/3000
    alternations."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((B, L), np.int16)
    n = np.zeros(B, np.int32)
    for i in range(B):
        kind = i % 4
        ni = int(rng.integers(0, L + 1)) if kind == 0 else L
        rows = (rng.integers(400, 700, ni), rng.integers(400, 700, ni),
                rng.integers(-(2 ** 15), 2 ** 15, ni),
                rng.integers(0, 2, ni) * 3000)
        sig[i, :ni] = rows[kind].astype(np.int16)
        n[i] = ni
    n[0], n[1] = 0, 1
    return torch.from_numpy(sig), torch.from_numpy(n)


@pytest.mark.parametrize("B,L", [(1, 1 << 16), (3, 1 << 16), (2, 1 << 18)])
def test_permute_kernels_at_svb32_widths(cuda, B, L):
    """Kernel 1 on svb_zd's operands: the encode's compaction of [B,
    L/4 + 4L] bytes (1,114,112 wide at L = 2^18) and the decode's
    compaction shifts and expansion to [B, 4L], with odd row counts."""
    from honours_tpu_torch.engine import permute_cuda as P
    from honours_tpu_torch.engine import svb32
    from honours_tpu_torch.synth import synthesize_bucket
    from honours_tpu_torch.transforms.core import zigdelta

    sig, n = synthesize_bucket(B, L, seed=B)
    sig, n = torch.from_numpy(sig).to(cuda), torch.from_numpy(n).to(cuda)
    cat, keep = svb32._encode_operands(zigdelta(sig), n, "1234")
    assert cat.shape == (B, L // 4 + 4 * L)
    st = P.compact(cat, keep)
    _same(st, P.compact_plain(cat, keep))
    ops = svb32._decode_operands(st[0], n, L, "1234")
    # the shift-left compaction and the compaction shifts, against the
    # same operands built by the plain versions on the CPU
    _same(ops, svb32._decode_operands(st[0].cpu(), n.cpu(), L, "1234"))
    data, shift, validc, _ = ops
    _same(P.expand(data, shift, validc, 4 * L),
          P.expand_plain(data, shift, validc, 4 * L))


@pytest.mark.parametrize("L", [64, 1024, 4096])
def test_svb16_zd_off_short_rows(cuda, L):
    """vbsse21's exception values: svb16 with zd off on rows of width
    round8(emax) holding n << L values, and n = 0."""
    from honours_tpu_torch.engine import svb16_cuda as S

    g = torch.Generator().manual_seed(L)
    B = 5
    v = torch.randint(-(2 ** 15), 2 ** 15, (B, L), generator=g)
    v = v.to(torch.int16).to(cuda)
    n = torch.tensor([0, 1, 3, 37, min(L, 90)], dtype=torch.int32,
                     device=cuda)
    st = S.svb16_encode(v, n, False)
    _same(st, S.svb16_encode_plain(v, n, False))
    _same(S.svb16_decode(st[0], n, L, False),
          S.svb16_decode_plain(st[0], n, L, False))
    zero = torch.zeros_like(n)
    _same(S.svb16_encode(v, zero, False), S.svb16_encode_plain(v, zero, False))


@pytest.mark.parametrize("zd", [True, False])
@pytest.mark.parametrize("B,L", [(8, 256), (12, 4104), (4, 1 << 18)])
def test_svb16_kernels_match_plain(cuda, zd, B, L):
    from honours_tpu_torch.engine import svb16_cuda as S

    sig, n = _svb_batch(L, B, L)
    sig, n = sig.to(cuda), n.to(cuda)
    st = S.svb16_encode(sig, n, zd)
    _same(st, S.svb16_encode_plain(sig, n, zd))
    _same(S.svb16_decode(st[0], n, L, zd),
          S.svb16_decode_plain(st[0], n, L, zd))
    # a truncated stream decodes (to garbage) without faulting
    _same(S.svb16_decode(st[0][:, :100].contiguous(), n, L, zd),
          S.svb16_decode_plain(st[0][:, :100], n, L, zd))


def test_o1n_kernels_match_plain(cuda):
    from honours_tpu_torch.engine import rans_n4_cuda as R
    from honours_tpu_torch.engine.bits import read_u32le
    from honours_tpu_torch.engine.entropy_o1 import _rd_states
    from honours_tpu_torch.engine.pipeline import (
        canned_o1n_device_tables,
        press_srans3_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import vbbe21_parse_batch, wrap_i32

    tabs = canned_o1n_device_tables(cuda)
    tt = (tabs["cmap"], tabs["lo_assign"], tabs["fcH"], tabs["fcL"])
    g = torch.Generator().manual_seed(2)
    sym = torch.randint(0, 256, (8, 3000), generator=g, dtype=torch.int32)
    ctx = torch.randint(0, 257, (8, 3000), generator=g, dtype=torch.int32)
    sym, ctx = sym.to(cuda), ctx.to(cuda)
    _same(R.o1n_fc(sym, ctx, *tt), R.o1n_fc_plain(sym, ctx, *tt))

    sig, n = _svb_batch(5, 8, 4096)
    sig, n = sig.to(cuda), n.to(cuda)
    st, _ = press_srans3_batch(sig, n, tabs, 4096)
    n64 = n.to(torch.int64)
    zero = torch.zeros_like(n64)
    parsed = vbbe21_parse_batch(st, zero + 2, n64 - 1, 4096, 4096)
    off = parsed["end_off"]
    S_b = wrap_i32(read_u32le(st, off)).to(torch.int32)
    args = (st, _rd_states(st, off, 32),
            (n64 - 1 - parsed["nex"]).to(torch.int32), S_b,
            (off + 132).to(torch.int32), *tt)
    _same(R.n4_decode(*args, 128), R.n4_decode_plain(*args, 128))


def test_o0_decode_kernel_matches_plain(cuda):
    """Kernel 4b on v2 bodies at a non-zero offset, ragged dlen with 0, 1
    and 31, N not a multiple of K, and a truncated stream."""
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.bits import rowwise_concat
    from honours_tpu_torch.engine.entropy import rans_encode_batch
    from honours_tpu_torch.engine.entropy_o1 import read_states
    from honours_tpu_torch.engine.pipeline import canned_rans_tables

    tabs = canned_rans_tables(cuda)
    g = torch.Generator().manual_seed(4)
    N, K = 1000, 32
    dlen = torch.tensor([1000, 0, 1, 31, 999, 640, 33, 128],
                        dtype=torch.int32)
    data = torch.randint(0, 256, (8, N), generator=g, dtype=torch.uint8)
    data = torch.where(torch.arange(N)[None, :] < dlen[:, None], data, 0)
    segs, planew = rans_encode_batch(data.to(cuda), dlen.to(cuda), tabs)
    st, _ = rowwise_concat(segs, 4 * K + planew)
    st = torch.nn.functional.pad(st, (3, 0)).contiguous()
    off = torch.full((8,), 3, device=cuda)
    states = read_states(st, off, K)
    body_off = (off + 4 * K).to(torch.int32)
    args = (st, states, dlen.to(cuda), tabs["cum"], N, body_off)
    out = O.o0_decode(*args)
    _same(out, O.o0_decode_plain(*args))
    assert torch.equal(out.cpu(), data)
    # a truncated stream decodes (to garbage) without faulting
    cut = (st[:, :200].contiguous(), *args[1:])
    _same(O.o0_decode(*cut), O.o0_decode_plain(*cut))


def _o1_tables(kind, dev):
    """Order-1 device tables: "canned" (r = 64), "one" (one row for every
    context, r = 1) or "zero_runs" (8 clusters in which symbols 20-59 and
    96-255 have frequency 0)."""
    from honours_tpu_torch.engine.entropy_o1 import make_o1_tables
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables
    from honours_tpu_torch.kernels.rans import normalize_freqs

    if kind == "canned":
        return canned_o1_device_tables(dev)
    rng = np.random.default_rng(7)
    if kind == "one":
        row = normalize_freqs(rng.integers(1, 1000, 256))
        return make_o1_tables(np.tile(row, (257, 1)), dev)
    allowed = np.zeros(256, bool)
    allowed[:20] = allowed[60:96] = True
    rows = [normalize_freqs(rng.integers(1, 1000, 256) * allowed)
            for _ in range(8)]
    return make_o1_tables(np.stack([rows[c % 8] for c in range(257)]), dev)


def _o1_bodies(tabs, N, dlen, pad, width_pad, seed, symbols=256):
    """v3 bodies under `tabs` of random bytes (any byte, or with
    symbols=56 only the zero_runs tables' live ones), each row shifted
    right by `pad` bytes and the stream widened by `width_pad`:
    (stream, S_b, states, body_off, data)."""
    from honours_tpu_torch.engine.bits import read_u32le, rowwise_concat
    from honours_tpu_torch.engine.entropy_o1 import (
        _rd_states,
        rans_o1_encode_batch,
    )
    from honours_tpu_torch.engine.vbbe21 import wrap_i32

    dev = tabs["cum"].device
    B = dlen.numel()
    g = torch.Generator().manual_seed(seed)
    if symbols == 256:
        data = torch.randint(0, 256, (B, N), generator=g, dtype=torch.uint8)
    else:  # the zero_runs tables' symbols: [0, 20) and [60, 96)
        pick = torch.cat([torch.arange(20), torch.arange(60, 96)])
        data = pick[torch.randint(0, pick.numel(), (B, N), generator=g)]
        data = data.to(torch.uint8)
    data = torch.where(torch.arange(N)[None, :] < dlen[:, None], data, 0)
    segs, planew = rans_o1_encode_batch(data.to(dev), dlen.to(dev), tabs)
    st, _ = rowwise_concat(segs, 4 + 4 * 32 + planew)
    st = torch.nn.functional.pad(st, (pad, width_pad)).contiguous()
    off = torch.full((B,), pad, dtype=torch.int64, device=dev)
    S_b = wrap_i32(read_u32le(st, off)).to(torch.int32)
    body_off = (off + 4 + 4 * 32).to(torch.int32)
    return st, S_b, _rd_states(st, off, 32), body_off, data


RAGGED = [1000, 0, 1, 31, 999, 640, 33, 128]
O1_CASES = {  # table, N, dlen, pad, width_pad, first phase's T
    "canned_resumed": ("canned", 1000, RAGGED, 3, 5, 13),
    "one_cluster": ("one", 1000, RAGGED, 0, 0, 16),
    "zero_runs": ("zero_runs", 1000, RAGGED, 5, 2, 7),
    "long_bodies": ("canned", 48_000, [48_000, 47_999, 20_000, 31], 1, 3, 333),
}


@pytest.mark.parametrize("case", sorted(O1_CASES))
def test_o1_decode_kernel_matches_plain(cuda, case):
    """Kernel 4 against its plain version: a full walk, then the same
    bodies in two resumed phases (step_lo > 0, T not a multiple of 16,
    lane clusters out of range to clamp), at odd body offsets and row
    widths, on r = 64, r = 1 and zero-frequency-run tables, bodies many
    times the window, dlen 0, 1 and 31; then truncated streams and the
    wrong table, which decode to garbage without a fault."""
    from honours_tpu_torch.engine import rans_o1_cuda as O

    kind, N, dl, pad, wpad, T1 = O1_CASES[case]
    tabs = _o1_tables(kind, cuda)
    dlen = torch.tensor(dl, dtype=torch.int32)
    symbols = 56 if kind == "zero_runs" else 256
    st, S_b, states, body_off, data = _o1_bodies(
        tabs, N, dlen, pad, wpad, len(case), symbols)
    B, Smax = dlen.numel(), -(-N // 32)
    dlen = dlen.to(cuda)
    zeros = torch.zeros_like(S_b)
    cl0 = tabs["cmap"][256].expand(B, 32).contiguous()
    full = (st, states, dlen, S_b, tabs["cmap"], tabs["cum"], Smax, zeros,
            S_b, cl0, body_off)
    got = O.o1_decode(*full)
    _same(got, O.o1_decode_plain(*full))
    T0 = torch.minimum(S_b, torch.full_like(S_b, T1))
    args1 = (st, states, dlen, S_b, tabs["cmap"], tabs["cum"], T1, zeros,
             T0, cl0, body_off)
    g1, s1, p1 = O.o1_decode(*args1)
    _same((g1, s1, p1), O.o1_decode_plain(*args1))
    gen = torch.Generator().manual_seed(B)
    r = tabs["cum"].shape[0]
    cl2 = torch.randint(-3, r + 3, (B, 32), generator=gen, dtype=torch.int32)
    args2 = (st, s1, dlen, S_b, tabs["cmap"], tabs["cum"], Smax - T1, T0,
             S_b, cl2.to(cuda), p1)
    _same(O.o1_decode(*args2), O.o1_decode_plain(*args2))
    cut = (st[:, :200].contiguous(), *full[1:])
    _same(O.o1_decode(*cut), O.o1_decode_plain(*cut))
    other = _o1_tables("one" if kind != "one" else "canned", cuda)
    wrong = (*full[:4], other["cmap"], other["cum"], *full[6:])
    _same(O.o1_decode(*wrong), O.o1_decode_plain(*wrong))


def test_o1_decode_kernel_one_read(cuda):
    """Kernel 4 on one read of Smax = 8192 steps (the one-row shape)."""
    from honours_tpu_torch.engine import rans_o1_cuda as O

    tabs = _o1_tables("canned", cuda)
    N = 8192 * 32
    dlen = torch.tensor([N - 5], dtype=torch.int32)
    st, S_b, states, body_off, data = _o1_bodies(tabs, N, dlen, 0, 0, 11)
    cl0 = tabs["cmap"][256].expand(1, 32).contiguous()
    args = (st, states, dlen.to(cuda), S_b, tabs["cmap"], tabs["cum"], 8192,
            torch.zeros_like(S_b), S_b, cl0, body_off)
    got = O.o1_decode(*args)
    _same(got, O.o1_decode_plain(*args))


O0_CASES = {  # N, dlen, pad, width_pad, table
    "ragged": (1000, RAGGED, 3, 2, "canned"),
    "long_bodies": (48_000, [48_000, 47_999, 20_000, 31], 1, 5, "canned"),
    "one_read": (8192 * 32, [8192 * 32 - 3], 0, 1, "canned"),
    "zero_runs": (1000, [1000, 999, 31, 1], 2, 0, "zero_runs"),
}


@pytest.mark.parametrize("case", sorted(O0_CASES))
def test_o0_decode_kernel_edges(cuda, case):
    """Kernel 4b against its plain version at odd offsets and widths, on
    bodies many times the window, one read of 8192 steps, a table with
    zero-frequency runs, and under the wrong table (garbage, no fault)."""
    from honours_tpu_torch.engine import rans_o1_cuda as O
    from honours_tpu_torch.engine.bits import rowwise_concat
    from honours_tpu_torch.engine.entropy import make_tables, rans_encode_batch
    from honours_tpu_torch.engine.entropy_o1 import read_states
    from honours_tpu_torch.engine.pipeline import canned_rans_tables
    from honours_tpu_torch.kernels.rans import normalize_freqs

    N, dl, pad, wpad, kind = O0_CASES[case]
    rng = np.random.default_rng(3)
    allowed = np.zeros(256, bool)
    allowed[:20] = allowed[60:96] = True
    zr = make_tables(normalize_freqs(rng.integers(1, 1000, 256) * allowed),
                     cuda)
    tabs = canned_rans_tables(cuda) if kind == "canned" else zr
    dlen = torch.tensor(dl, dtype=torch.int32)
    B = dlen.numel()
    g = torch.Generator().manual_seed(N)
    pick = torch.nonzero(tabs["freqs"].cpu() > 0).flatten()
    data = pick[torch.randint(0, pick.numel(), (B, N), generator=g)]
    data = torch.where(torch.arange(N)[None, :] < dlen[:, None], data, 0)
    data = data.to(torch.uint8)
    segs, planew = rans_encode_batch(data.to(cuda), dlen.to(cuda), tabs)
    st, _ = rowwise_concat(segs, 4 * 32 + planew)
    st = torch.nn.functional.pad(st, (pad, wpad)).contiguous()
    off = torch.full((B,), pad, device=cuda)
    args = (st, read_states(st, off, 32), dlen.to(cuda), tabs["cum"], N,
            (off + 4 * 32).to(torch.int32))
    out = O.o0_decode(*args)
    _same(out, O.o0_decode_plain(*args))
    assert torch.equal(out.cpu(), data)
    other = zr if kind == "canned" else canned_rans_tables(cuda)
    wrong = (*args[:3], other["cum"], *args[4:])
    _same(O.o0_decode(*wrong), O.o0_decode_plain(*wrong))


def _nibble_tables(kind, dev):
    """Nibble device tables: "canned"; "one" (r = rL = 1); "spiked" (L
    rows with cells of 1); "r64" (64 random rows, rL = 64)."""
    from honours_tpu_torch.engine.entropy_o1n import make_o1n_tables
    from honours_tpu_torch.engine.pipeline import canned_o1n_device_tables
    from honours_tpu_torch.kernels.rans import normalize_freqs
    from honours_tpu_torch.tables.o1n import build_nibble_tables

    if kind == "canned":
        return canned_o1n_device_tables(dev)
    rng = np.random.default_rng(8)
    if kind == "one":
        row = normalize_freqs(rng.integers(1, 1000, 256))
        return make_o1n_tables(
            build_nibble_tables(np.tile(row, (257, 1)), r_lo=1), dev)
    if kind == "spiked":
        rows = [normalize_freqs(np.ones(256) + (np.arange(256) == 37 * i + 5)
                                * 1e6) for i in range(8)]
    else:
        rows = [normalize_freqs(rng.integers(1, 1000, 256) ** 3 % 5000 + 1)
                for _ in range(64)]
    freqs = np.stack([rows[c % len(rows)] for c in range(257)])
    return make_o1n_tables(build_nibble_tables(freqs), dev)


def _n4_bodies(tabs, N, dlen, pad, width_pad, seed):
    """v4 bodies of random bytes under `tabs`, each row shifted right by
    `pad` bytes and the stream widened by `width_pad`: (kernel 8's
    arguments but T, S_b, data)."""
    from honours_tpu_torch.engine.bits import read_u32le, rowwise_concat
    from honours_tpu_torch.engine.entropy_o1 import _rd_states
    from honours_tpu_torch.engine.entropy_o1n import rans_o1n_encode_batch
    from honours_tpu_torch.engine.vbbe21 import wrap_i32

    dev = tabs["fcH"].device
    B = dlen.numel()
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 256, (B, N), generator=g, dtype=torch.uint8)
    data = torch.where(torch.arange(N)[None, :] < dlen[:, None], data, 0)
    segs, planew = rans_o1n_encode_batch(data.to(dev), dlen.to(dev), tabs)
    st, _ = rowwise_concat(segs, 4 + 4 * 32 + planew)
    st = torch.nn.functional.pad(st, (pad, width_pad)).contiguous()
    off = torch.full((B,), pad, dtype=torch.int64, device=dev)
    S_b = wrap_i32(read_u32le(st, off)).to(torch.int32)
    args = (st, _rd_states(st, off, 32), dlen.to(dev), S_b,
            (off + 4 + 4 * 32).to(torch.int32), tabs["cmap"],
            tabs["lo_assign"], tabs["fcH"], tabs["fcL"])
    return args, S_b, data


N4_CASES = {  # table, N, dlen, pad, width_pad
    "canned": ("canned", 1000, RAGGED, 3, 5),
    "one_cluster": ("one", 1000, RAGGED, 0, 0),
    "spiked": ("spiked", 1000, RAGGED, 1, 2),
    "r64": ("r64", 1000, RAGGED, 5, 1),
    "long_bodies": ("canned", 48_000, [48_000, 47_999, 20_000, 31], 1, 3),
    "one_read": ("canned", 8192 * 32, [8192 * 32 - 5], 0, 1),
}


@pytest.mark.parametrize("case", sorted(N4_CASES))
def test_n4_decode_kernel_edges(cuda, case):
    """Kernel 8 against its plain version: odd body offsets and row
    widths, dlen 0, 1 and 31, r = 1, spiked (L cells of 1) and random
    r = 64 tables, bodies many times the window, one read of 8192 byte
    steps; the lane grid gives the bytes back; then a truncated stream
    and the wrong table, which decode to garbage without a fault."""
    from honours_tpu_torch.engine import rans_n4_cuda as R
    from honours_tpu_torch.engine.entropy_o1 import _ungrid

    kind, N, dl, pad, wpad = N4_CASES[case]
    tabs = _nibble_tables(kind, cuda)
    dlen = torch.tensor(dl, dtype=torch.int32)
    args, S_b, data = _n4_bodies(tabs, N, dlen, pad, wpad, len(case))
    Smax = -(-N // 32)
    grid = R.n4_decode(*args, Smax)
    _same(grid, R.n4_decode_plain(*args, Smax))
    back = _ungrid(grid, S_b, args[2], 32, Smax, N)
    assert torch.equal(back.cpu(), data)
    if case == "one_read":
        return
    cut = (args[0][:, :200].contiguous(), *args[1:])
    _same(R.n4_decode(*cut, Smax), R.n4_decode_plain(*cut, Smax))
    other = _nibble_tables("one" if kind != "one" else "canned", cuda)
    wrong = (*args[:5], other["cmap"], other["lo_assign"], other["fcH"],
             other["fcL"])
    _same(R.n4_decode(*wrong, Smax), R.n4_decode_plain(*wrong, Smax))


SVB_TILE = 2048  # svb16_cuda.DECODE_TILE (held to svb16.cu on the CPU)


@pytest.mark.parametrize("zd", [True, False])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [SVB_TILE - 1, SVB_TILE, SVB_TILE + 1,
                               (1 << 21) + 5])
def test_svb16_decode_kernel_tiles(cuda, zd, B, n):
    """Kernel 6 at its tile edges and over 2^21 + 5 samples (1025 tiles),
    with a row of nanopore-like samples, one where every field takes two
    bytes and one where none does, each a tile of zeros past n; then a
    truncated stream and a stream view at an odd address."""
    from honours_tpu_torch.engine import svb16_cuda as S

    assert S.DECODE_TILE == SVB_TILE
    L = -(-n // 8) * 8 + 16
    rng = np.random.default_rng(n + B)
    sig = np.zeros((B, L), np.int16)
    big = np.where(rng.random(n) < 0.5, 1, -1) * rng.integers(300, 30000, n)
    rows = [rng.integers(400, 700, n),
            np.cumsum(big) if zd else rng.integers(256, 65536, n),
            rng.integers(0, 100 if zd else 256, n)]
    for i in range(B):
        sig[i, :n] = rows[i].astype(np.uint16).view(np.int16)
    sig = torch.from_numpy(sig).to(cuda)
    nn = torch.full((B,), n, dtype=torch.int32, device=cuda)
    st, ln = S.svb16_encode(sig, nn, zd)
    _same((st, ln), S.svb16_encode_plain(sig, nn, zd))
    if B == 3:
        assert int(ln[1]) == -(-n // 8) + 2 * n and int(ln[2]) == -(-n // 8) + n
    out = S.svb16_decode(st, nn, L, zd)
    _same(out, S.svb16_decode_plain(st, nn, L, zd))
    assert torch.equal(out, sig)
    cut = st[:, :int(ln.min()) // 2].contiguous()
    _same(S.svb16_decode(cut, nn, L, zd), S.svb16_decode_plain(cut, nn, L, zd))
    W = st.shape[1]
    buf = torch.zeros(B * W + 3, dtype=torch.uint8, device=cuda)
    view = buf[3:].view(B, W)
    view.copy_(st)
    assert view.data_ptr() % 16 != 0
    _same(S.svb16_decode(view, nn, L, zd), out)


def _encode_poisoned(sig, n, zd):
    """svb16_encode into memory that held 0xA5 bytes: a block of the
    output's size is filled and freed just before the call, so the caching
    allocator hands it to the wrapper's output."""
    from honours_tpu_torch.engine import svb16_cuda as S

    B, L = sig.shape
    bait = torch.full((B, S.stream_width(L)), 0xA5, dtype=torch.uint8,
                      device=sig.device)
    ptr = bait.data_ptr()
    del bait
    st, ln = S.svb16_encode(sig, n, zd)
    assert st.data_ptr() == ptr
    return st, ln


def _encode_same(sig, n, zd):
    """The kernel's stream and lengths, written over poisoned memory, equal
    the plain version's (which has no 0xA5 byte the kernel left)."""
    from honours_tpu_torch.engine import svb16_cuda as S

    got = _encode_poisoned(sig, n, zd)
    _same(got, S.svb16_encode_plain(sig, n, zd))
    return got


def _svb_rows(kinds, L, n, zd, seed):
    """Rows of n samples: nanopore-like ("mixed"), every field two bytes
    ("two") or none ("one"); zeros from n on."""
    rng = np.random.default_rng(seed)
    sig = np.zeros((len(kinds), L), np.int16)
    big = np.where(rng.random(L) < 0.5, 1, -1) * rng.integers(300, 30000, L)
    make = {"mixed": lambda: rng.integers(400, 700, L),
            "two": lambda: np.cumsum(big) if zd else rng.integers(256, 65536, L),
            "one": lambda: rng.integers(0, 100 if zd else 256, L)}
    for i, k in enumerate(kinds):
        sig[i, :n] = make[k]()[:n].astype(np.uint16).view(np.int16)
    return sig


SVB_ETILE = 2048  # svb16_cuda.ENCODE_TILE (held to svb16.cu on the CPU)


@pytest.mark.parametrize("zd", [True, False])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [SVB_ETILE - 1, SVB_ETILE, SVB_ETILE + 1,
                               (1 << 21) + 5])
def test_svb16_encode_kernel_tiles(cuda, zd, B, n):
    """Kernel 5 at its tile edges and over 2^21 + 5 samples (1025 live
    tiles), on poisoned output: rows of nanopore-like samples, of fields
    all two bytes and of none, with a tile of zeros past n."""
    from honours_tpu_torch.engine import svb16_cuda as S

    assert S.ENCODE_TILE == SVB_ETILE
    L = -(-n // 8) * 8 + 16
    kinds = ["mixed", "two", "one"][:B]
    sig = torch.from_numpy(_svb_rows(kinds, L, n, zd, n + B)).to(cuda)
    nn = torch.full((B,), n, dtype=torch.int32, device=cuda)
    _, ln = _encode_same(sig, nn, zd)
    if B == 3:
        kl = -(-n // 8)
        assert ln[1].item() == kl + 2 * n and ln[2].item() == kl + n


@pytest.mark.parametrize("zd", [True, False])
def test_svb16_encode_kernel_odd_width(cuda, zd):
    """L = 4104: a row is W = 8721 bytes, odd, so 32 rows start at every
    byte phase twice; n runs over 0 to L (0, 1, 7, 8, the tile edges, L
    and values between), rows of every kind."""
    L = 4104
    ns = [0, 1, 7, 8, 9, 15, 16, SVB_ETILE - 1, SVB_ETILE, SVB_ETILE + 1,
          4095, 4096, 4097, 4103, L, L]
    ns += list(np.random.default_rng(7).integers(0, L + 1, 16))
    kinds = ["mixed", "two", "one"]
    sig = np.concatenate([_svb_rows([kinds[i % 3]], L, int(m), zd, i)
                          for i, m in enumerate(ns)])
    sig = torch.from_numpy(sig).to(cuda)
    _encode_same(sig, torch.tensor(ns, dtype=torch.int32, device=cuda), zd)


@pytest.mark.parametrize("zd", [True, False])
def test_svb16_encode_kernel_unaligned_view(cuda, zd):
    """A sig view at an address 2 mod 16 (scalar loads), equal to the same
    samples from an aligned tensor."""
    B, L = 3, 3 * SVB_ETILE + 24
    sig = torch.from_numpy(_svb_rows(["mixed", "two", "one"], L, L, zd, 5))
    buf = torch.zeros(B * L + 1, dtype=torch.int16, device=cuda)
    view = buf[1:].view(B, L)
    view.copy_(sig.to(cuda))
    assert view.data_ptr() % 16 == 2
    n = torch.tensor([L, L - 5, SVB_ETILE + 3], dtype=torch.int32, device=cuda)
    st = _encode_same(view, n, zd)
    _same(st, _encode_same(sig.to(cuda), n, zd))


@pytest.mark.parametrize("zd", [True, False])
def test_svb16_encode_kernel_clamps_n(cuda, zd):
    """n below 0 encodes an empty row and n above L the whole row."""
    from honours_tpu_torch.engine import svb16_cuda as S

    L = 2 * SVB_ETILE + 8
    sig = np.repeat(_svb_rows(["mixed"], L, L, zd, 9), 4, axis=0)
    sig = torch.from_numpy(sig).to(cuda)
    n = torch.tensor([-1, -(1 << 31), L + 1, (1 << 31) - 1], dtype=torch.int32,
                     device=cuda)
    st, ln = _encode_same(sig, n, zd)
    assert ln[0].item() == 0 and ln[1].item() == 0 and not st[:2].any()
    full = S.svb16_encode_plain(
        sig[:1], torch.tensor([L], dtype=torch.int32, device=cuda), zd)
    _same((st[2:], ln[2:]), (full[0].expand(2, -1), full[1].expand(2)))


@pytest.mark.parametrize("B,L", [(12, 4104), (3, (1 << 21) + 8)])
def test_svb16_encode_kernel_repeats(cuda, B, L):
    """20 launches in a row, zd on and off in turns, each equal to the
    plain version: a race between tiles would show in some of them."""
    from honours_tpu_torch.engine import svb16_cuda as S

    kinds = ["mixed", "two", "one"]
    ns = np.random.default_rng(B).integers(0, L + 1, B)
    ns[0] = L
    sig = np.concatenate([_svb_rows([kinds[i % 3]], L, int(m), True, i)
                          for i, m in enumerate(ns)])
    sig = torch.from_numpy(sig).to(cuda)
    n = torch.from_numpy(ns.astype(np.int32)).to(cuda)
    want = {zd: S.svb16_encode_plain(sig, n, zd) for zd in (True, False)}
    for i in range(20):
        _same(_encode_poisoned(sig, n, i % 2 == 0), want[i % 2 == 0])


@pytest.mark.parametrize("zd", [True, False])
def test_svb16_encode_kernel_graph_replay(cuda, zd):
    """Captured in a CUDA graph (scratch zeroing included) and replayed
    three times, the output equals a direct call."""
    from honours_tpu_torch.engine import svb16_cuda as S

    B, L = 4, 3 * SVB_ETILE + 40
    kinds = ["mixed", "two", "one", "mixed"]
    sig = torch.from_numpy(_svb_rows(kinds, L, L - 9, zd, 11)).to(cuda)
    n = torch.tensor([L - 9, L - 9, SVB_ETILE, 0], dtype=torch.int32,
                     device=cuda)
    want = S.svb16_encode(sig, n, zd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.svb16_encode(sig, n, zd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = S.svb16_encode(sig, n, zd)
    for _ in range(3):
        got[0].fill_(0xA5)
        graph.replay()
        _same(got, want)
    _same(want, S.svb16_encode_plain(sig, n, zd))


ENCODE_CASES = {  # B, Smax, fc offset in elements, kind
    "aligned": (8, 96, 0, "table"),
    "offset_4": (3, 70, 1, "table"),
    "offset_8": (5, 33, 2, "table"),
    "offset_12": (2, 64, 3, "table"),
    "f_1_and_4096": (4, 65, 0, "extremes"),
    "invalid": (4, 64, 0, "invalid"),
    "many_rows": (1100, 40, 0, "table"),
    "one_read": (1, 8192, 0, "table"),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_rans_encode_kernel_edges(cuda, case):
    """Kernel 3 against its plain version: fc views at every 4-byte offset
    (the kernel copies 4 bytes at a time there), Smax not a multiple of
    the 32-step chunk, f = 1 and f = 4096, fc outside a valid table (the
    exact division path), rows ending early (chunks no lane is active
    in), more rows than 8 per SM, and one read of 8192 steps."""
    from honours_tpu_torch.engine import rans_encode_cuda as E
    from honours_tpu_torch.engine.pipeline import canned_o1_device_tables

    B, Smax, off, kind = ENCODE_CASES[case]
    g = torch.Generator().manual_seed(Smax + B)
    n = B * Smax * 32
    if kind == "extremes":  # one symbol holding all of M, or f = 1
        f = torch.where(torch.rand(n, generator=g) < 0.5, 1, 4096)
        c = torch.where(f == 1, torch.randint(0, 4096, (n,), generator=g), 0)
        fc = (f + c * 8192).to(torch.int32)
    elif kind == "invalid":  # f + c > M (x may pass 2^31, never 2^32)
        f = torch.randint(1, 4097, (n,), generator=g)
        fc = (f + torch.randint(0, 1 << 17, (n,), generator=g) * 8192)
        fc = fc.to(torch.int32)
    else:
        tab = canned_o1_device_tables(torch.device("cpu"))["fc"].reshape(-1)
        fc = tab[torch.randint(0, tab.numel(), (n,), generator=g)]
    fc = torch.where(torch.rand(n, generator=g) < 0.85, fc, 0)
    # row b ends after (4 - b % 4) / 4 of its steps: whole chunks idle
    t = torch.arange(Smax).repeat_interleave(32)[None, :]
    ends = (4 - torch.arange(B)[:, None] % 4) * Smax // 4
    fc = torch.where(t < ends, fc.view(B, -1), 0).reshape(-1)
    store = torch.zeros(n + 4, dtype=torch.int32)
    store[off:off + n] = fc
    view = store.to(cuda)[off:off + n].view(B, Smax * 32)
    assert view.data_ptr() % 16 == 4 * off
    _same(E.encode_core(view, Smax), E.encode_core_plain(view, Smax))


# ---------------------------------------------------------------------------
# kernel A (the stall segmenter), kernel B (rice decode) and kernel C
# (static-Huffman decode)
# ---------------------------------------------------------------------------


def _stall_row(rng, m, stall=0, at=0, n_rest=2000):
    """m samples: alternating extremes (never in band) with `stall`
    in-band samples at 460 +- 4 from `at`, then up to n_rest more."""
    x = np.empty(m, np.int64)
    x[0::2] = rng.integers(0, 60, x[0::2].size)
    x[1::2] = rng.integers(1100, 1200, x[1::2].size)
    x[at: at + stall] = 460 + rng.integers(-4, 5, min(stall, m - at))
    return x.astype(np.int16)


def _padded(reads, L=None):
    L = L or max(r.size for r in reads)
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    return (torch.from_numpy(sig),
            torch.tensor([r.size for r in reads], dtype=torch.int32))


def _stall_same(cuda, sig, n):
    from honours_tpu_torch.segment import segment_cuda as S

    got = S.find_stall(sig.to(cuda), n.to(cuda))
    torch.cuda.synchronize()
    _same(got, S.find_stall_plain(sig, n))
    return got


@pytest.mark.parametrize("m", [0, 1, 37, 38, 149, 150, 151])
def test_find_stall_short_reads(cuda, m):
    """Reads of n = m in-band samples, alone and in a batch of 3 beside
    longer reads with a run of m in-band samples (a segment once the run
    and its 5 tolerated excursions reach 38 = window * stall_len), at
    widths L % 8 == 0 and not."""
    rng = np.random.default_rng(m)
    head = (460 + rng.integers(-4, 5, m)).astype(np.int16)
    reads = [head, np.concatenate([head, _stall_row(rng, 300)]),
             _stall_row(rng, 2000, stall=m, at=700)]
    _stall_same(cuda, *_padded(reads[:1], max(m, 1)))
    for L in (2301, 2304):
        got = _stall_same(cuda, *_padded(reads, L))
        assert got[0].tolist() == [False, m >= 33, m >= 33]


def test_find_stall_fixture_and_stall_set(cuda):
    """chip_smoke.py's fixture reads and stall set."""
    from chip_smoke import fixture_reads
    from honours_tpu_torch.synth import stall_set

    got = _stall_same(cuda, *_padded(fixture_reads()))
    assert got[0].all()
    got = _stall_same(cuda, *_padded(stall_set(0)))
    assert int(got[0].sum()) >= 12


def test_find_stall_float_stress_and_late_stall(cuda):
    """120,000 alternating extremes after a 700-sample stall (the float
    sums' stress case), and a stall from sample 70,000 (past uint16)."""
    rng = np.random.default_rng(77)
    x = _stall_row(rng, 120000, stall=700)
    late = _stall_row(rng, 73500, stall=3000, at=70000)
    got = _stall_same(cuda, *_padded([x, late]))
    assert got[1].tolist()[1] >= 70000


@pytest.mark.parametrize("B", [1, 3, 256])
def test_find_stall_batches(cuda, B):
    """Synthetic buckets, at L = 65536 and at an odd width from a view 2
    bytes into its storage (the one-sample-a-load path), n clamped."""
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(B, 1 << 16, seed=B)
    sig, n = torch.from_numpy(sig), torch.from_numpy(n)
    _stall_same(cuda, sig, n)
    L = 9999
    store = torch.zeros(B * L + 8, dtype=torch.int16)
    store[1: 1 + B * L] = sig[:, :L].reshape(-1)
    view = store.to(cuda)[1: 1 + B * L].view(B, L)
    assert view.data_ptr() % 16 == 2
    from honours_tpu_torch.segment import segment_cuda as S

    n2 = (n % 12000).to(torch.int32)
    _same(S.find_stall(view, n2.to(cuda)), S.find_stall_plain(view.cpu(), n2))


@pytest.mark.parametrize("name", stall_rows.row_names())
def test_find_stall_kernel_stall_rows(cuda, name):
    """Kernel A on each row of tests/stall_rows.py alone: sums crossing
    2^24 .. 2^29 at chunk and tile ends, ties, all-1200 and all-0 rows, n
    at the window edges, rows of one to eight tiles, attempts ending at
    chunk and tile ends or open across them, merges at 49 and 50, results
    fixed at nsegs == 2, the knife-edge reads, a stall past 65,535 and
    the fixture reads."""
    row = stall_rows.stall_row(name)
    _stall_same(cuda, *_padded([row], max(row.size, 1)))


@pytest.mark.parametrize("odd", [False, True])
def test_find_stall_kernel_stall_rows_batch(cuda, odd):
    """Every row of tests/stall_rows.py in one batch, at L % 8 == 0 (16-byte
    loads throughout) and at L % 8 == 1 (rows at every alignment)."""
    rows_ = [r for _, r in stall_rows.stall_rows()]
    L = -(-max(r.size for r in rows_) // 8) * 8 + odd
    _stall_same(cuda, *_padded(rows_, L))


def test_find_stall_kernel_poisoned_output(cuda):
    """The outputs come in blocks that held 0xA5 bytes just before the
    call: the kernel writes every row's (exists, start, length), rows
    with no segment and n = 0 included."""
    from honours_tpu_torch.segment import segment_cuda as S

    rows_ = [r for _, r in stall_rows.stall_rows()][:40]
    sig, n = _padded(rows_)
    sig_c, n_c = sig.to(cuda), n.to(cuda)
    baits = [torch.full((512,), 0xA5, dtype=torch.uint8, device=cuda)
             for _ in range(64)]
    ptrs = {b.data_ptr() for b in baits}
    del baits
    got = S.find_stall(sig_c, n_c)
    assert all(t.data_ptr() in ptrs for t in got)
    torch.cuda.synchronize()
    want = S.find_stall_plain(sig, n)
    _same(got, want)
    assert not want[0].all() and (n == 0).any()


def _rice_rows(seed=0):
    """Residual byte rows whose rice streams take every k, runs of 255
    under small k, all-255 rows, one value and none; and their streams
    from the port's encoder."""
    from honours_tpu_torch.engine.rice import rice_encode_batch

    rng = np.random.default_rng(seed)
    rows = [rng.geometric(1 / s, 700).clip(1, 256).astype(np.int64) - 1
            for s in (1.2, 2, 4, 8, 16, 32, 64, 110, 200)]
    for k_lo in (0, 1, 2):
        r = rng.integers(0, 1 << k_lo, 300)
        r[::150] = 255
        rows.append(r)
    rows += [np.full(500, 255), np.full(33, 255), np.array([200]),
             np.array([0]), np.zeros(0, np.int64)]
    N = max(r.size for r in rows)
    data = np.zeros((len(rows), N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    cnt = torch.tensor([r.size for r in rows], dtype=torch.int32)
    blob, blen = rice_encode_batch(torch.from_numpy(data), cnt)
    return rows, [blob[i, : int(blen[i])].numpy().tobytes()
                  for i in range(len(rows))], cnt


@pytest.mark.parametrize("pad", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("N", [700, 701])
def test_rice_decode_kernel_matches_plain(cuda, pad, N):
    """Every k, empty rows, one value, runs of 255, streams of every
    length mod 4 (some ending on a word edge) starting pad + row % 4
    bytes into rows of garbage, on a view at an odd address; N % 4 == 0
    (word stores) and not."""
    from honours_tpu_torch.engine import rice_cuda as R

    rows, blobs, cnt = _rice_rows()
    ks = {(b[0] & 1) << 2 | (b[0] >> 1 & 1) << 1 | (b[0] >> 2 & 1)
          for b in blobs}
    assert ks == set(range(8))
    assert {len(b) % 4 for b in blobs} == {0, 1, 2, 3}
    M = max(len(b) for b in blobs) + pad + 3
    st = np.full((len(rows), M), 0xFF, np.uint8)
    off = np.zeros(len(rows), np.int32)
    for i, b in enumerate(blobs):
        o = pad + i % 4
        st[i, o: o + len(b)] = np.frombuffer(b, np.uint8)
        st[i, o + len(b):] = 0
        off[i] = o
    store = torch.zeros(st.size + 16, dtype=torch.uint8)
    store[3: 3 + st.size] = torch.from_numpy(st).reshape(-1)
    view = store.to(cuda)[3: 3 + st.size].view(st.shape)
    assert view.data_ptr() % 4 == 3
    off, cnt = torch.from_numpy(off), cnt.clamp(max=N)
    got = R.rice_decode(view, off.to(cuda), cnt.to(cuda), N)
    torch.cuda.synchronize()
    want = R.rice_decode_plain(view.cpu(), off, cnt, N)
    _same(got, want)
    for i, r in enumerate(rows):
        assert np.array_equal(want[i, : r.size].numpy(), r[:N]), i


def test_rice_decode_kernel_cut_streams_and_counts(cuda):
    """Streams cut short, offsets past the row, counts past N or
    negative: the kernel reads zeros past each row and faults nowhere."""
    from honours_tpu_torch.engine import rice_cuda as R

    rows, blobs, _ = _rice_rows(1)
    M = 40
    st = np.zeros((len(rows), M), np.uint8)
    for i, b in enumerate(blobs):
        st[i, : min(M, len(b))] = np.frombuffer(b[:M], np.uint8)
    st = torch.from_numpy(st)
    off = torch.tensor([i % 3 * 20 for i in range(len(rows))],
                       dtype=torch.int32)
    cnt = torch.tensor([(-5, 10, 700, 5000)[i % 4] for i in range(len(rows))],
                       dtype=torch.int32)
    for N in (0, 1, 700):
        got = R.rice_decode(st.to(cuda), off.to(cuda), cnt.to(cuda), N)
        torch.cuda.synchronize()
        _same(got, R.rice_decode_plain(st, off, cnt, N))


def _huffman_rows(seed=0):
    """Residual byte rows for kernel C: random, few symbols, zeros, one
    symbol, 2,000 x 255 (the longest code, 22 bits) and an empty row;
    their streams from the port's encoder and the canned tables on the
    CPU."""
    from honours_tpu_torch.engine.entropy import shuff_encode_batch
    from honours_tpu_torch.engine.pipeline import canned_huffman_tables

    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 256, 5000), rng.integers(0, 40, 3000),
            np.zeros(100, np.int64), np.array([rng.integers(0, 256)]),
            np.full(2000, 255), np.zeros(0, np.int64)]
    N = max(r.size for r in rows)
    data = np.zeros((len(rows), N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    cnt = torch.tensor([r.size for r in rows], dtype=torch.int32)
    tabs = canned_huffman_tables("cpu")
    blob, blen = shuff_encode_batch(torch.from_numpy(data), cnt, tabs)
    # the bit streams, past each blob's 4-byte dataBytes header
    return rows, [blob[i, 4: int(blen[i])].numpy().tobytes()
                  for i in range(len(rows))], cnt, tabs


def _huffman_same(cuda, st, off, cnt, N, tabs):
    """Kernel C on the card equals its plain version; returns the plain
    (out, got)."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine.pipeline import canned_huffman_tables

    got = H.huffman_decode(st.to(cuda) if st.device.type == "cpu" else st,
                           off.to(cuda), cnt.to(cuda), N,
                           canned_huffman_tables(cuda))
    torch.cuda.synchronize()
    want = H.huffman_decode_plain(st.cpu(), off, cnt, N, tabs)
    _same(got, want)
    return want


@pytest.mark.parametrize("pad", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("N", [5000, 5003])
def test_huffman_decode_kernel_matches_plain(cuda, pad, N):
    """Random, longest-code, single-symbol and empty rows, starting
    pad + row % 4 bytes into rows of garbage, on a view at an odd
    address; N % 4 == 0 (word stores) and not."""
    rows, streams, cnt, tabs = _huffman_rows()
    M = max(len(b) for b in streams) + pad + 3
    st = np.full((len(rows), M), 0xEE, np.uint8)
    off = np.zeros(len(rows), np.int32)
    for i, b in enumerate(streams):
        o = pad + i % 4
        st[i, o:] = 0
        st[i, o: o + len(b)] = np.frombuffer(b, np.uint8)
        off[i] = o
    store = torch.zeros(st.size + 16, dtype=torch.uint8)
    store[3: 3 + st.size] = torch.from_numpy(st).reshape(-1)
    view = store.to(cuda)[3: 3 + st.size].view(st.shape)
    assert view.data_ptr() % 4 == 3
    out, got = _huffman_same(cuda, view, torch.from_numpy(off), cnt, N, tabs)
    assert got.tolist() == cnt.tolist()
    for i, r in enumerate(rows):
        assert np.array_equal(out[i, : r.size].numpy(), r), i


def test_huffman_decode_kernel_poisoned_output(cuda):
    """The output block held 0xA5 bytes just before the call: the kernel
    writes every byte of it, each row's symbols up to its count (some
    counts below the row's symbols) and zeros after."""
    from honours_tpu_torch.engine import huffdec_cuda as H
    from honours_tpu_torch.engine.pipeline import canned_huffman_tables

    rows, streams, cnt, tabs = _huffman_rows(1)
    M = max(len(b) for b in streams)
    st = np.zeros((len(rows), M), np.uint8)
    for i, b in enumerate(streams):
        st[i, : len(b)] = np.frombuffer(b, np.uint8)
    cnt = torch.tensor([r.size // (1 + i % 3) for i, r in enumerate(rows)],
                       dtype=torch.int32)
    N = 5000
    stc, off = torch.from_numpy(st).to(cuda), torch.zeros(
        len(rows), dtype=torch.int32)
    bait = torch.full((len(rows), N), 0xA5, dtype=torch.uint8, device=cuda)
    ptr = bait.data_ptr()
    del bait
    out, got = H.huffman_decode(stc, off.to(cuda), cnt.to(cuda), N,
                                canned_huffman_tables(cuda))
    assert out.data_ptr() == ptr
    torch.cuda.synchronize()
    want = H.huffman_decode_plain(torch.from_numpy(st), off, cnt, N, tabs)
    _same((out, got), want)
    for i, r in enumerate(rows):
        c = int(cnt[i])
        assert np.array_equal(want[0][i, :c].numpy(), r[:c]), i
        assert not want[0][i, c:].any(), i


def test_huffman_decode_kernel_stream_at_row_end(cuda):
    """Each row's stream ends at the last byte of its buffer row (its
    last code ending on a byte edge or not; one row is all stream)."""
    rows, streams, cnt, tabs = _huffman_rows(2)
    M = max(len(b) for b in streams)
    st = np.full((len(rows), M), 0xEE, np.uint8)
    off = np.array([M - len(b) for b in streams], np.int32)
    for i, b in enumerate(streams):
        st[i, off[i]:] = np.frombuffer(b, np.uint8)
    assert 0 in off
    out, got = _huffman_same(cuda, torch.from_numpy(st),
                             torch.from_numpy(off), cnt, 5000, tabs)
    assert got.tolist() == cnt.tolist()
    for i, r in enumerate(rows):
        assert np.array_equal(out[i, : r.size].numpy(), r), i


def test_huffman_decode_kernel_cut_streams_and_counts(cuda):
    """Streams cut short, offsets at and past the row's end, counts past
    N or negative: the walk stops where a code would leave the row, and
    faults nowhere."""
    rows, streams, _, tabs = _huffman_rows(3)
    M = 60
    st = np.zeros((len(rows), M), np.uint8)
    for i, b in enumerate(streams):
        st[i, : min(M, len(b))] = np.frombuffer(b[:M], np.uint8)
    off = torch.tensor([(0, 7, M, M + 9)[i % 4] for i in range(len(rows))],
                       dtype=torch.int32)
    cnt = torch.tensor([(-5, 10, 700, 9000)[i % 4] for i in range(len(rows))],
                       dtype=torch.int32)
    for N in (0, 1, 700, 701):
        _huffman_same(cuda, torch.from_numpy(st), off, cnt, N, tabs)


@pytest.mark.parametrize("name", rows.RICE_NAMES)
def test_rice_decode_kernel_adversarial(cuda, name):
    """tests/chunked_rows.py's rows for the chunked decode: unary runs of
    200+ bits across chunk ends (k = 0), chunk ends at every bit offset
    of a code, two tiles, counts ending mid-chunk and past the values,
    all-0xFF rows, cut streams, offsets past M and negative, counts past
    N and negative, N % 4 != 0."""
    from honours_tpu_torch.engine import rice_cuda as R

    st, off, cnt, N = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                       else x for x in rows.rice_cases()[name])
    got = R.rice_decode(st.to(cuda), off.to(cuda), cnt.to(cuda), N)
    torch.cuda.synchronize()
    _same(got, R.rice_decode_plain(st, off, cnt, N))


def test_rice_decode_kernel_poisoned_output(cuda):
    """The output block held 0xA5 bytes just before the call: the kernel
    writes every byte of it, each row's values up to its count (some
    counts below the row's values, one past them, one 0) and zeros
    after, whatever thread owns it."""
    from honours_tpu_torch.engine import rice_cuda as R

    rows_, blobs, _ = _rice_rows(4)
    st = torch.from_numpy(chunked_place(blobs, [0] * len(blobs)))
    cnt = torch.tensor([(r.size // (1 + i % 3) if i % 5 else r.size + 9)
                        for i, r in enumerate(rows_)], dtype=torch.int32)
    cnt[0] = 0
    off = torch.zeros(len(rows_), dtype=torch.int32)
    args = (st.to(cuda), off.to(cuda), cnt.to(cuda))
    for N in (701, 704):
        bait = torch.full((len(rows_), N), 0xA5, dtype=torch.uint8,
                          device=cuda)
        ptr = bait.data_ptr()
        del bait
        out = R.rice_decode(*args, N)
        assert out.data_ptr() == ptr
        torch.cuda.synchronize()
        _same(out, R.rice_decode_plain(st, off, cnt, N))


@pytest.mark.parametrize("name", rows.HUFFMAN_NAMES)
def test_huffman_decode_kernel_adversarial(cuda, name):
    """tests/chunked_rows.py's rows for the chunked decode: random rows
    at odd offsets, counts ending mid-chunk, two tiles, streams ending in
    the zero window's code with counts past it, a window no code starts
    (tables with one symbol's code removed) in a late chunk before and
    after count, cut streams, offsets past M and negative, counts past N
    and negative, N % 4 != 0."""
    from honours_tpu_torch.engine import huffdec_cuda as H

    st, off, cnt, N, tabs = rows.huffman_cases()[name]
    st, off, cnt = map(torch.from_numpy, (st, off, cnt))
    got = H.huffman_decode(st.to(cuda), off.to(cuda), cnt.to(cuda), N,
                           {k: v.to(cuda) for k, v in tabs.items()})
    torch.cuda.synchronize()
    _same(got, H.huffman_decode_plain(st, off, cnt, N, tabs))


def test_shuffman_cut_stream_raises_on_card(cuda):
    from honours_tpu_torch.engine.runner import depress_signals, press_signals
    from honours_tpu_torch.synth import synthesize_corpus

    read = synthesize_corpus(20_000, seed=4)
    st = press_signals([read], "shuffman_vbbe21_zd", device=cuda)[0]
    with pytest.raises(ValueError, match="corrupt"):
        depress_signals([st[: len(st) // 2]], [read.size],
                        "shuffman_vbbe21_zd", device=cuda)


KERNEL_1 = {"monotone_compact_u8", "monotone_compact_i32",
            "compaction_shifts", "monotone_expand_u8", "monotone_expand_i32"}
#: kernel 1's entries on the svb32 paths
SVB32 = {"monotone_compact_u8", "compaction_shifts", "monotone_expand_u8"}
RICE = KERNEL_1 | {"rice_decode"}
DSTALL = KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode", "find_stall"}
KERNELS_OF = {
    "drans_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode"},
    "srans_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o0_decode"},
    "srans2_vbbe21_zd": KERNEL_1 | {"o1_fc", "rans_encode", "o1_decode"},
    "svb12_zd": {"svb16_encode", "svb16_decode"},
    "svb12": {"svb16_encode", "svb16_decode"},
    "srans3_vbbe21_zd": KERNEL_1 | {"rans_encode", "o1n_fc", "n4_decode"},
    "shuffman_vbbe21_zd": KERNEL_1 | {"huffman_decode"},
    "vb1e2_zd": KERNEL_1,
    "vbe21_zd": KERNEL_1,
    "vbbe21_zd": KERNEL_1,
    "vbsbe21_zd": KERNEL_1,
    "vbsse21_zd": KERNEL_1 | {"svb16_encode", "svb16_decode"},
    "svb_zd": SVB32,
    "svb0124_zd": SVB32,
    "hasgam_vbsse21_zdq": KERNEL_1,
    "rice_vbe21_zd": RICE,
    "rice_vbbe21_zd": RICE,
    "rice_vbsbe21_zd": RICE,
    "rice_vbsse21_zd": RICE | {"svb16_encode", "svb16_decode"},
    "dstall_srans2": DSTALL,
    "dstall_drans": DSTALL,
}


@pytest.mark.parametrize("codec", sorted(KERNELS_OF))
def test_decode_kernel_and_runner_round_trip(cuda, codec):
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import depress_signals, press_signals
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus(60_000, seed=3)
    reads = [flat[:20_000], flat[20_000:21_000], flat[21_000:21_001],
             np.tile(np.array([0, 30000], np.int16), 300), flat[30_000:]]
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, codec, device=cuda)
    assert streams == press_signals(reads, codec, device="cpu")
    out = depress_signals(streams, [r.size for r in reads], codec,
                          device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = {k for k, v in KERNELS.items() if v.launches > before.get(k, 0)}
    assert grown == KERNELS_OF[codec]


# ---------------------------------------------------------------------------
# shard/: the sharded engines over torch.distributed, every rank on the card
# ---------------------------------------------------------------------------


def _shard_batches():
    """tests/test_torch_shard.py's srans, srans2 and drans batches, and a
    stall set of 6,000-sample stalls whose one split row (12) lies on
    rank 1 of 2."""
    import torch_shard_worker as worker
    from honours_tpu_torch.synth import stall_set

    return {"srans": worker.srans_batch(), "srans2": worker.srans2_batch(),
            "drans": worker.drans_batch(),
            "dstall_drans": worker.rows(stall_set(0, 6000), 18500)}


@pytest.fixture(scope="module")
def shard_worlds(cuda, tmp_path_factory):
    """A 2-rank gloo world with both ranks on the card, and an NCCL world
    of 1."""
    from torch_shard_worker import run_world

    b = _shard_batches()
    return {W: run_world(b, int(W[-1]), tmp_path_factory.mktemp(W),
                         backend=W[:-1], device="cuda")
            for W in ("gloo2", "nccl1")}


@pytest.mark.parametrize("world", ["gloo2", "nccl1"])
@pytest.mark.parametrize("case", ["srans2", "drans", "dstall_drans"])
def test_sharded_streams_equal_unsharded_on_card(cuda, shard_worlds, world,
                                                 case):
    """Each rank's streams equal one encode of the whole batch on the card,
    and every row decodes."""
    from torch_shard_worker import decoded, gathered

    from honours_tpu_torch.engine.drans import press_drans_batch
    from honours_tpu_torch.engine.dstall_drans import press_dstall_drans_batch
    from honours_tpu_torch.engine.pipeline import (
        canned_o1_device_tables,
        press_srans2_batch,
    )
    from honours_tpu_torch.shard.mesh import pad_rows_to_devices

    results = shard_worlds[world]
    press = {"srans2": press_srans2_batch, "drans": press_drans_batch,
             "dstall_drans": press_dstall_drans_batch}[case]
    sig, n = pad_rows_to_devices(*_shard_batches()[case], len(results))
    st, sl = press(torch.from_numpy(sig).to(cuda), torch.from_numpy(n).to(
        cuda), canned_o1_device_tables(cuda))
    st, sl = st.cpu().numpy(), sl.cpu().numpy()
    rows, blobs = gathered(results, case)
    assert rows == list(range(sig.shape[0]))
    assert blobs == [st[i, : sl[i]].tobytes() for i in range(len(sl))]
    live = np.arange(sig.shape[1])[None, :] < n[:, None]
    assert np.array_equal(decoded(results, case), np.where(live, sig, 0))


@pytest.mark.parametrize("world", ["gloo2", "nccl1"])
def test_sharded_reduced_flags_on_card(cuda, shard_worlds, world):
    """Both reduced host decisions: dstall_drans's "is any row split",
    true on rank 1 only, and drans's G check, failing on the last rank
    only; every rank takes both."""
    results = shard_worlds[world]
    splits = [any(info["split_rows"]) for _, info in results]
    assert splits == ([False, True] if world == "gloo2" else [True])
    for r, (_, info) in enumerate(results):
        assert "group mismatch" in (info["g_mismatch"] or "")
        assert info["collectives"]["drans encode"] == 1
        assert info["collectives"]["drans decode"] == 2
        assert info["collectives"]["srans2 decode"] == 0
        assert info["srans2_encode_body_collective_free"]


def test_nccl_refuses_more_ranks_than_cards(cuda, tmp_path):
    from torch_shard_worker import run_world

    b = {k: (s[:4], n[:4]) for k, (s, n) in _shard_batches().items()}
    with pytest.raises(RuntimeError, match="a card a rank"):
        run_world(b, torch.cuda.device_count() + 1, tmp_path,
                  backend="nccl", device="cuda", timeout_s=120)


@pytest.fixture(scope="module")
def bench_file(tmp_path_factory):
    """A BLOW5 of 12 synthetic reads, a stall read and the three fixture
    reads (zlib records, svb-zd signals), written by the port."""
    from honours_tpu_torch.io import blow5
    from honours_tpu_torch.synth import stall_set, synthesize_corpus

    rng = np.random.default_rng(8)
    lens = rng.integers(1000, 40000, 12)
    flat = synthesize_corpus(int(lens.sum()), seed=8)
    reads = np.split(flat, np.cumsum(lens)[:-1])
    reads += stall_set(0)[:1] + stall_rows.fixture_reads()
    path = tmp_path_factory.mktemp("bench") / "src.blow5"
    blow5.write_blow5(str(path), blow5.Blow5File(
        version=(0, 2, 0), record_press=blow5.RECORD_PRESS_ZLIB,
        signal_press=blow5.SIGNAL_PRESS_SVB_ZD, num_read_groups=1,
        header=b"#\n", reads=[blow5.Blow5Read(
            read_id=f"r{i}", read_group=0, digitisation=2048.0, offset=0.0,
            range=1.0, sampling_rate=4000.0, signal=s)
            for i, s in enumerate(reads)]))
    return path


def _cli_out(capsys, argv):
    from honours_tpu_torch import cli

    assert cli.main(argv) == 0
    return capsys.readouterr().out


def test_analyze_on_card_equals_cpu_and_launches_kernel_a(cuda, bench_file,
                                                          capsys):
    """analyze --per-read on the card reports what the CPU route reports
    (ints and bools exactly, floats within 1e-9 relative), and its stall
    reports came from kernel A."""
    import json
    import math

    from honours_tpu_torch._build import KERNELS

    KERNELS["find_stall"].launches = 0
    ours = json.loads(_cli_out(capsys, ["analyze", str(bench_file),
                                        "--per-read"]))
    assert KERNELS["find_stall"].launches > 0
    theirs = json.loads(_cli_out(capsys, ["analyze", str(bench_file),
                                          "--per-read", "--device", "cpu"]))
    assert ours["aggregate"].keys() == theirs["aggregate"].keys()
    assert any(r["stall"] for r in ours["reads"])
    for a, b in zip([ours["aggregate"], *ours["reads"]],
                    [theirs["aggregate"], *theirs["reads"]]):
        assert list(a) == list(b)
        for k in a:
            assert type(a[k]) is type(b[k]), k
            if isinstance(a[k], float):
                assert math.isclose(a[k], b[k], rel_tol=1e-9), k
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("codec", ["drans_vbbe21_zd", "svb12_zd",
                                   "dstall_drans", "rice_vbbe21_zd"])
def test_harness_rows_on_card_have_cpu_bytes(cuda, bench_file, capsys,
                                             codec):
    def rows(device):
        out = _cli_out(capsys, ["bench", str(bench_file), "--methods", codec,
                                "--device", device])
        return [line.split("\t")[:5] for line in out.strip().splitlines()]

    assert rows("cuda") == rows("cpu")


def test_cuda_trace_names_a_port_kernel(cuda, tmp_path):
    """cuda_trace writes a Chrome trace of the region, and the trace
    names kernel 1 (monotone_compact, csrc/permute.cu)."""
    import json

    from honours_tpu_torch.engine.runner import press_signals
    from honours_tpu_torch.utils.profiling import PhaseTimer, cuda_trace

    reads = [np.arange(5000, dtype=np.int16) % 300,
             np.tile(np.array([0, 30000], np.int16), 300)]
    timer = PhaseTimer()
    with cuda_trace(str(tmp_path)):
        with timer.phase("press", cuda):
            press_signals(reads, "vbbe21_zd")
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]
             if e.get("cat") == "kernel"}
    assert any("compact" in n for n in names), sorted(names)[:20]
    assert timer.counts["press"] == 1 and timer.totals["press"] > 0


@pytest.fixture(scope="module")
def bench_runs(cuda):
    """python -m honours_tpu_torch.bench's main at [8, 4096], one
    synthetic batch, on the card and on the CPU: [(line, run), ...]."""
    import contextlib
    import io
    import json
    from pathlib import Path

    from honours_tpu_torch.bench import driver

    runs = []
    with pytest.MonkeyPatch.context() as mp:
        # the bench reads tests/data/three-reads.blow5 from the working dir
        mp.chdir(Path(__file__).resolve().parent.parent)
        mp.setenv("HTPU_SYNTH_BATCHES", "1")
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                b = driver.main(["--device", device, "--batch", "8",
                                 "--width", "4096"])
            runs.append((json.loads(out.getvalue().strip().splitlines()[-1]),
                         b))
    return runs


def test_bench_main_on_card_every_flag_true(bench_runs):
    """The card's line: nothing skipped but the VBZ ratio where zstandard
    is missing, every lossless and host-parity flag true, the card named."""
    x = bench_runs[0][0]["extra"]
    assert all(s["section"] == "vbz_ratio" and "zstandard" in s["reason"]
               for s in x["skipped"])
    flags = {k: v for k, v in x.items()
             if k.endswith(("_lossless", "_host_parity"))}
    assert len(flags) == 12 and all(v is True for v in flags.values())
    assert torch.cuda.get_device_name(0) in x["card"]
    assert bench_runs[0][0]["value"] > 0


@pytest.mark.parametrize("name", ["srans2", "drans", "drans_tiled", "srans",
                                  "srans3", "dstall", "heldout",
                                  "dstall_drans", "synth_srans2",
                                  "synth_drans"])
def test_bench_section_on_card_has_cpu_lengths(bench_runs, name):
    """Each section's stream lengths on the card are the CPU route's."""
    card, cpu = bench_runs[0][1], bench_runs[1][1]
    assert card.lengths[name] == cpu.lengths[name]


# ---------------------------------------------------------------------------
# reads longer than 262,144 samples (chip_smoke.py phase 9's functions)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke(cuda):
    """chip_smoke.py, loaded by its path (the repo root is no package)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (rows, bucket width, samples a read): two reads of 2^20 + 3 samples in
#: their bucket, and one read filling L = 2^22
LONG_ROWS = {"2 x (2^20 + 3) in [2, 2^21]": (2, 1 << 21, (1 << 20) + 3),
             "[1, 2^22]": (1, 1 << 22, 1 << 22)}


@pytest.mark.parametrize("shape", list(LONG_ROWS))
def test_kernels_match_plain_at_long_rows(smoke, shape):
    """Every kernel on long rows, with the inputs the main paths give it
    (chip_smoke.row_cases: kernel 1's entries, o1_fc, the walks, svb16
    zd on and off, o1n_fc, find_stall, rice_decode, huffman_decode),
    equal to its plain version.  The walks' plain versions (a Python
    loop pass a step) run on copies of their inputs on the host."""
    from honours_tpu_torch.synth import synthesize_corpus

    B, L, m = LONG_ROWS[shape]
    reads = [synthesize_corpus(m, seed=20 + i) for i in range(B)]
    sig, n = smoke.rows_on_card(reads, L)
    names = set()
    for name, kern, plain, *_ in smoke.row_cases(sig, n):
        if isinstance(plain, smoke.Call):
            plain = plain.on_cpu()
        got = smoke.to_cpu(smoke.flatten(kern()))
        want = smoke.to_cpu(smoke.flatten(plain()))
        assert smoke.max_abs_err(got, want) == 0, name
        names.add(name.split()[0])
    assert names == set(smoke.REPLACES)


@pytest.fixture(scope="module")
def long_set(smoke):
    parts = smoke.long_set(0)
    return parts, [r for k in "abcde" for r in parts[k]]


#: the 21 engine codecs (engine/runner.py ENGINE_CODECS)
ENGINE_21 = sorted([
    "drans_vbbe21_zd", "srans_vbbe21_zd", "srans2_vbbe21_zd",
    "srans3_vbbe21_zd", "shuffman_vbbe21_zd", "svb12_zd", "svb12",
    "vb1e2_zd", "vbe21_zd", "vbbe21_zd", "vbsbe21_zd", "vbsse21_zd",
    "svb_zd", "svb0124_zd", "hasgam_vbsse21_zdq", "rice_vbe21_zd",
    "rice_vbbe21_zd", "rice_vbsbe21_zd", "rice_vbsse21_zd", "dstall_srans2",
    "dstall_drans"])


@pytest.mark.parametrize("codec", ENGINE_21)
def test_long_set_round_trips(smoke, long_set, codec):
    """The long-read set (a full bucket at L = 2^20, 8 reads at 2^21, one
    at 2^22, an overflow read on the one-row path, one of 262,145
    samples) through the runner on the card: every read back bit for
    bit, the path's kernels launched (chip_smoke.long_path); the card's
    stream of the 262,145-sample read equals the CPU route's."""
    from honours_tpu_torch.engine.runner import press_signals

    parts, reads = long_set
    _, streams = smoke.long_path(codec, reads, smoke.nvidia_smi())
    (e,) = parts["e"]
    assert streams[-1] == press_signals([e], codec, device="cpu")[0]


@pytest.mark.parametrize("codec", ["rice_vbbe21_zd", "shuffman_vbbe21_zd",
                                   "drans_vbbe21_zd", "dstall_drans"])
def test_full_bucket_in_slices(smoke, long_set, codec):
    """A full [256, 2^21] bucket in more than one slice round-trips, and
    on the [256, 2^20] bucket, which fits unsliced, streams in slices of
    that size equal the unsliced ones (chip_smoke.full_bucket)."""
    assert codec in smoke.FULL_BUCKET
    smoke.full_bucket(codec, long_set[0]["a"], smoke.nvidia_smi())


# ---------------------------------------------------------------------------
# kernels D and E (csrc/rangecoder.cu) and the 25 range-coder codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_kernels_match_plain(smoke, model):
    """D and E at [24, 4096] on chip_smoke.rc_rows (empty, one-byte, 255,
    0, ramp, random and residual-like rows, and tests/rc_rows.py's rows
    whose model-row keys repeat) equal their plain versions (run on the host); one-row
    calls give the same rows, twice (each call starts its model
    afresh)."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC

    data, n = smoke.rc_rows(0)
    d, nc = torch.from_numpy(data).cuda(), torch.from_numpy(n).cuda()
    want = RC.rc_encode_plain(torch.from_numpy(data), torch.from_numpy(n),
                              model)
    got = RC.rc_encode(d, nc, model)
    _same(got, want)
    for _ in range(2):
        one = RC.rc_encode(d[7:8].contiguous(), nc[7:8], model)
        _same(one, (want[0][7:8], want[1][7:8]))
    zero = torch.zeros_like(nc)
    _same(RC.rc_decode(got[0], zero, nc, data.shape[1], model),
          torch.from_numpy(data))


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_decode_cut_streams_offsets_and_caps(smoke, model):
    """E on streams cut short and at odd offsets into their rows, with
    counts past N, equals its plain version; D's stream cap: with slack 0
    a one-byte row's stream passes it, the launch zeroes the row with
    length -1 and rc_encode raises."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC

    data, n = smoke.rc_rows(0, B=4, N=1000)
    full = RC.rc_encode_plain(torch.from_numpy(data), torch.from_numpy(n),
                              model)
    stream = torch.zeros((8, full[0].shape[1] + 64), dtype=torch.uint8)
    offs = torch.tensor([0, 1, 3, 5, 17, 33, 63, 2], dtype=torch.int32)
    cnt = torch.tensor([1000, 1, 700, 1200, 0, 5, 1000, 999],
                       dtype=torch.int32)
    for i in range(8):
        row = full[0][i % 4, : max(int(full[1][i % 4]) - i, 0)]
        stream[i, offs[i]: offs[i] + row.numel()] = row
    want = RC.rc_decode_plain(stream, offs, cnt, 1000, model)
    _same(RC.rc_decode(stream.cuda(), offs.cuda(), cnt.cuda(), 1000, model),
          want)
    d = torch.from_numpy(data[:2, :8]).cuda()
    nn = torch.tensor([1, 8], dtype=torch.int32, device="cuda")
    out, length = RC.rc_encode_launch(d, nn, model, slack=0)
    assert int(length[0]) == -1 and not out[0].any()
    _same((out[1], length[1]), tuple(
        x[1] for x in RC.rc_encode_plain(d.cpu(), nn.cpu(), model, 0)))
    with pytest.raises(ValueError, match="would pass"):
        RC.rc_encode(d, nn, model, slack=0)


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_kernels_match_c_coder_at_main_path_rows(smoke, model):
    """D on the main path's [256, 65536] bucket (chip_smoke.make_bucket's
    rccm_vbbe21_zd residual bytes, rows of up to ~65,000 bytes): every
    row's stream equals the C coder's (honours_tpu.native, the host
    codecs' coder), and E gives every row back from the C's streams."""
    from honours_tpu import native
    from honours_tpu_torch.engine import rangecoder_cuda as RC
    from honours_tpu_torch.engine.rc import vb_zd_parts

    sig, sn = smoke.make_bucket(0)
    _, _, data, n = vb_zd_parts(sig, sn, "vbbe21", sig.shape[1])
    data, n = data.contiguous(), n.to(torch.int32).contiguous()
    counts = n.tolist()
    assert len(counts) == 256 and max(counts) > 60_000
    c_encode = {"o0": native.rc0_encode, "o1": native.rc1_encode,
                "cm": native.rccm_encode}[model]
    rows_ = data.cpu().numpy()
    want = [c_encode(rows_[i, :k]) for i, k in enumerate(counts)]
    out, length = RC.rc_encode(data, n, model)
    got, got_len = out.cpu().numpy(), length.tolist()
    bad = [i for i, w in enumerate(want)
           if got[i, :got_len[i]].tobytes() != w]
    assert not bad, f"rows {bad[:8]} differ from the C coder's streams"
    stream = np.zeros((len(want), max(map(len, want))), np.uint8)
    for i, w in enumerate(want):
        stream[i, :len(w)] = np.frombuffer(w, np.uint8)
    back = RC.rc_decode(torch.from_numpy(stream).cuda(), torch.zeros_like(n),
                        n, data.shape[1], model)
    _same(back, data)


def _rc_matrix(rows, width=None):
    width = width or max(max(r.size for r in rows), 1)
    out = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        out[i, : r.size] = r
    return (torch.from_numpy(out),
            torch.tensor([r.size for r in rows], dtype=torch.int32))


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_kernels_on_aliasing_rows(cuda, model):
    """D and E on rows whose model-row keys repeat (rc_rows.aliasing_rows:
    a run, ABAB, ABCABC, a cycle of 5, residual-like runs, and cycles of
    17, 33 and 9 bytes, which miss cm's row slots every byte, so each row
    is fetched right after its write-back) equal their plain versions,
    tolerance 0, in one call and a row alone."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC

    data, n = _rc_matrix(rc_rows.aliasing_rows(22))
    want = RC.rc_encode_plain(data, n, model)
    got = RC.rc_encode(data.cuda(), n.cuda(), model)
    _same(got, want)
    for i in (2, 6):
        _same(RC.rc_encode(data[i:i + 1].cuda(), n[i:i + 1].cuda(), model),
              (want[0][i:i + 1], want[1][i:i + 1]))
    zero = torch.zeros_like(n)
    N = data.shape[1]
    back = RC.rc_decode(want[0].cuda(), zero.cuda(), n.cuda(), N, model)
    _same(back, RC.rc_decode_plain(want[0], zero, n, N, model))
    _same(back, data)


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_decode_streams_across_window_segments(cuda, model):
    """E reads its coder stream through a warp's window of 512-byte
    segments (htt_walk::Window, 2,048 bytes resident or in flight):
    streams of 900-3,000 bytes that start at offsets around a segment
    edge and the window's end (0, 1, 15, 16, 496, 511, 512, 513, 2047,
    2048, 2049) in rows 7 bytes past a segment's start, some cut at a
    segment edge, decode as the plain version decodes them."""
    from honours_tpu_torch.engine import rangecoder_cuda as RC

    rng = np.random.default_rng(22)
    src = [rng.integers(0, 256, 3000).astype(np.uint8),
           np.minimum(rng.geometric(0.1, 3000), 255).astype(np.uint8),
           rc_rows.cycle_row(33, 7, 2500)]
    data, n = _rc_matrix(src)
    full, length = RC.rc_encode_plain(data, n, model)
    offs = [0, 1, 15, 16, 496, 511, 512, 513, 2047, 2048, 2049]
    M = 2049 + int(length.max())
    M += (512 + 7 - M % 512) % 512  # 7 bytes into a segment
    stream = torch.zeros((len(offs), M), dtype=torch.uint8)
    cnt = torch.zeros(len(offs), dtype=torch.int32)
    for i, o in enumerate(offs):
        k = i % 3
        keep = int(length[k])
        if i % 4 == 3:  # cut where the row's next segment starts
            keep = min(keep, 512 - o % 512 + 512)
        stream[i, o: o + keep] = full[k, :keep]
        cnt[i] = int(n[k]) + (5 if i == 5 else 0)
    offs_t = torch.tensor(offs, dtype=torch.int32)
    want = RC.rc_decode_plain(stream, offs_t, cnt, 3000, model)
    got = RC.rc_decode(stream.cuda(), offs_t.cuda(), cnt.cuda(), 3000, model)
    _same(got, want)
    for i in (0, 4, 8):  # whole streams give their rows back
        assert torch.equal(want[i, : n[i % 3]], data[i % 3, : n[i % 3]])


@pytest.mark.parametrize("model", ["o0", "o1", "cm"])
def test_rc_kernels_past_one_wave(cuda, model):
    """A bucket of 300 rows, more than the 264 reads one wave holds (2 a
    block on each of 132 SMs): D's streams equal the C coder's
    (honours_tpu.native) and E gives every row back from them."""
    from honours_tpu import native
    from honours_tpu_torch.engine import rangecoder_cuda as RC

    rng = np.random.default_rng(300)
    src = []
    for i in range(300):
        m = int(rng.integers(0, 1500))
        src.append(np.minimum(rng.geometric(0.15, m), 255).astype(np.uint8)
                   if i % 3 else rc_rows.aliasing_row(
                       rc_rows.PATTERNS[i % 5], i, m))
    data, n = _rc_matrix(src)
    c_encode = {"o0": native.rc0_encode, "o1": native.rc1_encode,
                "cm": native.rccm_encode}[model]
    want = [c_encode(r) for r in src]
    out, length = RC.rc_encode(data.cuda(), n.cuda(), model)
    got, got_len = out.cpu().numpy(), length.tolist()
    bad = [i for i, w in enumerate(want)
           if got[i, :got_len[i]].tobytes() != w]
    assert not bad, f"rows {bad[:8]} differ from the C coder's streams"
    stream, _ = _rc_matrix([np.frombuffer(w, np.uint8) for w in want])
    back = RC.rc_decode(stream.cuda(), torch.zeros_like(n).cuda(), n.cuda(),
                        data.shape[1], model)
    _same(back, data)


def _rc_reads():
    from honours_tpu_torch.synth import synthesize_corpus

    rng = np.random.default_rng(18)
    flat = synthesize_corpus(2000, seed=18)
    stall = np.concatenate([rng.integers(200, 1000, 300),
                            600 + rng.integers(-4, 5, 400),
                            rng.integers(200, 1000, 300)]).astype(np.int16)
    return [flat[:1000], flat[1000:1400], flat[1500:1501],
            np.zeros(0, np.int16), np.tile(np.array([0, 30000], np.int16),
                                           300), stall]


@pytest.mark.parametrize("codec", sorted([
    f"{c}_{k}_zd" for c in ("rc", "rcc", "rccm")
    for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")] + [
    f"{c}_{k}" for c in ("rc", "rccm")
    for k in ("vbbe21", "vbsbe21", "vbsse21")] + [
    "rc_zd", "rccm_svb_zd", "rccm_svb12_zd", "rccm_vbbe21_submin",
    "rccm_svbbe21_zd", "dstall_fz_1500", "dstall_fz"]))
def test_rc_codecs_on_card_equal_cpu(cuda, codec):
    """Each range-coder codec through the runner on the card: its streams
    equal the CPU route's (an empty read, an overflow read and a stall
    read among them), every read back, D and E launched."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import depress_signals, press_signals

    reads = _rc_reads()
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, codec, device=cuda)
    assert streams == press_signals(reads, codec, device="cpu")
    out = depress_signals(streams, [r.size for r in reads], codec,
                          device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = {k for k, v in KERNELS.items() if v.launches > before.get(k, 0)}
    assert {"rc_encode", "rc_decode"} <= grown


# ---------------------------------------------------------------------------
# kernels F, G (rccdf), H (Huffman table build) and C2 (per-row-table
# Huffman decode), and the 11 per-read entropy codecs
# ---------------------------------------------------------------------------


def _bucket_residuals(codec: str):
    """The residual bytes (and counts) of `codec`'s exception block over
    the main path's bucket [256, 65536], on the card."""
    from honours_tpu_torch.engine.rc import vb_zd_parts
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(256, 1 << 16, 0)
    kind = codec.split("_")[1]
    _, _, data, dlen = vb_zd_parts(torch.from_numpy(sig).cuda(),
                                   torch.from_numpy(n).cuda(), kind, 1 << 16)
    return data.contiguous(), dlen.to(torch.int32).contiguous()


def _rccdf_encode_poisoned(data, dlen, freqs, cum):
    """Kernel F into memory that held 0xA5 bytes: blocks of the outputs'
    sizes are filled and freed just before the call, so the caching
    allocator hands them to the wrapper's outputs (the kernel writes
    every byte of its rows, the zeros past each length too)."""
    from honours_tpu_torch.engine import rccdf_cuda as RC
    from honours_tpu_torch.engine.rccdf import body_width

    B, N = data.shape
    bait = (torch.full((B, body_width(N)), 0xA5, dtype=torch.uint8,
                       device=data.device),
            torch.full((B,), -0x5A5A5A5A5A5A5A5B, dtype=torch.int64,
                       device=data.device))
    ptrs = [x.data_ptr() for x in bait]
    del bait
    got = RC.rccdf_encode(data, dlen, freqs, cum)
    assert [x.data_ptr() for x in got] == ptrs
    return got


def _rccdf_same(data, dlen):
    """F (its outputs in poisoned memory) and G on the card equal their
    plain versions on (data, dlen), and G gives the rows back."""
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC

    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen)).to(torch.int32)
    cum = R.cum_of(freqs).to(torch.int32)
    got = _rccdf_encode_poisoned(data, dlen, freqs, cum)
    torch.cuda.synchronize()
    want = R.rccdf_encode_plain(data, dlen, freqs, cum)
    _same(got, want)
    body = got[0]
    zero = torch.zeros_like(dlen)
    back = RC.rccdf_decode(body, zero, dlen, freqs, data.shape[1])
    torch.cuda.synchronize()
    _same(back, R.rccdf_decode_plain(body, zero, dlen, freqs, data.shape[1]))
    _same(back, data)
    return body, freqs


def _edge_rows(smoke):
    """chip_smoke.py's [24, 4096] edge rows (rc_rows: empty, one byte,
    255s, zeros, a ramp, random bytes, residual-like rows and rows of
    repeating bytes), as tensors."""
    data, n = smoke.rc_rows(19)
    return torch.from_numpy(data), torch.from_numpy(n)


def test_rccdf_kernels_match_plain(smoke):
    """F and G at [24, 4096] on edge rows; G at odd offsets into rows of
    garbage, with counts cut short and past the row, on a stream cut
    mid-lane, and on a wrong table."""
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC

    data, dlen = _edge_rows(smoke)
    body, freqs = _rccdf_same(data.cuda(), dlen.cuda())
    B, W = body.shape
    g = torch.Generator().manual_seed(19)
    pad = torch.arange(B, dtype=torch.int32) % 5
    st = torch.randint(0, 256, (B, W + 5), generator=g, dtype=torch.uint8)
    for i in range(B):
        st[i, int(pad[i]): int(pad[i]) + W] = body[i].cpu()
    for cnt in (dlen, dlen // 2, dlen + 100):
        cnt = cnt.clamp(max=4096).to(torch.int32)
        for s in (st, st[:, : W // 3].contiguous()):
            got = RC.rccdf_decode(s.cuda(), pad.cuda(), cnt.cuda(),
                                  freqs, 4096)
            _same(got, R.rccdf_decode_plain(s, pad, cnt, freqs.cpu(), 4096))
    wrong = freqs.roll(1, dims=1).contiguous()
    got = RC.rccdf_decode(st.cuda(), pad.cuda(), dlen.cuda(), wrong, 4096)
    _same(got, R.rccdf_decode_plain(st, pad, dlen, wrong.cpu(), 4096))


def test_rccdf_kernels_at_main_path_rows(cuda):
    """F and G on rccdf_vbbe21_zd's residual bytes of the main path's
    bucket [256, 65536]."""
    _rccdf_same(*_bucket_residuals("rccdf_vbbe21_zd"))


def _byte_rows(rows, N: int, cuda):
    """Byte rows padded to [B, N] u8 and their lengths int32, on the
    card."""
    data = np.zeros((len(rows), N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    return (torch.from_numpy(data).to(cuda),
            torch.tensor([r.size for r in rows], dtype=torch.int32,
                         device=cuda))


def test_rccdf_encode_one_symbol_and_ragged_lanes(cuda):
    """F (and G) on rows of one symbol (f = 4096: the state only grows
    by x // 4096 << 12, no byte emitted until it passes 2^31) of 1 to
    5,000 bytes, and on rows whose 16 lanes end at different steps: n = 0
    .. 17, 31, 33, 1000 and 4095 random bytes."""
    from honours_tpu_torch.engine import rccdf as R

    rng = np.random.default_rng(41)
    one = [np.full(k, 42, np.uint8) for k in (1, 2, 15, 16, 17, 4096, 4097,
                                             5000)]
    ragged = [rng.integers(0, 256, k).astype(np.uint8)
              for k in [*range(18), 31, 33, 1000, 4095]]
    data, dlen = _byte_rows(one + ragged, 5000, cuda)
    freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen))
    assert (freqs[: len(one), 42] == 4096).all()
    _rccdf_same(data, dlen)


def test_rccdf_encode_many_chunks(cuda):
    """F (and G) on rows that take many of its staged chunks (4,096
    bytes, 256 lane steps): residual-like rows of 70,001 bytes (18
    chunks), rows ending a byte either side of the fourth chunk's end, a
    row of 16 whole chunks of random bytes, and a row of 70,000 bytes
    that emits two bytes at many steps (rare symbols)."""
    rng = np.random.default_rng(43)
    geo = [np.minimum(rng.geometric(p, 70_001), 255).astype(np.uint8)
           for p in (0.05, 0.3, 0.6)]
    edge = [np.minimum(rng.geometric(0.2, 4 * 4096 + d), 255).astype(
        np.uint8) for d in (-1, 0, 1)]
    rare = np.where(rng.random(70_000) < 0.97, 7,
                    rng.integers(0, 256, 70_000)).astype(np.uint8)
    rows = geo + edge + [rng.integers(0, 256, 16 * 4096).astype(np.uint8),
                         rare]
    _rccdf_same(*_byte_rows(rows, 70_001, cuda))


def _decode_both(st, off, cnt, freqs, N: int, cuda):
    """Kernel G into memory that held 0xA5 bytes (a block of its output's
    size filled and freed just before the call: the kernel writes every
    byte of its rows, the zeros past count too) against its plain version
    on the host."""
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC

    st, off, cnt, freqs = (torch.as_tensor(a) for a in (st, off, cnt, freqs))
    off, cnt, freqs = (a.to(torch.int32) for a in (off, cnt, freqs))
    args = [a.to(cuda) for a in (st, off, cnt, freqs)]
    bait = torch.full((st.shape[0], N), 0xA5, dtype=torch.uint8, device=cuda)
    ptr = bait.data_ptr()
    del bait
    got = RC.rccdf_decode(*args, N)
    assert got.numel() == 0 or got.data_ptr() == ptr
    torch.cuda.synchronize()
    _same(got, R.rccdf_decode_plain(st, off, cnt, freqs, N).to(cuda))
    return got


def test_rccdf_decode_kernel_edges(cuda):
    """G on rows the encode never writes, over poisoned output memory:
    states with bit 31 set (0xFFFFFFFF and random), a one-symbol table (f
    = 4096), tables whose sum falls short of 4096 with f = 0 (and f != 0)
    for symbol 255 past it, tables summing past 4096, lanes of very
    unequal length (0, 1 and thousands of bytes, and lengths that put a
    lane's start past the row), rows cut short of their lanes (bytes past
    the row read 0), odd body offsets, and counts 0, 1, short of N and N
    (the zeros past them written by the kernel)."""
    from honours_tpu_torch.kernels.rans import M as M_SLOTS

    rng = np.random.default_rng(59)
    B, W, N = 8, 9000, 4000
    st = rng.integers(0, 256, (B, W)).astype(np.uint8)
    off = np.arange(B) % 5
    for i in range(B):
        lens = rng.integers(0, 400, 16)
        if i % 2:
            lens[[0, 3, 9]] = [0, 1, 6000]
        if i == 7:
            lens[4] = 0xFFFFFFFF
        st[i, off[i] + 64: off[i] + 128] = lens.astype("<u4").view(np.uint8)
    for i in range(3):
        st[i, off[i]: off[i] + 64] = 0xFF
    st[3, 3: 3 + 64] = np.where(np.arange(64) % 4 == 3, 0x80 | st[3, 3: 67],
                                st[3, 3: 67])
    good = np.zeros(256, np.int64)
    good[:200] = rng.integers(1, 30, 200)
    good[0] += M_SLOTS - good.sum()
    tables = {
        "fitted": np.tile(good, (B, 1)),
        "one symbol": np.eye(256, dtype=np.int64)[[0, 42, 255, 7] * 2] *
        M_SLOTS,
        "f = 0 past the sum": np.where(np.arange(256) < 180,
                                       rng.integers(0, 20, (B, 256)), 0),
        "f past the sum": np.where(np.arange(256) < 100, rng.integers(
            0, 30, (B, 256)), 0) + np.eye(256, dtype=np.int64)[255] * 9,
        "sum past 4096": rng.integers(0, M_SLOTS + 1, (B, 256)),
    }
    for counts in ([N] * B, [0, 1, 17, 511, 512, 513, N - 1, N],
                   [0] * B):
        for name, freqs in tables.items():
            for rows in (st, st[:, :100].copy()):
                _decode_both(rows, off, counts, freqs, N, cuda)


def test_rccdf_decode_kernel_one_row_of_2_22(cuda):
    """F and G on rccdf_vbbe21_zd's residual bytes of one read of 2^22
    samples (tens of thousands of lane steps, hundreds of ring fills a
    lane) and of two of 2^21 + 3: G gives the rows back over poisoned
    output memory, the plain decode's bytes on valid streams (held to it
    on the host by tests/test_torch_rccdf_model.py)."""
    from honours_tpu_torch.engine import rccdf as R
    from honours_tpu_torch.engine import rccdf_cuda as RC
    from honours_tpu_torch.engine.rc import vb_zd_parts
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus((1 << 22) + 9, seed=37)
    for lens in ([1 << 22], [(1 << 21) + 3, (1 << 21) + 3]):
        L = max(lens)
        sig = torch.zeros((len(lens), L), dtype=torch.int16)
        a = 0
        for i, m in enumerate(lens):
            sig[i, :m] = torch.from_numpy(flat[a: a + m])
            a += m
        n = torch.tensor(lens, dtype=torch.int32)
        _, _, data, dlen = vb_zd_parts(sig.to(cuda), n.to(cuda), "vbbe21", L)
        data, dlen = data.contiguous(), dlen.to(torch.int32).contiguous()
        freqs = R.fit_freqs_batch(R.byte_histogram(data, dlen)).to(
            torch.int32)
        body, _ = RC.rccdf_encode(data, dlen, freqs,
                                  R.cum_of(freqs).to(torch.int32))
        assert int(dlen.max()) > 16 * 4 * 128
        bait = torch.full(data.shape, 0xA5, dtype=torch.uint8, device=cuda)
        ptr = bait.data_ptr()
        del bait
        back = RC.rccdf_decode(body, torch.zeros_like(dlen), dlen, freqs,
                               data.shape[1])
        assert back.data_ptr() == ptr
        _same(back, data)


def _build_poisoned(hist):
    """Kernel H into memory that held 0xA5 bytes: blocks of the outputs'
    sizes are filled and freed just before the call, so the caching
    allocator hands them to the wrapper's outputs."""
    from honours_tpu_torch.engine import huffman as Hf

    B = hist.shape[0]
    bait = (torch.full((B, 256), -0x5A5A5A5B, dtype=torch.int32,
                       device=hist.device),
            torch.full((B, 256), -0x5A5A5A5A5A5A5A5B, dtype=torch.int64,
                       device=hist.device))
    ptrs = [x.data_ptr() for x in bait]
    del bait
    got = Hf.huffman_build(hist)
    assert [x.data_ptr() for x in got] == ptrs
    return got


def test_huffman_build_kernel_matches_plain(cuda):
    """H against its plain version and build_table (tables/huffman.py) on
    ties (all equal, 1 1 1 2, pairs equal to merged sums), Fibonacci
    counts to depth 31 and 32, a lone symbol, an empty row and random
    histograms, and on the tie-heavy histograms that reach its run rule
    (entropy_rows.tie_histograms: merged sums equal to a run of internal
    nodes not yet taken, 256 symbols of count 1, counts 1-2 at random,
    [1, 1, 2, 2, 4, 4, ...]); then on the bucket's residual histograms.
    Every output lands in memory poisoned just before the call."""
    from honours_tpu_torch.engine import huffman as Hf
    from honours_tpu_torch.engine.rccdf import byte_histogram
    from honours_tpu_torch.tables.huffman import build_table

    rng = np.random.default_rng(19)
    hs = [np.zeros(256, np.int64), np.ones(256, np.int64),
          fib_hist(31), fib_hist(32, at=200), fib_hist(22, at=7)]
    h = np.zeros(256, np.int64)
    h[[3, 9, 11, 200]] = [1, 1, 1, 2]
    hs.append(h)
    h = np.zeros(256, np.int64)
    h[40] = 12345
    hs.append(h)
    h = np.zeros(256, np.int64)
    h[:8] = [2, 2, 4, 4, 8, 8, 16, 16]
    hs.append(h)
    for _ in range(56):
        k = int(rng.integers(1, 257))
        h = np.zeros(256, np.int64)
        h[rng.choice(256, k, replace=False)] = rng.integers(
            1, int(rng.integers(2, 40)), k)
        hs.append(h)
    hs += tie_histograms()
    hist = torch.from_numpy(np.stack(hs))
    got = _build_poisoned(hist.cuda())
    torch.cuda.synchronize()
    want = Hf.huffman_build_plain(hist)
    _same(got, want)
    for i, h in enumerate(hs):
        t = build_table(h)
        assert np.array_equal(want[0][i].numpy(), t.lengths), i
        assert np.array_equal(want[1][i].numpy().astype(np.uint64),
                              t.codes), i
    data, dlen = _bucket_residuals("huffman_vbbe21_zd")
    bh = byte_histogram(data, dlen)
    _same(_build_poisoned(bh), Hf.huffman_build_plain(bh.cpu()))


def _c2_case(data, dlen):
    """The huffman bodies of (data, dlen) on the CPU route and their
    parsed tables -> (stream, off, count, lengths, codes)."""
    from honours_tpu_torch.engine import huffman as Hf
    from honours_tpu_torch.engine.permute import rowwise_concat

    segs, W = Hf.encode_huffman_batch(data.cpu(), dlen.cpu())
    st, _ = rowwise_concat(segs, W)
    t = Hf.parse_tables_batch(st, torch.zeros_like(dlen, dtype=torch.int64))
    cnt = torch.minimum(t["data_bytes"], dlen.to(torch.int64))
    return (st, t["end"].to(torch.int32), cnt.to(torch.int32),
            t["lengths"], t["codes"])


def _c2_same(st, off, cnt, N, lengths, codes):
    from honours_tpu_torch.engine import huffdec_cuda as H

    got = H.huffman_decode_rows(st.cuda(), off.cuda(), cnt.cuda(), N,
                                lengths.cuda(), codes.cuda())
    torch.cuda.synchronize()
    want = H.huffman_decode_rows_plain(st.cpu(), off.cpu(), cnt.cpu(), N,
                                       lengths.cpu(), codes.cpu())
    _same(got, want)
    return want


def test_huffman_decode_rows_kernel_matches_plain(cuda, smoke):
    """C2 at [24, 4096] on edge rows with their own tables (a lone
    symbol's length-0 table and an empty one among them): every row
    back; at odd offsets into garbage on a view at an odd address; with
    counts cut short and past the codes; on cut streams; on tables of
    another row; over poisoned output memory."""
    data, dlen = _edge_rows(smoke)
    st, off, cnt, lengths, codes = _c2_case(data, dlen)
    out, got = _c2_same(st, off, cnt, 4096, lengths, codes)
    assert got.tolist() == dlen.tolist()
    _same(out, data)
    B, W = st.shape
    g = torch.Generator().manual_seed(20)
    store = torch.randint(0, 256, (B * (W + 8) + 16,), generator=g,
                          dtype=torch.uint8)
    view = store[3: 3 + B * (W + 8)].view(B, W + 8)
    pad = torch.arange(B, dtype=torch.int32) % 5
    for i in range(B):
        view[i, int(pad[i]): int(pad[i]) + W] = st[i]
    cview = store.cuda()[3: 3 + B * (W + 8)].view(B, W + 8)
    assert cview.data_ptr() % 4 == 3
    from honours_tpu_torch.engine import huffdec_cuda as H

    got = H.huffman_decode_rows(cview, (off + pad).cuda(), cnt.cuda(), 4096,
                                lengths.cuda(), codes.cuda())
    _same(got, H.huffman_decode_rows_plain(view, off + pad, cnt, 4096,
                                           lengths, codes))
    for c in (cnt // 3, cnt + 500):
        _c2_same(st, off, c.clamp(max=4096).to(torch.int32), 4096, lengths,
                 codes)
    _c2_same(st[:, : W // 2].contiguous(), off, cnt, 4096, lengths, codes)
    _c2_same(st, off, cnt, 4096, lengths.roll(1, dims=0).contiguous(),
             codes.roll(1, dims=0).contiguous())
    torch.cuda.empty_cache()
    junk = torch.full((B, 4096), 0xA5, dtype=torch.uint8, device=cuda)
    del junk
    _c2_same(st, off, cnt, 4096, lengths, codes)


def test_huffman_decode_rows_kernel_long_codes(cuda):
    """C2 on rows whose tables have codes of 23, 31 and 32 bits (Fibonacci
    histograms), each code used, at their row's last byte too."""
    from honours_tpu_torch.engine import huffman as Hf

    rng = np.random.default_rng(21)
    rows = []
    for depth in (23, 31, 32):
        h = fib_hist(depth)
        L, _ = Hf.huffman_build_plain(torch.from_numpy(h)[None])
        syms = np.nonzero(h)[0]
        r = rng.choice(syms, 3000).astype(np.uint8)
        r[:len(syms)] = syms
        assert int(L.max()) == depth
        rows.append(r)
    data = torch.from_numpy(np.stack(rows))
    dlen = torch.full((3,), 3000, dtype=torch.int32)
    st, off, cnt, lengths, codes = _c2_case(data, dlen)
    out, got = _c2_same(st, off, cnt, 3000, lengths, codes)
    _same(out, data)
    assert got.tolist() == [3000] * 3


def test_huffman_decode_rows_at_main_path_rows(cuda):
    """H and C2 on huffman_vbbe21_zd's residual bytes of the main path's
    bucket [256, 65536]: C2 equals its plain version and gives the rows
    back."""
    from honours_tpu_torch.engine import huffman as Hf
    from honours_tpu_torch.engine.permute import rowwise_concat

    data, dlen = _bucket_residuals("huffman_vbbe21_zd")
    segs, W = Hf.encode_huffman_batch(data, dlen)
    st, _ = rowwise_concat(segs, W)
    t = Hf.parse_tables_batch(st, torch.zeros_like(dlen, dtype=torch.int64))
    cnt = torch.minimum(t["data_bytes"], dlen.to(torch.int64)).to(
        torch.int32)
    out, got = _c2_same(st, t["end"].to(torch.int32), cnt, data.shape[1],
                        t["lengths"], t["codes"])
    _same(out, data.cpu())


def _entropy_reads():
    """Reads for the codecs on the card: a main-path-like read, short
    ones, the empty read, an overflow read and a read whose Huffman
    table has a code of more than 22 bits."""
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus(3000, seed=19)
    return [flat[:2000], flat[2000:2400], flat[2500:2501],
            np.zeros(0, np.int16),
            np.tile(np.array([0, 30000], np.int16), 300)]


ENTROPY_KERNELS = {"rccdf": {"rccdf_encode", "rccdf_decode"},
                   "huffman": {"huffman_build", "huffman_decode_rows"},
                   "shuffman": {"huffman_decode"}}


@pytest.mark.parametrize("codec", sorted(
    [f"{c}_{k}_zd" for c in ("rccdf", "huffman")
     for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")]
    + [f"shuffman_{k}_zd" for k in ("vbe21", "vbsbe21", "vbsse21")]))
def test_entropy_codecs_on_card_equal_cpu(cuda, codec):
    """Each per-read entropy codec through the runner on the card: its
    streams equal the CPU route's, every read back, its kernels (and
    kernel 1, and svb16 for vbsse21) launched."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import depress_signals, press_signals

    reads = _entropy_reads()
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, codec, device=cuda)
    assert streams == press_signals(reads, codec, device="cpu")
    out = depress_signals(streams, [r.size for r in reads], codec,
                          device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = {k for k, v in KERNELS.items() if v.launches > before.get(k, 0)}
    want = ENTROPY_KERNELS[codec.split("_")[0]] | {"monotone_compact_u8"}
    if "vbsse21" in codec:
        want |= {"svb16_encode", "svb16_decode"}
    assert want <= grown


def test_huffman_codec_long_codes_on_card(cuda):
    """huffman_vbbe21_zd over a read whose residual bytes have a
    Fibonacci histogram (a code of 24 bits): the card's stream equals
    the CPU route's and comes back."""
    from honours_tpu_torch.engine.runner import depress_signals, press_signals

    read = long_code_read()
    (st,) = press_signals([read], "huffman_vbbe21_zd", device=cuda)
    assert [st] == press_signals([read], "huffman_vbbe21_zd", device="cpu")
    (back,) = depress_signals([st], [read.size], "huffman_vbbe21_zd",
                              device=cuda)
    assert np.array_equal(back, read)


# ---------------------------------------------------------------------------
# kernels I-L and the raw-sample codecs
# ---------------------------------------------------------------------------


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pack_both(values, val_off, count, width, O, out_off, cuda):
    """Kernel I and its plain version over output memory poisoned with
    0xA5 (bytes outside the rows must keep it)."""
    from honours_tpu_torch.engine import bitpack, bitpack_cuda

    poison = torch.full((O,), 0xA5, dtype=torch.uint8)
    args = (values, val_off, count, width)
    got = bitpack_cuda.pack_msb(*[a.to(cuda) for a in args],
                                poison.clone().to(cuda), out_off.to(cuda))
    want = bitpack.pack_msb_plain(*args, poison.to(values.device), out_off)
    _same(got, want)
    return want


def _unpack_both(stream, in_off, in_len, count, width, O, out_off, cuda):
    from honours_tpu_torch.engine import bitpack, bitpack_cuda

    fill = torch.full((O,), -7, dtype=torch.int32)
    args = (stream, in_off, in_len, count, width)
    got = bitpack_cuda.unpack_msb(*[a.to(cuda) for a in args],
                                  fill.clone().to(cuda), out_off.to(cuda))
    want = bitpack.unpack_msb_plain(*args, fill.to(stream.device), out_off)
    _same(got, want)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitpack_kernels_match_plain(cuda, seed):
    """I and J on ragged rows: every width 0..16 (b = 0 writes nothing),
    counts 0, 1, 2 and random, 32-bit values of which only the low b bits
    count, rows at random offsets with gaps between their outputs; J on
    the packed rows whole, cut to half their bytes and past their end (a
    byte past a row reads as 0), at those offsets and one byte on; J's
    fields equal the values' low bits."""
    import raw_rows

    values, val_off, count, width = raw_rows.ragged_rows(seed)
    nbytes = (count * width + 7) // 8
    out_off, O = raw_rows.layout(nbytes, seed)
    v, vo, c, w, oo = _t(values, val_off, count, width, out_off)
    packed = _pack_both(v, vo, c, w, O, oo, cuda)
    f_off, F = raw_rows.layout(count, seed + 5)
    fo = torch.from_numpy(f_off)
    for in_off, in_len in ((oo, torch.from_numpy(nbytes)),
                           (oo, torch.from_numpy(nbytes // 2)),
                           (oo + 1, torch.from_numpy(nbytes + 3))):
        out = _unpack_both(packed, in_off, in_len, c, w, F, fo, cuda)
    out = _unpack_both(packed, oo, torch.from_numpy(nbytes), c, w, F, fo,
                       cuda)
    for r in range(len(count)):
        k, b = int(count[r]), int(width[r])
        field = out[int(f_off[r]): int(f_off[r]) + k].numpy().astype(np.int64)
        src = values[val_off[r]: val_off[r] + k].astype(np.int64)
        assert np.array_equal(field, src & ((1 << b) - 1)), r


@pytest.mark.parametrize("b", [1, 11, 16])
def test_bitpack_kernels_one_row_of_2_22(cuda, b):
    """I and J on one row of 2^22 fields (a long read's uint stream) and
    on two rows of 2^21 + 3, against their plain versions on the card."""
    g = torch.Generator().manual_seed(b)
    for counts in ([1 << 22], [(1 << 21) + 3, (1 << 21) + 3]):
        V = sum(counts)
        v = torch.randint(0, 1 << 16, (V,), generator=g, dtype=torch.int32)
        c = torch.tensor(counts, dtype=torch.int64)
        w = torch.full_like(c, b)
        vo = torch.cumsum(c, 0) - c
        nb = (c * b + 7) // 8
        oo = torch.cumsum(nb, 0) - nb
        O = int(nb.sum())
        packed = _pack_both(v.to(cuda), vo.to(cuda), c.to(cuda), w.to(cuda),
                            O, oo.to(cuda), cuda)
        out = _unpack_both(packed.to(cuda), oo.to(cuda), nb.to(cuda),
                           c.to(cuda), w.to(cuda), V, vo.to(cuda), cuda)
        _same(out, v.to(cuda) & ((1 << b) - 1))


@pytest.mark.parametrize("shape", ["turbopfor", "flats", "uint"])
def test_bitpack_kernels_callers_rows(cuda, shape):
    """I and J on rows shaped as each caller lays them out
    (raw_rows.caller_rows: turbopfor's blocks of 128 fields, flats'
    short segments with empty rows among them, uint's long rows), at
    their output offsets and at those offsets + 1 (every row's bytes at an
    odd address), over poisoned output memory."""
    import raw_rows

    values, val_off, count, width, out_off, O = raw_rows.caller_rows(shape, 3)
    nbytes = (count * width + 7) // 8
    v, vo, c, w = _t(values, val_off, count, width)
    for shift in (0, 1):
        oo = torch.from_numpy(out_off + shift)
        packed = _pack_both(v, vo, c, w, O + 1, oo, cuda)
        _unpack_both(packed, oo, torch.from_numpy(nbytes), c, w,
                     values.size, vo, cuda)


def _flats_same(reads, step, cuda, L=None):
    import raw_rows
    from honours_tpu_torch.engine import flats, flats_cuda

    sig, n = _t(*raw_rows.pad_rows(reads, L))
    got = flats_cuda.flats_partition(sig.to(cuda), n.to(cuda), step)
    want = flats.flats_partition_plain(sig.to(cuda), n.to(cuda), step)
    _same(got, want)
    return want


@pytest.mark.parametrize("step", [64, 8, 17])
def test_flats_kernel_matches_plain(cuda, step):
    """K against its plain version on the card: empty, one- and
    two-sample reads, flat runs, the tie read (repeated: the least i must
    win every tie), small-alphabet reads with many ties, a walk, random
    full-range samples, a length no multiple of the step."""
    import raw_rows

    _flats_same(raw_rows.flats_reads(step), step, cuda)


def test_flats_kernel_tie_takes_the_least_i(cuda):
    """The tie read: the one-segment and the split partitions both cost 7
    bytes, and K keeps one segment (cuts at 0 and 2 only)."""
    import raw_rows

    read, step = raw_rows.tie_read()
    cut = _flats_same([read], step, cuda)
    assert cut[0].tolist() == [1, 0, 1]


@pytest.mark.parametrize("L,step", [(1 << 19, 16), (1 << 22, 64)])
def test_flats_kernel_state_in_scratch(cuda, L, step):
    """K where a read's DP state passes the shared memory (m = 32,768 and
    65,536 chunks: the memory design, its state in scratch): a
    read of L samples and a shorter one, against the plain version on
    the card."""
    import raw_rows
    from honours_tpu_torch.engine import flats_cuda
    from honours_tpu_torch.synth import synthesize_corpus

    m = L // step
    assert flats_cuda.in_scratch(m) and raw_rows.flats_design(m)[1] == 0
    flat = synthesize_corpus(L + 5000, seed=23)
    _flats_same([flat[:L], flat[L: L + 5000]], step, cuda, L)
    # the time of the long read alone, for the log (no target)
    sig = torch.from_numpy(flat[:L])[None].to(cuda)
    n = torch.tensor([L], dtype=torch.int32, device=cuda)
    flats_cuda.flats_partition(sig, n, step)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    flats_cuda.flats_partition(sig, n, step)
    t1.record()
    torch.cuda.synchronize()
    print(f"kernel K [1, {L}] step {step} (m = {m}): "
          f"{t0.elapsed_time(t1):.3f} ms on {torch.cuda.get_device_name()}")


def _unpack_rows(seed, count, width, S, gap=3, shift=0, cut=None,
                 out_gap=0):
    """J's rows over random stream bytes: each row's bytes at a random
    gap of 0..gap after the one before it (from byte shift on), its
    fields at a gap of 0..out_gap elements after the row before it in out
    (from element shift on), in_len its bytes (or cut[r] of them)."""
    rng = np.random.default_rng(seed)
    count = np.asarray(count, np.int64)
    width = np.asarray(width, np.int64)
    nb = (count * width + 7) // 8
    in_off = shift + np.cumsum(nb + rng.integers(0, gap + 1, count.size)) - nb
    in_len = nb if cut is None else np.asarray(cut, np.int64)
    S = max(S, int((in_off + nb).max(initial=0)))
    stream = rng.integers(0, 256, S).astype(np.uint8)
    out_off = shift + np.cumsum(count + rng.integers(0, out_gap + 1,
                                                     count.size)) - count
    return _t(stream, in_off, in_len, count, width) + [
        int(out_off[-1] + count[-1]) + 5, torch.from_numpy(out_off)]


def test_unpack_kernel_width_0_rows(cuda):
    """J on rows of width 0 (each still writes its count zeros over the
    -7 fill) beside rows of widths 1-16, counts 0-17, 63-65 and 1,000."""
    counts = [*range(18), 63, 64, 65, 1000] * 2
    widths = [0] * 22 + [1 + k % 16 for k in range(22)]
    stream, in_off, in_len, c, w, O, out_off = _unpack_rows(1, counts,
                                                            widths, 64)
    out = _unpack_both(stream, in_off, in_len, c, w, O, out_off, cuda)
    for r in range(22):
        k, o = counts[r], int(out_off[r])
        assert (out[o: o + k] == 0).all(), r


def test_unpack_kernel_rows_cut_by_in_len(cuda):
    """J on rows whose in_len cuts their bytes (0, 1, half, all but one
    and past the end): the bytes at or past in_len read as 0."""
    rng = np.random.default_rng(2)
    count = rng.integers(1, 400, 60)
    width = rng.integers(0, 17, 60)
    nb = (count * width + 7) // 8
    cut = np.stack([np.zeros_like(nb), np.minimum(nb, 1), nb // 2,
                    np.maximum(nb - 1, 0), nb + 9]).T.reshape(-1)[:60]
    _unpack_both(*_unpack_rows(3, count, width, 0, cut=cut), cuda)


@pytest.mark.parametrize("b", [1, 7, 13, 16])
def test_unpack_kernel_row_ending_at_s(cuda, b):
    """J on rows whose bytes end at the stream's last byte S (a word load
    there would pass it), one long and several short, on a stream cut to
    exactly their bytes, and on one cut 5 bytes short (the rest read 0)."""
    count = [3, 9, 1000, 17, 8 * 37 + 5]
    stream, in_off, in_len, c, w, O, out_off = _unpack_rows(
        b, count, [b] * len(count), 0, gap=0)
    end = int(in_off[-1] + in_len[-1])
    for S in (end, end - 5):
        _unpack_both(stream[:S].clone(), in_off, in_len, c, w, O, out_off,
                     cuda)


@pytest.mark.parametrize("shift", range(16))
def test_unpack_kernel_every_offset_mod_16(cuda, shift):
    """J with in_off and out_off at every address mod 16 (stream and out
    views shifted by `shift` bytes and elements), on uint-like long rows
    and flats-like short ones."""
    for seed, count in ((shift, [5999, 4096, 1, 8]),
                        (shift + 20, np.arange(1, 70))):
        width = np.random.default_rng(seed).integers(0, 17, len(count))
        args = _unpack_rows(seed, count, width, 0, shift=shift, out_gap=1)
        _unpack_both(*args, cuda)
        # a stream view whose data pointer sits at that offset too
        stream, in_off, in_len, c, w, O, out_off = args
        big = torch.zeros(stream.numel() + shift, dtype=torch.uint8,
                          device=cuda)
        big[shift:] = stream.to(cuda)
        _unpack_both(big[shift:], *[a.to(cuda) for a in (in_off, in_len, c,
                                                          w)],
                     O, out_off.to(cuda), cuda)


def test_unpack_kernel_straddling_warps(cuda):
    """J on 20,000 short rows (counts 0-24, so a warp's 32 groups span
    many rows), widths 0-16, gaps 0-3 bytes, their outputs end to end
    (the warp's fields one run) and 0-2 elements apart; a flats-like and
    a turbopfor-like stream."""
    rng = np.random.default_rng(9)
    count = rng.integers(0, 25, 20000)
    width = rng.integers(0, 17, 20000)
    _unpack_both(*_unpack_rows(10, count, width, 0), cuda)
    _unpack_both(*_unpack_rows(12, count, width, 0, out_gap=2), cuda)
    count = np.full(3000, 128)
    count[::7] = 77
    _unpack_both(*_unpack_rows(11, count, rng.integers(0, 17, 3000), 0,
                               gap=2), cuda)


@pytest.mark.parametrize("b", [0, 5, 16])
def test_unpack_kernel_one_row_of_2_22(cuda, b):
    """J alone on one row of 2^22 fields over random bytes, at an odd
    in_off and an out_off 1 mod 4, against its plain version."""
    args = _unpack_rows(b + 40, [1 << 22], [b], 0, shift=1)
    stream, in_off, in_len, c, w, O, out_off = args
    _unpack_both(stream.to(cuda), in_off.to(cuda), in_len.to(cuda),
                 c.to(cuda), w.to(cuda), O, out_off.to(cuda), cuda)


@pytest.mark.parametrize("L,step", [(65536, 64), (4096, 8), (65536, 16),
                                    (1 << 18, 32)])
def test_flats_kernel_every_block_size(cuda, L, step):
    """K at the designs the entry picks at m = 1,024, 512, 4,096 and
    8,192 chunks (the last two the memory design in shared memory), on
    synthetic reads of L samples and shorter, against its plain version
    on the card."""
    import raw_rows
    from honours_tpu_torch.engine import flats_cuda
    from honours_tpu_torch.synth import synthesize_corpus

    m = -(-L // step)
    assert raw_rows.flats_design(m) in [d[1:] for d in
                                        raw_rows.flats_designs()]
    assert not flats_cuda.in_scratch(m)
    flat = synthesize_corpus(2 * L, seed=m)
    _flats_same([flat[:L], flat[L: L + L // 3], flat[5: 5 + L - 7]], step,
                cuda, L)


def _flats_widths():
    """(design, the most chunks of rows the entry gives it): each design
    of csrc/flats.cu at the widest rows it takes (the last one past the
    one before it)."""
    import raw_rows

    table = raw_rows.flats_designs()
    return [(tuple(d[1:]), d[0] or table[i - 1][0] + 1)
            for i, d in enumerate(table)]


@pytest.mark.parametrize("design,m", _flats_widths())
def test_flats_kernel_each_design(cuda, design, m):
    """Every design csrc/flats.cu can launch, each in rows of m chunks
    (which the entry gives it), on raw_rows.flats_reads at steps 64 and 8
    and a walk of 1,000 chunks, against the plain version on the card."""
    import raw_rows
    from honours_tpu_torch.synth import synthesize_corpus

    assert raw_rows.flats_design(m) == design
    walk = synthesize_corpus(64_000, seed=5)
    for step, reads in ((64, raw_rows.flats_reads(1) + [walk]),
                        (8, raw_rows.flats_reads(2))):
        _flats_same(reads, step, cuda, m * step)


def test_flats_kernel_u32_limit(cuda):
    """The wrapper raises ValueError where 2 L + 3 (m + 1) >= 2^32 (the
    kernel's 32-bit costs: here L = 858,993,459 at step 1), before any
    launch; one sample less fits."""
    from honours_tpu_torch.engine import flats_cuda

    L = -(-((1 << 32) - 3) // 5)  # 2 L + 3 (L + 1) >= 2^32 at step 1
    assert not flats_cuda.cost_fits_u32(L, 1)
    assert flats_cuda.cost_fits_u32(L - 1, 1)
    sig = torch.zeros((1, L), dtype=torch.int16, device=cuda)
    n = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = flats_cuda._PARTITION.launches
    with pytest.raises(ValueError, match="2\\^32"):
        flats_cuda.flats_partition(sig, n, 1)
    assert flats_cuda._PARTITION.launches == before


def test_zsm_kernel_matches_plain(cuda):
    """L against its plain version and the reference's get_mean_16 on the
    card: empty and one-sample reads, a negative mean (truncated toward
    zero), the read whose running mean differs from int(sum / n), random,
    a ramp and a long walk; then a bucket [64, 65536]."""
    import raw_rows
    from honours_tpu_torch.engine import uint, zsm_cuda
    from honours_tpu_torch.synth import synthesize_bucket

    reads = raw_rows.zsm_reads()
    sig, n = _t(*raw_rows.pad_rows(reads))
    got = zsm_cuda.zsm_mean(sig.to(cuda), n.to(cuda))
    _same(got, uint.zsm_mean_plain(sig.to(cuda), n.to(cuda)))
    assert got.tolist() == [raw_rows.mean16(r) if r.size else 0
                            for r in reads]
    sig, n = _t(*synthesize_bucket(64, 1 << 16, 3))
    sig, n = sig.to(cuda), n.to(torch.int32).to(cuda)
    _same(zsm_cuda.zsm_mean(sig, n), uint.zsm_mean_plain(sig, n))


def _zsm_same(reads, cuda, plain: bool = True):
    """L on the card on `reads` equals get_mean_16 (raw_rows.mean16, on
    the host) and, with `plain`, its plain version on the card."""
    import raw_rows
    from honours_tpu_torch.engine import uint, zsm_cuda

    sig, n = (x.to(cuda) for x in _t(*raw_rows.pad_rows(reads)))
    got = zsm_cuda.zsm_mean(sig, n)
    if plain:
        _same(got, uint.zsm_mean_plain(sig, n))
    assert got.tolist() == [raw_rows.mean16(r) for r in reads]


def test_zsm_kernel_on_flagged_reads(cuda):
    """L on the reads of tests/test_torch_zsm_model.py: the drift read,
    random reads and walks, and reads whose exact means are k and k +-
    j / n for n of 1 to 65,536 (the integer means flagged), against its
    plain version and get_mean_16; then the band-edge reads of 2^20
    samples (k +- 8 / n flagged, k +- 9 / n settled) against get_mean_16
    on the host."""
    import raw_rows

    rng = np.random.default_rng(5)
    reads = [raw_rows.drift_read()]
    reads += [rng.integers(-32768, 32768, 3001).astype(np.int16),
              np.clip(np.cumsum(rng.integers(-200, 201, 4000)) + 9000,
                      -32768, 32767).astype(np.int16)]
    for k in (1, 2, 3, 64, 1000, 4097, 65536):
        reads += raw_rows.banded_reads(k, k)
    _zsm_same(reads, cuda)
    _zsm_same(raw_rows.banded_reads(7, 1 << 20, ks=(-5, 3), js=(0, 8, 9)),
              cuda, plain=False)


def test_zsm_kernel_all_flagged_bucket(cuda):
    """L on a bucket [64, 65536] whose every read's exact mean was moved
    to an integer (raw_rows.integer_mean_rows: every read takes the
    chain), against its plain version."""
    import raw_rows
    from honours_tpu_torch.engine import uint, zsm_cuda
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(64, 1 << 16, 4)
    sig = raw_rows.integer_mean_rows(sig, n)
    S = np.where(np.arange(1 << 16)[None, :] < n[:, None], sig, 0).sum(1)
    assert all(raw_rows.zsm_model(int(a), int(b)) is None
               for a, b in zip(S, n))
    sig, n = (x.to(cuda) for x in _t(sig, n.astype(np.int32)))
    _same(zsm_cuda.zsm_mean(sig, n), uint.zsm_mean_plain(sig, n))


def test_zsm_kernel_short_and_unaligned_rows(cuda):
    """L on reads of n = 0, 1 and 2 and on rows whose starts are not
    16-byte aligned: L = 1,003 (row b starts 6 b mod 16 bytes past an
    aligned one), in a view one row into its storage, against its plain
    version and get_mean_16."""
    import raw_rows
    from honours_tpu_torch.engine import uint, zsm_cuda

    rng = np.random.default_rng(9)
    L, B = 1003, 24
    big = rng.integers(-32768, 32768, (B + 1, L)).astype(np.int16)
    n = np.concatenate([[0, 1, 2, 2, 1], rng.integers(3, L, B - 7),
                        [L - 1, L]]).astype(np.int32)
    sig = torch.from_numpy(big).to(cuda)[1:]
    assert sig.is_contiguous() and sig.data_ptr() % 16 == 6
    cnt = torch.from_numpy(n).to(cuda)
    got = zsm_cuda.zsm_mean(sig, cnt)
    _same(got, uint.zsm_mean_plain(sig, cnt))
    assert got.tolist() == [raw_rows.mean16(big[1 + b, : n[b]])
                            for b in range(B)]


@pytest.mark.parametrize("r", [0, 1, 128, 129])
def test_zsm_kernel_one_row_of_2_22(cuda, r):
    """L on one read of 2^22 samples whose exact sum is k n + r: the
    band at 2^22 is 128 / n, so r <= 128 is flagged (the chain) and 129
    settled; against get_mean_16 on the host."""
    import raw_rows

    n = 1 << 22
    rng = np.random.default_rng(r)
    read = raw_rows.with_sum(37 + rng.integers(-60, 61, n), 37 * n + r)
    assert (raw_rows.zsm_model(37 * n + r, n) is None) == (r <= 128)
    _zsm_same([read], cuda, plain=False)


RAW_KERNELS = {
    "vb": {"monotone_compact_u8"}, "svb32": {"monotone_compact_u8"},
    "svb16": {"svb16_encode", "svb16_decode"},
    "svb16_zd": {"svb16_encode", "svb16_decode"},
    "uint": {"bitpack_msb", "bitunpack_msb"},
    "flats": {"flats_partition", "bitpack_msb", "bitunpack_msb"},
}


@pytest.mark.parametrize("codec", [
    "vb1e2", "vbe21", "vbbe21", "vbsbe21", "vbsse21", "svb", "svb0124",
    "svb12_nosimd", "svb12_zd_nosimd", "uintx_16", "uint11", "uint",
    "uint_submin", "uint_zd", "uint_zsm", "flat_uint_submin"])
def test_raw_codecs_on_card_equal_cpu(cuda, codec):
    """Each raw-sample codec through the runner on the card: its streams
    equal the CPU route's, and its decode too (every read back but
    uint11's, which keeps 11 bits); its kernels launched."""
    import raw_rows
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        RAW_CODECS,
        depress_signals,
        press_signals,
    )

    reads = _entropy_reads() + raw_rows.zsm_reads()[1:4] + [
        np.tile(np.array([-32767, 32767], np.int16), 35)]
    lens = [r.size for r in reads]
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, codec, device=cuda)
    assert streams == press_signals(reads, codec, device="cpu")
    out = depress_signals(streams, lens, codec, device=cuda)
    cpu = depress_signals(streams, lens, codec, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(cpu, out))
    if codec != "uint11":
        assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = {k for k, v in KERNELS.items() if v.launches > before.get(k, 0)}
    want = RAW_KERNELS[RAW_CODECS[codec].partition(":")[0]]
    if codec == "uint_zsm":
        want = want | {"zsm_mean"}
    assert want <= grown


def _walk_both(stream, first, nseg, counts, fmt, cuda):
    """Kernel M and its plain version on the card."""
    from honours_tpu_torch.engine import hdrwalk_cuda as M

    args = [a.to(cuda) for a in _t(stream, first, nseg, counts)]
    got = M.hdrwalk(*args, fmt)
    _same(got, M.hdrwalk_plain(*args, fmt))
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_hdrwalk_kernel_matches_plain(cuda, seed):
    """M against its plain version: turbopfor's host streams of the block
    reads (offsets equal the host walk's), random bytes in both formats
    with random and negative counts, segment counts from -1 to past S,
    first offsets past the row and negative, rows cut to every length."""
    import block_rows
    from honours_tpu.codecs.base import get as get_codec
    from honours_tpu_torch.engine.hdrwalk_cuda import FLATS, TURBOPFOR

    reads = block_rows.block_reads(seed)
    streams = [get_codec("turbopfor").press(r) for r in reads]
    S = max(-(-r.size // 128) for r in reads)
    counts = np.zeros((len(reads), S), np.int64)
    for i, r in enumerate(reads):
        m = -(-r.size // 128)
        counts[i, :m] = np.minimum(128, r.size - 128 * np.arange(m))
    nseg = np.array([-(-r.size // 128) for r in reads], np.int64)
    buf = block_rows.stream_rows(streams)
    got = _walk_both(buf, np.zeros(len(reads), np.int64), nseg, counts,
                     TURBOPFOR, cuda).cpu().numpy()
    for i in range(len(reads)):
        assert got[i].tolist() == block_rows.hdrwalk_np(
            buf[i], 0, int(nseg[i]), counts[i], TURBOPFOR)
    rng = np.random.default_rng(seed)
    B, M, S = 64, 300, 40
    stream = rng.integers(0, 256, (B, M)).astype(np.uint8)
    stream[: B // 2] &= 0x1F
    counts = rng.integers(-3, 200, (B, S)).astype(np.int64)
    nseg = rng.integers(-1, S + 5, B).astype(np.int64)
    first = rng.integers(0, M // 4, B).astype(np.int64)
    first[:4] = [M, M - 1, -2, 10 * M]
    for fmt in (TURBOPFOR, FLATS):
        _walk_both(stream, first, nseg, counts, fmt, cuda)
    s = streams[-1]
    cut = block_rows.stream_rows([s[:m] for m in range(0, 80)])
    _walk_both(cut, np.zeros(80, np.int64), np.full(80, 20, np.int64),
               np.full((80, 20), 128, np.int64), TURBOPFOR, cuda)


@pytest.mark.parametrize("fmt", ["turbopfor", "flats"])
def test_hdrwalk_kernel_one_row_of_2_22(cuda, fmt):
    """M on the press's streams of one read of 2^22 samples (32,768
    turbopfor blocks; 65,536 flats segments of the partition) and of two
    of 2^21 + 3, against its plain version on the card: the walk ends at
    each stream's length."""
    from honours_tpu_torch.engine import flats, pfor
    from honours_tpu_torch.engine.hdrwalk_cuda import FLATS, TURBOPFOR
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus((1 << 22) + 9, seed=29)
    for lens in ([1 << 22], [(1 << 21) + 3, (1 << 21) + 3]):
        L = max(lens)
        sig = torch.zeros((len(lens), L), dtype=torch.int16)
        a = 0
        for i, m in enumerate(lens):
            sig[i, :m] = torch.from_numpy(flat[a: a + m])
            a += m
        n = torch.tensor(lens, dtype=torch.int32)
        sig, n = sig.to(cuda), n.to(cuda)
        if fmt == "turbopfor":
            st, sl = pfor.press_pfor_batch(sig, n)
            nseg = (n.to(torch.int64) + 127) // 128
            blen = pfor.block_lengths(n, L)[1]
            args = (st, torch.zeros_like(nseg), nseg, blen)
        else:
            st, sl = flats.press_flats_batch(sig, n)
            first, nseg, lens = flats.walk_args(st, n)
            args = (st, first, nseg, lens)
        # a column past the last segment: every row's walk ends in it
        stream, first, nseg, counts = args
        counts = torch.nn.functional.pad(counts, (0, 1))
        got = _walk_both(*[a.cpu() for a in (stream, first, nseg, counts)],
                         TURBOPFOR if fmt == "turbopfor" else FLATS, cuda)
        _same(got[:, -1], sl.to(torch.int64))


def _flac_both(rows, n, L, cuda):
    """Kernel N and its plain version on the card, N's output in memory
    that held 0xA5 bytes (a block of its size filled and freed just before
    the call, which the caching allocator hands to the wrapper)."""
    from honours_tpu_torch.engine import flac_cuda as N

    s, m = _t(rows, n)
    s, m = s.to(cuda), m.to(torch.int32).to(cuda)
    bait = torch.full((s.shape[0], L), -0x5A5B, dtype=torch.int16,
                      device=cuda)
    ptr = bait.data_ptr()
    del bait
    got = N.flac_decode(s, m, L)
    assert got.numel() == 0 or got.data_ptr() == ptr
    _same(got, N.flac_decode_plain(s, m, L))
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_flac_kernel_matches_plain(cuda, seed):
    """N against its plain version and the host decode: the host's streams
    of the block reads (every edge length, verbatim blocks, the spike's
    unary runs of thousands of ones), at L = their longest and wider;
    streams cut at their first bytes, in a warm-up and in the Rice bits;
    headers the press never writes, runs past the plain version's window
    and off the row, random rows; the edge streams of
    block_rows.flac_edge_rows (k = 0 and 30, order = blen - 1 on a short
    last block, a valid block before a garbage header, Rice regions ending
    on a chunk edge, a tile edge and the kernel's first tile's reach),
    also held to the row model.  Every call's output lands in poisoned
    memory."""
    import block_rows
    from honours_tpu.codecs.base import get as get_codec

    reads = block_rows.block_reads(seed)
    host = get_codec("flac")
    streams = [host.press(r) for r in reads]
    rows = block_rows.stream_rows(streams, 3)
    n = np.array([r.size for r in reads], np.int32)
    for L in (int(n.max()), int(n.max()) + 4099):
        got = _flac_both(rows, n, L, cuda).cpu().numpy()
        for i, r in enumerate(reads):
            assert np.array_equal(got[i, : r.size], r)
            assert not got[i, r.size:].any()
    s = streams[-1]
    first = 2 + 2 * s[0]
    cuts = [s[:m] for m in (0, 1, 2, 3, first - 1, first + 5, first + 700)]
    _flac_both(block_rows.stream_rows(cuts), np.full(len(cuts), 9000), 9000,
               cuda)
    rng = np.random.default_rng(seed + 6)
    M = 12000
    odd = np.zeros((8, M), np.uint8)
    odd[0, :4] = [7, 3, 1, 2]
    odd[1, :2] = [1, 31]
    odd[2, :12] = [4, 2, 5, 0, 6, 0, 7, 0, 8, 0, 255, 0]
    odd[3] = 0xFF
    odd[5, 2: 2 + 9000] = 0xFF
    odd[6, :6] = [2, 3, 1, 0, 2, 0]
    odd[6, 6:] = 0xFF
    odd[7] = rng.integers(0, 256, M).astype(np.uint8)
    odd[7, :2] = [1, 4]
    _flac_both(odd, np.array([100, 100, 3, 50, 0, 5000, 200, 4200]), 6000,
               cuda)
    rand = rng.integers(0, 256, (64, 3000)).astype(np.uint8)
    rand[:, 0] = rng.integers(0, 5, 64)
    rand[:, 1] = rng.integers(0, 31, 64)
    rand[:32, 2:] &= 0x0F
    _flac_both(rand, rng.integers(0, 400, 64), 400, cuda)
    streams, n, _ = block_rows.flac_edge_rows(seed + 8)
    rows = block_rows.stream_rows(streams, 5)
    got = _flac_both(rows, n, 8200, cuda).cpu().numpy()
    for i in range(len(streams)):
        assert np.array_equal(got[i],
                              block_rows.flac_decode_np(rows[i], n[i], 8200))


def test_flac_kernel_one_row_of_2_22(cuda):
    """N on the press's streams of one read of 2^22 samples (1,024 blocks)
    and of two of 2^21 + 3, against its plain version on the card; the
    reads come back."""
    from honours_tpu_torch.engine import flac
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus((1 << 22) + 9, seed=31)
    for lens in ([1 << 22], [(1 << 21) + 3, (1 << 21) + 3]):
        L = max(lens)
        sig = torch.zeros((len(lens), L), dtype=torch.int16)
        a = 0
        for i, m in enumerate(lens):
            sig[i, :m] = torch.from_numpy(flat[a: a + m])
            a += m
        n = torch.tensor(lens, dtype=torch.int32)
        st, sl = flac.press_flac_batch(sig.to(cuda), n.to(cuda))
        got = _flac_both(st.cpu().numpy(), n.numpy(), L, cuda)
        _same(got, sig.to(cuda))


@pytest.mark.parametrize("codec", [
    "turbopfor", "flac", "none", "zlib", "bzip2_uint_zd",
    "fast_lzma2_svb12_zd", "zlib_vbbe21_zd", "zlib_hasgam_vbsse21_zdq"])
def test_last_codecs_on_card_equal_cpu(cuda, codec):
    """turbopfor, flac, none and layer codecs through the runner on the
    card: the streams equal the CPU route's and the reads come back; M,
    I and J launched for turbopfor, N for flac."""
    import block_rows
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import (
        depress_signals,
        press_signals,
    )

    reads = _entropy_reads() + block_rows.block_reads(2)[:16]
    lens = [r.size for r in reads]
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, codec, device=cuda)
    assert streams == press_signals(reads, codec, device="cpu")
    out = depress_signals(streams, lens, codec, device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = {k for k, v in KERNELS.items() if v.launches > before.get(k, 0)}
    want = {"turbopfor": {"hdrwalk", "bitpack_msb", "bitunpack_msb"},
            "flac": {"flac_decode"}}.get(codec, set())
    assert want <= grown
