"""honours_tpu_torch's CUDA kernels vs their plain versions on the card.

Marked `gpu`; run on a CUDA machine with
    python -m pytest -m gpu tests/test_torch_gpu.py
Elsewhere every test skips (the `cuda` fixture decides, at run time).
Outputs are integers and must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("N", [1, 700, 1 << 21])
def test_permute_kernels_match_plain(cuda, dtype, N):
    from honours_tpu_torch.engine import permute_cuda as P

    g = torch.Generator().manual_seed(N)
    B = 2 if N > 4096 else 8
    hi = 256 if dtype == torch.uint8 else 1 << 30
    v = torch.randint(0, hi, (B, N), generator=g).to(dtype).to(cuda)
    keep = (torch.rand((B, N), generator=g) < 0.6).to(cuda)
    _same(P.compact(v, keep), P.compact_plain(v, keep))
    _same(P.compaction_shifts(keep), P.compaction_shifts_plain(keep))
    sh, cnt = P.compaction_shifts(keep)
    valid = torch.arange(N, device=cuda)[None, :] < cnt[:, None]
    vc, _ = P.compact(v, keep)
    _same(P.expand(vc, sh, valid, N + 3), P.expand_plain(vc, sh, valid, N + 3))


def test_kernel_rejects_other_dtypes(cuda):
    from honours_tpu_torch.engine import permute_cuda as P

    v = torch.zeros((2, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        P.compact(v, torch.ones((2, 4), dtype=torch.bool, device=cuda))


def test_fc_and_encode_kernels_match_plain(cuda):
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


KERNELS_OF = {
    "drans_vbbe21_zd": {"monotone_compact_u8", "monotone_compact_i32",
                        "compaction_shifts", "monotone_expand_u8",
                        "monotone_expand_i32", "o1_fc", "rans_encode",
                        "o1_decode"},
    "svb12_zd": {"svb16_encode", "svb16_decode"},
    "svb12": {"svb16_encode", "svb16_decode"},
    "srans3_vbbe21_zd": {"monotone_compact_u8", "monotone_compact_i32",
                         "compaction_shifts", "monotone_expand_u8",
                         "monotone_expand_i32", "rans_encode", "o1n_fc",
                         "n4_decode"},
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
    grown = {k for k, v in KERNELS.items() if v.launches > before[k]}
    assert grown == KERNELS_OF[codec]
