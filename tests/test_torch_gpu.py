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


def test_decode_kernel_and_runner_round_trip(cuda):
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.runner import depress_signals, press_signals
    from honours_tpu_torch.synth import synthesize_corpus

    flat = synthesize_corpus(60_000, seed=3)
    reads = [flat[:20_000], flat[20_000:21_000], flat[21_000:21_001],
             np.tile(np.array([0, 30000], np.int16), 300), flat[30_000:]]
    before = {k: v.launches for k, v in KERNELS.items()}
    streams = press_signals(reads, device=cuda)
    assert streams == press_signals(reads, device="cpu")
    out = depress_signals(streams, [r.size for r in reads], device=cuda)
    assert all(np.array_equal(a, b) for a, b in zip(reads, out))
    grown = [k for k, v in KERNELS.items() if v.launches > before[k]]
    assert sorted(grown) == sorted(KERNELS)
