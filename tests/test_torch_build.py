"""Static checks of the port's kernel bindings and copied host pieces
(no CUDA needed): every ctypes signature matches its C entry, and the
synthetic signal copy equals honours_tpu's generator (tolerance 0)."""

import re

import numpy as np
import pytest

from honours_tpu_torch import _build

# import every wrapper module so the registry is complete
from honours_tpu_torch.engine import (  # noqa: F401
    permute_cuda,
    rans_encode_cuda,
    rans_n4_cuda,
    rans_o1_cuda,
    svb16_cuda,
)


def _c_params(source: str, symbol: str):
    text = (_build.CSRC / source).read_text()
    m = re.search(r"HTT_EXPORT\s+int\s+" + symbol + r"\s*\(([^)]*)\)", text)
    assert m, f"{symbol} not exported by {source}"
    return [p.strip() for p in m.group(1).split(",")]


def test_registry_holds_every_kernel():
    assert sorted(_build.KERNELS) == sorted([
        "monotone_compact_u8", "monotone_compact_i32", "compaction_shifts",
        "monotone_expand_u8", "monotone_expand_i32", "o1_fc", "rans_encode",
        "o1_decode", "svb16_encode", "svb16_decode", "o1n_fc", "n4_decode"])
    for k in _build.KERNELS.values():
        assert k.source in _build.SOURCES


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_ctypes_signature_matches_c_entry(name):
    k = _build.KERNELS[name]
    params = _c_params(k.source, k.symbol)
    assert len(params) == len(k.signature), (params, k.signature)
    for p, code in zip(params, k.signature):
        want = "void*" if code == "p" else "long long"
        assert want in p.replace(" *", "*"), (p, code)


def test_library_names_follow_sources():
    paths = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for s, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(s[:-3] + "-")


@pytest.mark.parametrize("n,seed", [(1, 0), (5000, 3)])
def test_synth_copy_matches_reference(n, seed):
    from honours_tpu.analysis import synthesize_corpus as ref
    from honours_tpu_torch.synth import synthesize_corpus

    assert np.array_equal(synthesize_corpus(n, seed), ref(n, seed))


def test_synthesize_bucket_shape():
    from honours_tpu_torch.synth import synthesize_bucket

    sig, n = synthesize_bucket(4, 1024, seed=1)
    assert sig.shape == (4, 1024) and sig.dtype == np.int16
    assert ((n > 512) & (n <= 1024)).all()
    for row, m in zip(sig, n):
        assert not row[m:].any()
