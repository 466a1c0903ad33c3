"""Static checks of the port's kernel bindings and copied host pieces
(no CUDA needed): every ctypes signature matches its C entry, and the
synthetic signal copy equals honours_tpu's generator (tolerance 0)."""

import re

import numpy as np
import pytest

from honours_tpu_torch import _build

# import every wrapper module so the registry is complete
from honours_tpu_torch.engine import (  # noqa: F401
    bitpack_cuda,
    flac_cuda,
    flats_cuda,
    hdrwalk_cuda,
    huffdec_cuda,
    huffman,
    permute_cuda,
    rans_encode_cuda,
    rans_n4_cuda,
    rangecoder_cuda,
    rans_o1_cuda,
    rccdf_cuda,
    rice_cuda,
    svb16_cuda,
    zsm_cuda,
)
from honours_tpu_torch.segment import segment_cuda  # noqa: F401


def _c_params(source: str, symbol: str):
    text = (_build.CSRC / source).read_text()
    m = re.search(r"HTT_EXPORT\s+int\s+" + symbol + r"\s*\(([^)]*)\)", text)
    assert m, f"{symbol} not exported by {source}"
    return [p.strip() for p in m.group(1).split(",")]


def test_registry_holds_every_kernel():
    assert sorted(_build.KERNELS) == sorted([
        "monotone_compact_u8", "monotone_compact_i32", "compaction_shifts",
        "monotone_expand_u8", "monotone_expand_i32", "o1_fc", "rans_encode",
        "o1_decode", "o0_decode", "svb16_encode", "svb16_decode", "o1n_fc",
        "n4_decode", "find_stall", "rice_decode", "huffman_decode",
        "rc_encode", "rc_decode", "rccdf_encode", "rccdf_decode",
        "huffman_build", "huffman_decode_rows", "bitpack_msb",
        "bitunpack_msb", "flats_partition", "zsm_mean", "hdrwalk",
        "flac_decode"])
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


def test_tile_width_matches_permute_source():
    """permute_cuda.TILE and EPT (the wrapper's tiling and scratch size)
    are permute.cu's, and a tile is one group of elements per thread."""
    text = (_build.CSRC / "permute.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (TPB|EPT|TILE) = (\d+);", text)}
    assert consts["TILE"] == permute_cuda.TILE
    assert consts["EPT"] == permute_cuda.EPT
    assert consts["TPB"] * consts["EPT"] == consts["TILE"]


def test_flats_smem_limit_matches_source():
    """flats_cuda.SMEM_MAX (the wrapper's choice of shared memory or
    scratch for kernel K's state) is flats.cu's."""
    text = (_build.CSRC / "flats.cu").read_text()
    (kib,) = re.findall(r"constexpr int SMEM_MAX = (\d+) \* 1024;", text)
    assert int(kib) * 1024 == flats_cuda.SMEM_MAX
    assert not flats_cuda.in_scratch(12_799)  # 16 B an index
    assert flats_cuda.in_scratch(12_800)


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


@pytest.mark.parametrize("source,name,value", [
    ("rans_o1.cu", "NZW", rans_o1_cuda.NZW),
    ("rans_o1.cu", "PAIRS", rans_o1_cuda.PAIRS),
    ("rans_o1.cu", "FC_CMAP", rans_o1_cuda.FC_CMAP),
    ("rans_o1.cu", "MAX_RPB", rans_o1_cuda.MAX_RPB),
    ("rans_encode.cu", "MAX_RPB", rans_o1_cuda.MAX_RPB),
    ("rans_encode.cu", "RCP_WORDS", rans_encode_cuda.RCP_WORDS),
    ("rans_n4.cu", "ROWB", rans_n4_cuda.ROWB),
    ("rans_n4.cu", "NEXT", rans_n4_cuda.NEXT),
    ("rans_n4.cu", "MAX_RPB", rans_o1_cuda.MAX_RPB),
    ("svb16.cu", "DTILE", svb16_cuda.DECODE_TILE),
    ("svb16.cu", "ETILE", svb16_cuda.ENCODE_TILE),
])
def test_walk_constants_match_sources(source, name, value):
    """The walks' table sizes and reads per block, and the svb16 encode's
    and decode's tiles, which the wrappers use to size scratch and
    launches, are the CUDA sources'."""
    text = (_build.CSRC / source).read_text()
    m = re.search(r"constexpr int " + name + r" = ([^;]+);", text)
    assert m, f"{name} not in {source}"
    assert int(m.group(1)) == value


def test_encode_partition_matches_source():
    """svb16_cuda.encode_tile_ranges gives tile t the columns
    [t * EWT, (t + 1) * EWT) of a row's zeros past kl + 2n, EWT = ETILE/8 +
    2 ETILE, as svb16.cu's encode does, and ETILE is 128 threads of 16
    samples."""
    text = (_build.CSRC / "svb16.cu").read_text()
    assert re.search(r"constexpr long long EWT = ETILE / 8 \+ 2 \* ETILE;",
                     text)
    assert re.search(r"constexpr int ET = 128;", text)
    assert re.search(r"constexpr int EEPT = 16;", text)
    T = svb16_cuda.ENCODE_TILE
    L = 3 * T
    ranges = svb16_cuda.encode_tile_ranges(0, L, [0, 0, 0])
    wt = T // 8 + 2 * T
    assert ranges == [[(0, wt, "zero")], [(wt, 2 * wt, "zero")],
                      [(2 * wt, svb16_cuda.stream_width(L), "zero")]]


def test_flac_constants_match_source():
    """flac_cuda's block length, verbatim mode and limits on order and k
    (which its plain version and engine/flac.py's press use) are
    flac.cu's."""
    text = (_build.CSRC / "flac.cu").read_text()
    consts = dict(re.findall(
        r"constexpr (?:long long|unsigned) (\w+) = (\d+);", text))
    assert {k: int(v) for k, v in consts.items()} == {
        "BLOCK": flac_cuda.BLOCK, "VERBATIM": flac_cuda.VERBATIM,
        "MAX_ORDER": flac_cuda.MAX_ORDER, "MAX_K": flac_cuda.MAX_K}
