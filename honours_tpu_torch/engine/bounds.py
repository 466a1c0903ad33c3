"""Worst-case stream sizes of the ported codecs.

The port's copies of the `bound` method of each JAX host codec that
stands behind a ported codec (honours_tpu/codecs/*.py): the bytes a
codec may emit for a read of n samples, which the bench's
pressbound_bytes column reports (the reference's press_bound,
press/test.h:47-54).  The formulas, float arithmetic included, are the
host codecs'.
"""

from __future__ import annotations

from honours_tpu_torch.engine.runner import engine_kind
from honours_tpu_torch.kernels.rans import rans_bound


def vb_bound(nin: int) -> int:
    """honours_tpu/codecs/vb.py vb_bound (press/press.c:2575-2583)."""
    return int(1 + nin * 0.2 * 6 + nin * 0.8) + 64


def svb16_max_encoded_length(n: int) -> int:
    """honours_tpu/kernels/svb.py: keys (a bit a value) plus 2 B a value."""
    return (n >> 3) + (((n & 7) + 7) >> 3) + 2 * n


#: engine kind, or its family, -> bound formula (honours_tpu/codecs/<file>)
_BOUND = {
    "drans": lambda n: 2 + 2 + 4 + rans_bound(2 * n),  # drans.py
    "srans": lambda n: 2 + rans_bound(2 * n),  # srans.py
    "srans2": lambda n: 2 + 4 + rans_bound(2 * n),  # srans2.py
    "srans3": lambda n: 2 + rans_bound(2 * n) + 8,  # srans3.py
    "shuff": lambda n: 2 + n * 2 + 2048,  # huffman.py
    "huffman_zd": lambda n: 2 + n * 2 + 2048,  # huffman.py
    "svb16_zd": svb16_max_encoded_length,  # svb.py Svb12
    "svb16": svb16_max_encoded_length,
    "vb_zd": lambda n: 2 + vb_bound(n - 1),  # vb.py VbZdCodec
    "svb32_zd": lambda n: 5 * n + ((n + 3) // 4) + 16,  # svb.py _SvbBase
    "exzd": lambda n: n * 2 + 1024,  # exzd.py
    "rice_zd": lambda n: 2 + n * 2 + 1024,  # rice.py
    "dstall": lambda n: 16 + 4 * n + 2048,  # dstall.py
    "dstall_drans": lambda n: 32 + 2 * (2 + 2 + 4 + rans_bound(2 * n)),
    "rc_vb_zd": lambda n: 2 + rans_bound(2 * n),  # rc.py RcVbZdCodec, rccdf
    "rc_vb": lambda n: rans_bound(2 * n),  # rc.py RcVbCodec
    "rc_zd": lambda n: rans_bound(2 * n),  # rc.py RcZdCodec
    "rccm_svb": lambda n: 4 + rans_bound(5 * n),  # rc.py RccmSvbZdCodec
    "rc_submin": lambda n: 2 + rans_bound(2 * n),  # rc.py submin
    "stall_fz": lambda n: 16 + 4 * n + 1024,  # stall.py
    "vb": vb_bound,  # vb.py VbCodec
    "svb32": lambda n: 5 * n + ((n + 3) // 4) + 16,  # svb.py _SvbBase
    "uint:x16": lambda n: (n * 16 + 7) // 8,  # uintc.py UintxCodec
    "uint:x11": lambda n: (n * 11 + 7) // 8,
    "uint:plain": lambda n: 1 + n * 2,  # uintc.py UintCodec
    "uint": lambda n: 2 + 1 + n * 2,  # uintc.py submin, zd, zsm
    "flats": lambda n: 8 + n * 3 + 64,  # flats.py
    "pfor": lambda n: n * 3 + 64,  # pfor.py
    "flac": lambda n: n * 3 + 64,  # flac.py
    "none": lambda n: n * 2,  # raw.py
}


def bound(codec_name: str, n: int) -> int:
    """The host codec's bound for a read of n samples; NotImplementedError
    for a name that is not a ported codec."""
    kind = engine_kind(codec_name)
    family, _, sub = kind.partition(":")
    if family == "layer":  # generic.py: the inner's (none's: 2 n) and more
        return bound(sub.partition(":")[2], n) + int(n) // 2 + 1024
    f = _BOUND.get(kind) or _BOUND[family]
    return f(int(n))
