"""Kernels D and E: the adaptive binary range coder's encode and decode
(csrc/rangecoder.cu), beside their plain versions (rangecoder.py).

No TPU kernel stands behind them: honours_tpu runs this coder on the
host only (honours_tpu/native/rangecoder.c).  The wrappers route by
device: CPU tensors take the plain versions, CUDA tensors launch the
kernels, a warp a row, with the model state that fits in shared memory
(set by the kernels) and the rest in device memory that the wrapper
allocates and fills (rangecoder.STATE_BYTES a row: 32.25 MiB for cm, its
order-2 table; 128 KiB for o1, its order-1 table; none for o0).
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.rangecoder import (
    DEV_CM_CELLS,
    MODELS,
    O1_CELLS,
    PROB_INIT,
    SLACK,
    SQUASH,
    STRETCH,
    out_width,
    rc_decode_plain,
    rc_encode_plain,
)

_ENCODE = kernel("rc_encode", "rangecoder.cu", "htt_rc_encode",
                 "lpllpplplppp")
_DECODE = kernel("rc_decode", "rangecoder.cu", "htt_rc_decode",
                 "lpllpplpppp")

#: cm's shared-memory row slots a read (csrc/rangecoder.cu CM_O1_SLOTS,
#: CM_O2_SLOTS): its o1 and o1s rows by the previous byte, its o2 rows by
#: the previous two
SLOTS = {"cm": (16, 8)}

_DEVICE_TABLES: dict = {}


def _tables(dev):
    """SQUASH then STRETCH (int16), made once a device."""
    k = str(dev)
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = torch.cat([torch.from_numpy(SQUASH),
                                       torch.from_numpy(STRETCH)]).to(dev)
    return _DEVICE_TABLES[k]


def _state(model: str, B: int, dev):
    """A row's device model state each, as the kernels start it (a new
    tensor: the kernels write it), or None for o0."""
    if model == "cm":
        return torch.full((B, DEV_CM_CELLS), 2048, dtype=torch.int16,
                          device=dev)
    if model == "o1":
        return torch.full((B, O1_CELLS), PROB_INIT, dtype=torch.int16,
                          device=dev)
    return None


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _model_index(model: str) -> int:
    if model not in MODELS:
        raise ValueError(f"model {model!r} not in {MODELS}")
    return MODELS.index(model)


def rc_encode_launch(data, n, model: str, slack: int = SLACK):
    """rc_encode without its check: a row whose stream would pass its cap
    comes back zeroed with length -1 (so that a CUDA graph can capture
    the call)."""
    if is_cpu(data, n):
        return rc_encode_plain(data, n, model, slack)
    m = _model_index(model)
    check(data, "data", (torch.uint8,))
    if data.dim() != 2:
        raise ValueError(f"data: shape {tuple(data.shape)} is not [B, N]")
    B, N = data.shape
    check(n, "n", (torch.int32,), (B,))
    W = out_width(N, slack)
    dev = data.device
    out = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    length = torch.empty(B, dtype=torch.int64, device=dev)
    state = _state(model, B, dev)
    _ENCODE(m, data.data_ptr(), B, N, n.data_ptr(), out.data_ptr(), W,
            length.data_ptr(), slack, _ptr(state), _tables(dev).data_ptr(),
            stream_ptr(dev))
    return out, length


def rc_encode(data, n, model: str, slack: int = SLACK):
    """data [B, N] u8, n [B] int32 -> (out [B, N + N // 2 + slack] u8,
    length [B] int64): each row's first n bytes coded with `model`
    ("o0", "o1", "cm"), as honours_tpu.native's rc0/rc1/rccm_encode code
    them; zeros past each stream.  Raises ValueError where a row's stream
    would pass n + n // 2 + slack bytes (native._encode's buffer)."""
    out, length = rc_encode_launch(data, n, model, slack)
    if bool((length < 0).any()):
        rows = torch.nonzero(length < 0).flatten().tolist()
        raise ValueError(f"range coder ({model}): the streams of rows "
                         f"{rows[:8]} would pass n + n // 2 + {slack} bytes")
    return out, length


def rc_decode(stream, off, count, N: int, model: str):
    """stream [B, M] u8, off [B] int32 (where each row's coder stream
    starts), count [B] int32 (bytes to decode, clamped to [0, N]) ->
    [B, N] u8, zeros past count; bytes at or past M read as 0."""
    if is_cpu(stream, off, count):
        return rc_decode_plain(stream, off, count, N, model)
    m = _model_index(model)
    check(stream, "stream", (torch.uint8,))
    if stream.dim() != 2:
        raise ValueError(f"stream: shape {tuple(stream.shape)} is not "
                         "[B, M]")
    B, M = stream.shape
    check(off, "off", (torch.int32,), (B,))
    check(count, "count", (torch.int32,), (B,))
    if N < 0:
        raise ValueError(f"N {N} is negative")
    dev = stream.device
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    state = _state(model, B, dev)
    _DECODE(m, stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(), N,
            out.data_ptr(), _ptr(state), _tables(dev).data_ptr(),
            stream_ptr(dev))
    return out
