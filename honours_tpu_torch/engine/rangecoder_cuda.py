"""Kernels D and E: the adaptive binary range coder's encode and decode
(csrc/rangecoder.cu), beside their plain versions (rangecoder.py).

No TPU kernel stands behind them: honours_tpu runs this coder on the
host only (honours_tpu/native/rangecoder.c).  The wrappers route by
device: CPU tensors take the plain versions, CUDA tensors launch the
kernels, one thread a row, over model state that the wrapper allocates
and fills on the card (rangecoder.STATE_BYTES a row: 32.3 MiB for cm).
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.rangecoder import (
    MODELS,
    O2_CELLS,
    PROB_INIT,
    SLACK,
    SQUASH,
    STRETCH,
    W_CELLS,
    W_INIT,
    cm_small_row,
    out_width,
    rc_decode_plain,
    rc_encode_plain,
)

_ENCODE = kernel("rc_encode", "rangecoder.cu", "htt_rc_encode",
                 "lpllpplplppppp")
_DECODE = kernel("rc_decode", "rangecoder.cu", "htt_rc_decode",
                 "lpllpplpppppp")

_DEVICE_TABLES: dict = {}


def _on(dev, key: str, make):
    """A constant tensor made once a device."""
    k = (str(dev), key)
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = make().to(dev)
    return _DEVICE_TABLES[k]


def _scratch(model: str, B: int, dev):
    """(probs, o2, w): a row's model state each, as the kernels start it
    (new tensors: the kernels write them); o0 and o1 pass their table
    for the unused two."""
    if model == "cm":
        row = _on(dev, "cm_row", lambda: torch.from_numpy(cm_small_row()))
        return (row.repeat(B, 1),
                torch.full((B, O2_CELLS), 2048, dtype=torch.int16,
                           device=dev),
                torch.full((B, W_CELLS), W_INIT, dtype=torch.int32,
                           device=dev))
    probs = torch.full((B, 65536 if model == "o1" else 256), PROB_INIT,
                       dtype=torch.int16, device=dev)
    return probs, probs, probs


def _tables(dev):
    return _on(dev, "squash_stretch", lambda: torch.cat([
        torch.from_numpy(SQUASH), torch.from_numpy(STRETCH)]))


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
    probs, o2, w = _scratch(model, B, dev)
    _ENCODE(m, data.data_ptr(), B, N, n.data_ptr(), out.data_ptr(), W,
            length.data_ptr(), slack, probs.data_ptr(), o2.data_ptr(),
            w.data_ptr(), _tables(dev).data_ptr(), stream_ptr(dev))
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
    probs, o2, w = _scratch(model, B, dev)
    _DECODE(m, stream.data_ptr(), B, M, off.data_ptr(), count.data_ptr(), N,
            out.data_ptr(), probs.data_ptr(), o2.data_ptr(), w.data_ptr(),
            _tables(dev).data_ptr(), stream_ptr(dev))
    return out
