"""Kernels I and J: MSB-first fixed-width bit packing and unpacking over
ragged rows (csrc/bitpack.cu), beside their plain versions
(engine/bitpack.py).

No TPU kernel stands behind them: honours_tpu packs these fields on the
host only (honours_tpu/kernels/bitpack.py pack_bits and unpack_bits).
The wrappers route by device: CPU tensors take the plain versions, CUDA
tensors launch the kernels in a grid-stride loop over the rows' groups of
8 fields (b whole bytes), a thread a group: I stores a warp's groups of
one row through shared memory as 16-byte words, J loads each group's
bytes as aligned words and stores its fields as two 16-byte words where
aligned.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, sm_count, stream_ptr
from honours_tpu_torch.engine.bitpack import (
    exclusive,
    pack_msb_plain,
    unpack_msb_plain,
)

_PACK = kernel("bitpack_msb", "bitpack.cu", "htt_bitpack_msb", "ppppplpplp")
_UNPACK = kernel("bitunpack_msb", "bitpack.cu", "htt_bitunpack_msb",
                 "plppppplpplp")


def _flat(t, name: str, dtypes):
    check(t, name, dtypes)
    if t.dim() != 1:
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not flat")
    return t.numel()


def _i64(t, R: int, name: str):
    t = t.to(torch.int64).contiguous()
    if tuple(t.shape) != (R,):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != ({R},)")
    return t


def _blocks(items: int, dev) -> int:
    """Blocks of 256 threads for a grid-stride loop over at most `items`
    items: enough to fill the card, no more than the items need."""
    return max(1, min(-(-items // 256), 16 * sm_count(dev)))


def pack_msb(values, val_off, count, width, out, out_off):
    """Write each row's MSB-first packed fields into out (in place) and
    return it: values [V] int32, val_off / count / width / out_off [R]
    (any integer type), out [O] u8 (flat).  Rows' byte ranges must not
    overlap.  See bitpack.pack_msb_plain."""
    if is_cpu(values, val_off, count, width, out, out_off):
        return pack_msb_plain(values, val_off, count, width, out, out_off)
    _flat(values, "values", (torch.int32,))
    O = _flat(out, "out", (torch.uint8,))
    R = val_off.numel()
    val_off = _i64(val_off, R, "val_off")
    cnt = _i64(count, R, "count").clamp(min=0)
    width = _i64(width, R, "width")
    out_off = _i64(out_off, R, "out_off")
    # the rows' groups of 8 fields (none at b <= 0), their prefix the only
    # one the kernel takes; at most one group an output byte
    groups = torch.where(width > 0, (cnt + 7) >> 3, 0)
    _PACK(values.data_ptr(), val_off.data_ptr(), cnt.data_ptr(),
          width.data_ptr(), exclusive(groups).data_ptr(), R, out.data_ptr(),
          out_off.data_ptr(), _blocks(O, out.device), stream_ptr(out.device))
    return out


def unpack_msb(stream, in_off, in_len, count, width, out, out_off):
    """Read each row's count fields of width b from stream (flat u8) at
    in_off, bytes at or past in_len reading as 0, into out [O] int32
    (flat, in place) at out_off + i; returns out.  Rows' outputs must
    not overlap.  See bitpack.unpack_msb_plain."""
    if is_cpu(stream, in_off, in_len, count, width, out, out_off):
        return unpack_msb_plain(stream, in_off, in_len, count, width, out,
                                out_off)
    S = _flat(stream, "stream", (torch.uint8,))
    O = _flat(out, "out", (torch.int32,))
    R = in_off.numel()
    in_off = _i64(in_off, R, "in_off")
    in_len = _i64(in_len, R, "in_len")
    cnt = _i64(count, R, "count").clamp(min=0)
    width = _i64(width, R, "width")
    out_off = _i64(out_off, R, "out_off")
    # the rows' groups of 8 fields (b = 0 too: its fields are written as
    # 0), their prefix the only one the kernel takes; at most O / 8 + R
    grp_off = exclusive((cnt + 7) >> 3)
    _UNPACK(stream.data_ptr(), S, in_off.data_ptr(), in_len.data_ptr(),
            cnt.data_ptr(), width.data_ptr(), grp_off.data_ptr(), R,
            out.data_ptr(), out_off.data_ptr(), _blocks(-(-O // 8) + R,
                                                        out.device),
            stream_ptr(out.device))
    return out
