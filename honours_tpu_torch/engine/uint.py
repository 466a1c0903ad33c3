"""Batched minbits bit-packing codecs: uintx_16, uint11, uint,
uint_submin, uint_zd and uint_zsm, with the plain version of kernel L
(uint_zsm's running mean, csrc/zsm.cu).

The counterparts of honours_tpu/codecs/uintc.py's host codecs; their
fields are packed and unpacked by kernels I and J (engine/bitpack_cuda
.py), one row a read.  Wire formats (press/press.c:489-738), byte for
byte the host codec's for every read, its press bytes for n = 0 too:
  uintx_<bits>  the low `bits` bits of each sample as uint16, no header
                ((n bits + 7) / 8 bytes; uint11 keeps 11, so it is
                lossless only where every sample fits them)
  uint          [b:1B][packed], b = minbits of the largest sample as
                uint16
  uint_submin   [min:u16][uint of the samples minus min]
  uint_zd       [x0:i16][uint of zigzag16 of the n - 1 uint16 deltas]
                (x0 = 0 for an empty read: 00 00 00, which the host
                cannot depress; the port decodes it to the empty read)
  uint_zsm      [mean:i16][uint of zigzag16(x - mean)], mean the
                truncated float64 running mean (kernel L)
Variants: "x16", "x11", "plain", "submin", "zd", "zsm".
"""

from __future__ import annotations

import torch

from honours_tpu_torch.engine.bitpack import minbits
from honours_tpu_torch.engine.bitpack_cuda import pack_msb, unpack_msb
from honours_tpu_torch.engine.bits import read_u16le, u16le_bytes
from honours_tpu_torch.engine.vb_batch import as_i16
from honours_tpu_torch.transforms.core import unzigzag16, zigzag16

#: variant -> header bytes before the packed fields
HEADER = {"x16": 0, "x11": 0, "plain": 1, "submin": 3, "zd": 3, "zsm": 3}


def zsm_mean_plain(sig, n) -> torch.Tensor:
    """Kernel L's plain version: UintZsmCodec._mean16 of each row of
    sig [B, L] int16 (first n valid, n clamped to [0, L]) -> [B] int64:
    mean += (x_i - mean) / (i + 1) in float64, a column at a time over
    the rows, then truncation toward zero; 0 for an empty row.  The
    divisor is a tensor: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which rounds otherwise."""
    B, L = sig.shape
    n = n.to(torch.int64).clamp(0, L)
    x = sig.to(torch.float64)
    mean = torch.zeros((B,), dtype=torch.float64, device=sig.device)
    top = int(n.max()) if B else 0
    denom = torch.arange(1, top + 1, dtype=torch.float64, device=sig.device)
    for i in range(top):
        step = mean + (x[:, i] - mean) / denom[i: i + 1]
        mean = torch.where(i < n, step, mean)
    return mean.to(torch.int64)  # toward zero, as the C cast


def fields(sig, n, variant: str):
    """What a press packs: (header value or None, fields [B, L] int64,
    zero past count, count [B], width [B]) of [B, L] int16 (first n
    valid, n clamped to [0, L])."""
    B, L = sig.shape
    dev = sig.device
    n = n.to(torch.int64).clamp(0, L)
    u = sig.to(torch.int64) & 0xFFFF
    col = torch.arange(L, device=dev)[None, :]
    head, v, cnt = None, u, n
    if variant == "zd":
        d = (u[:, 1:] - u[:, :-1]) & 0xFFFF
        head = torch.where(n > 0, u[:, 0], 0)
        v, cnt = torch.nn.functional.pad(zigzag16(d), (0, 1)), (n - 1).clamp(
            min=0)
    elif variant == "submin":
        head = torch.where(col < n[:, None], u, 0xFFFF).min(dim=1).values
        head = torch.where(n > 0, head, 0)
        v = (u - head[:, None]) & 0xFFFF
    elif variant == "zsm":
        from honours_tpu_torch.engine.zsm_cuda import zsm_mean  # a cycle

        head = zsm_mean(sig, n.to(torch.int32)) & 0xFFFF
        v = zigzag16(u - head[:, None])
    v = torch.where(col < cnt[:, None], v, 0)
    if variant in ("x16", "x11"):
        b = torch.full((B,), int(variant[1:]), dtype=torch.int64, device=dev)
    else:
        b = minbits(v.max(dim=1).values)
    return head, v, cnt, b


def press_uint_batch(sig, n, variant: str):
    """Batched uint codec `variant` of [B, L] int16 (first n valid) ->
    (stream [B, H + 2L] u8, len [B] int64)."""
    B, L = sig.shape
    dev = sig.device
    head, v, cnt, b = fields(sig, n, variant)
    H = HEADER[variant]
    W = H + 2 * L
    stream = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    if head is not None:
        stream[:, :2] = u16le_bytes(head)
    if H:
        stream[:, H - 1] = b.to(torch.uint8)
    rows = torch.arange(B, device=dev)
    pack_msb(v.to(torch.int32).reshape(-1), rows * L, cnt, b,
             stream.reshape(-1), rows * W + H)
    return stream, H + (cnt * b + 7) // 8


def depress_uint_batch(stream, n, L: int, variant: str):
    """Inverse of press_uint_batch (streams from either package) -> [B,
    L] int16, zero past n."""
    B, M = stream.shape
    dev = stream.device
    n = n.to(torch.int64).clamp(0, L)
    H = HEADER[variant]
    if M < H:
        stream = torch.nn.functional.pad(stream, (0, H - M))
        M = H
    stream = stream.contiguous()
    if variant in ("x16", "x11"):
        b = torch.full((B,), int(variant[1:]), dtype=torch.int64, device=dev)
    else:
        b = stream[:, H - 1].to(torch.int64)
    cnt = (n - 1).clamp(min=0) if variant == "zd" else n
    rows = torch.arange(B, device=dev)
    out = torch.zeros(B * L, dtype=torch.int32, device=dev)
    unpack_msb(stream.reshape(-1), rows * M + H, torch.full_like(rows, M - H),
               cnt, b, out, rows * L)
    v = out.reshape(B, L).to(torch.int64)
    zero = torch.zeros((B,), dtype=torch.int64, device=dev)
    if variant == "submin":
        v = v + read_u16le(stream, zero)[:, None]
    elif variant == "zsm":
        v = unzigzag16(v) + read_u16le(stream, zero)[:, None]
    elif variant == "zd":
        live = torch.arange(L, device=dev)[None, :] < cnt[:, None]
        d = torch.where(live, unzigzag16(v), 0)
        s = torch.nn.functional.pad(torch.cumsum(d, dim=1)[:, :-1], (1, 0))
        v = read_u16le(stream, zero)[:, None] + s
    live = torch.arange(L, device=dev)[None, :] < n[:, None]
    return torch.where(live, as_i16(v), 0).to(torch.int16)
