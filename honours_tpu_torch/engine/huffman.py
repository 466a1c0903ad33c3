"""Batched adaptive Huffman (huffman_vb*_zd) and the static-table codecs
over every vb container (shuffman_vb*_zd), with kernel H (the table
build, csrc/huffbuild.cu) beside its plain version.

The counterparts of honours_tpu/codecs/huffman.py's host codecs.  Each
stream is [zd0:u16][<vb> exception block][body]:
  huffman_<vb>_zd   body [P - 1:1B][dataBytes:u32 BE][entries][bits]: the
                    read's own table, built from its residual bytes'
                    histogram by kernel H and serialized in symbol order
                    ([sym][len][code LE, ceil(len / 8) bytes] an entry),
                    then the LSB-first code bits (the reference's
                    huffman_encode_memory, press/huffman/huffman.c:483-540,
                    713-800); decoded by C2 (engine/huffdec_cuda.py
                    huffman_decode_rows) after the tables are parsed
  shuffman_<vb>_zd  body [dataBytes:u32 BE][bits] over the canned NA12878
                    table (engine/pipeline.py press_shuff_batch)
Byte for byte the host codec's for every read of n >= 1; for n = 0 the
huffman codecs give the host's press bytes (no zd0), and their decode
gives the empty read back.  Rows with more than emax exceptions give
invalid streams (the nex field at byte 2 is exact either way); the
runner presses them alone.
"""

from __future__ import annotations

import torch

from honours_tpu_torch._build import check, is_cpu, kernel, stream_ptr
from honours_tpu_torch.engine.bits import (
    pack_fields_lsb,
    read_u32be,
    u32le_bytes,
)
from honours_tpu_torch.engine.huffdec_cuda import (
    ROW_CODE_BITS,
    huffman_decode_rows,
)
from honours_tpu_torch.engine.permute import rowwise_concat
from honours_tpu_torch.engine.rccdf import byte_histogram

_BUILD = kernel("huffman_build", "huffbuild.cu", "htt_huffman_build",
                "plppp")

#: bytes of a serialized entry beside its code, and of its longest code
ENTRY_HEAD = 2
ENTRY_CODE = ROW_CODE_BITS // 8
#: bytes of the table before its entries: [P - 1:1B][dataBytes:u32 BE]
TABLE_HEAD = 5


# ---------------------------------------------------------------------------
# kernel H: the table of each row's histogram
# ---------------------------------------------------------------------------


def huffman_build_plain(hist):
    """hist [B, 256] int64 (counts, > 0 where a symbol is present) ->
    (lengths [B, 256] int32, codes [B, 256] int64): the reference's tree
    (tables/huffman.py build_table), 0 for absent symbols and for a lone
    symbol.  Every row's sorted list is kept at 256 columns, absent and
    merged items as 2^62: a round takes columns 0 and 1 and inserts
    their sum before the first count >= it; then the codes go from the
    root down over the internal nodes, made in increasing order."""
    B = hist.shape[0]
    dev = hist.device
    h = hist.to(torch.int64)
    present = h > 0
    P = present.sum(dim=1)
    big = 1 << 62
    cnt, ids = torch.sort(torch.where(present, h, big), dim=1, stable=True)
    R = max(int(P.max()) - 1, 0) if B else 0
    zero = torch.zeros((B, max(R, 1)), dtype=torch.int64, device=dev)
    one = torch.zeros_like(zero)
    j = torch.arange(255, device=dev)[None, :]
    tail = torch.full((B, 1), big, dtype=torch.int64, device=dev)
    for r in range(R):
        act = (P - 1 > r)[:, None]
        c = torch.where(act[:, 0], cnt[:, 0] + cnt[:, 1], big)[:, None]
        zero[:, r], one[:, r] = ids[:, 0], ids[:, 1]
        rest_c, rest_i = cnt[:, 2:], ids[:, 2:]
        pos = (rest_c < c).sum(dim=1, keepdim=True)
        src = torch.where(j < pos, j, j - 1).clamp(0, 253)
        new_c = torch.where(j == pos, c, rest_c.gather(1, src))
        new_i = torch.where(j == pos, 256 + r, rest_i.gather(1, src))
        cnt = torch.where(act, torch.cat([new_c, tail], dim=1), cnt)
        ids = torch.where(act, torch.cat([new_i, tail], dim=1), ids)
    # codes: internal node r (id 256 + r) at column r, a dummy column 255
    dep = torch.zeros((B, 256), dtype=torch.int64, device=dev)
    code = torch.zeros_like(dep)
    lengths = torch.zeros((B, 257), dtype=torch.int64, device=dev)
    codes = torch.zeros_like(lengths)
    for r in range(R - 1, -1, -1):
        act = r < P - 1
        d, c = dep[:, r], code[:, r]
        bit = torch.where(d < 63, 1 << d.clamp(max=62), 0)
        for child, cc in ((zero[:, r], c), (one[:, r], c | bit)):
            inner = act & (child >= 256)
            leaf = act & (child < 256)
            at = torch.where(inner, child - 256, 255)[:, None]
            dep.scatter_(1, at, torch.where(inner, d + 1, 0)[:, None])
            code.scatter_(1, at, torch.where(inner, cc, 0)[:, None])
            at = torch.where(leaf, child, 256)[:, None]
            lengths.scatter_(1, at, (d + 1)[:, None])
            codes.scatter_(1, at, cc[:, None])
    return lengths[:, :256].to(torch.int32), codes[:, :256]


def huffman_build(hist):
    """Kernel H: huffman_build_plain's contract, a block a row on the card
    (the kernel writes every entry of every row)."""
    if is_cpu(hist):
        return huffman_build_plain(hist)
    check(hist, "hist", (torch.int64,))
    if hist.dim() != 2 or hist.shape[1] != 256:
        raise ValueError(f"hist: shape {tuple(hist.shape)} is not [B, 256]")
    B = hist.shape[0]
    lengths = torch.empty((B, 256), dtype=torch.int32, device=hist.device)
    codes = torch.empty((B, 256), dtype=torch.int64, device=hist.device)
    _BUILD(hist.data_ptr(), B, lengths.data_ptr(), codes.data_ptr(),
           stream_ptr(hist.device))
    return lengths, codes


# ---------------------------------------------------------------------------
# the body: encode, and the tables' parse
# ---------------------------------------------------------------------------


def table_segments(present, lengths, codes, dlen):
    """The serialized table of each row as rowwise_concat segments:
    [(P - 1) & 0xFF][dataBytes:u32 BE] and the entries of the present
    symbols, in symbol order."""
    B = present.shape[0]
    dev = present.device
    P = present.sum(dim=1)
    head = torch.cat([((P - 1) & 0xFF).to(torch.uint8)[:, None],
                      u32le_bytes(dlen).flip(1)], dim=1)
    L = lengths.to(torch.int64)
    k = torch.arange(ENTRY_CODE, device=dev)
    entry = torch.cat([
        torch.arange(256, device=dev).expand(B, 256)[:, :, None],
        L[:, :, None],
        (codes[:, :, None] >> (8 * k)) & 0xFF], dim=2).to(torch.uint8)
    col = torch.arange(ENTRY_HEAD + ENTRY_CODE, device=dev)
    keep = present[:, :, None] & (col < ENTRY_HEAD + (L[:, :, None] + 7) // 8)
    W = 256 * (ENTRY_HEAD + ENTRY_CODE)
    return [(head, torch.full((B,), TABLE_HEAD, device=dev)),
            (entry.reshape(B, W), keep.reshape(B, W))]


def encode_huffman_batch(data, dlen):
    """[B, N] u8 (first dlen valid) -> (segments, width): each row's
    huffman_encode_memory blob, its table (kernel H over its histogram)
    and its bits, as rowwise_concat segments, and the columns they may
    take."""
    B, N = data.shape
    dev = data.device
    dlen = dlen.to(torch.int64).clamp(0, N)
    hist = byte_histogram(data, dlen)
    lengths, codes = huffman_build(hist)
    L = lengths.to(torch.int64)
    if B and int(L.max()) > ROW_CODE_BITS:
        raise ValueError(f"a Huffman code of {int(L.max())} bits: the "
                         f"codecs take codes of up to {ROW_CODE_BITS}")
    valid = torch.arange(N, device=dev)[None, :] < dlen[:, None]
    d = data.to(torch.int64)
    lens = torch.where(valid, L.gather(1, d), 0)
    ends = torch.cumsum(lens, dim=1)
    total = ends[:, -1] if N else torch.zeros_like(dlen)
    n_words = (int(total.max()) + 31) // 32 + 1 if B else 1
    bits = pack_fields_lsb(torch.where(valid, codes.gather(1, d), 0),
                           ends - lens, valid, n_words)
    segs = table_segments(hist > 0, lengths, codes, dlen) + [
        (bits, (total + 7) // 8)]
    return segs, TABLE_HEAD + 256 * (ENTRY_HEAD + ENTRY_CODE) + bits.shape[1]


#: the bytes past a table's start that its parse reads: the head and 256
#: entries of codes of up to 255 bits (the length is one byte)
_PARSE_SPAN = TABLE_HEAD + 256 * (ENTRY_HEAD + 32)


#: device bytes a row keeps beside its slots: its histogram, its table
#: (lengths int32 and codes int64), and its parse's three int64 rows of
#: _PARSE_SPAN (its bytes, the entry chain and its doubling)
STATE_BYTES = 8 * 256 + (4 + 8) * 256 + 3 * 8 * (_PARSE_SPAN + 8)


def parse_tables_batch(stream, off):
    """The serialized table at byte off of each row -> {lengths [B, 256]
    int32 (-1 absent), codes [B, 256] int64, data_bytes [B], end [B] (the
    bits' first byte)}, as tables/huffman.py parse_memory reads them (a
    later entry of a symbol wins; dataBytes 0 holds no entries).  An
    entry's start is the orbit of p -> p + 2 + ceil(len / 8) from the
    first, found by doubling; codes past ROW_CODE_BITS keep their low
    bytes (C2 never matches them)."""
    B = stream.shape[0]
    dev = stream.device
    off = off.to(torch.int64)
    Mw = stream.shape[1]
    idx = off[:, None] + torch.arange(_PARSE_SPAN + 8, device=dev)[None, :]
    b = torch.where(idx < Mw, stream.gather(1, idx.clamp(0, Mw - 1)),
                    0).to(torch.int64)
    data_bytes = read_u32be(torch.nn.functional.pad(stream, (0, 8)), off + 1)
    P = torch.where(data_bytes == 0, 0, b[:, 0] + 1)
    # entry starts, relative to off: X[:, k] for k = 0..256
    span = torch.arange(_PARSE_SPAN, device=dev)[None, :]
    nxt = (span + ENTRY_HEAD + (b[:, 1:_PARSE_SPAN + 1] + 7) // 8).clamp(
        max=_PARSE_SPAN - 1)
    X = torch.full((B, 1), TABLE_HEAD, dtype=torch.int64, device=dev)
    Fj = nxt
    while X.shape[1] < 257:
        X = torch.cat([X, Fj.gather(1, X)], dim=1)
        Fj = Fj.gather(1, Fj)
    X = X[:, :257]
    k = torch.arange(256, device=dev)[None, :]
    live = k < P[:, None]
    sym, L = b.gather(1, X[:, :256]), b.gather(1, X[:, :256] + 1)
    code = torch.zeros_like(L)
    for i in range(ENTRY_CODE):
        byte = b.gather(1, X[:, :256] + ENTRY_HEAD + i)
        code = code | torch.where(8 * i < L, byte, 0) << (8 * i)
    # the last live entry of each symbol
    win = torch.full((B, 257), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(1, torch.where(live, sym, 256),
                        torch.where(live, k, -1).expand(B, 256), "amax")
    win = win[:, :256]
    has = win >= 0
    w = win.clamp(min=0)
    lengths = torch.where(has, L.gather(1, w), -1).to(torch.int32)
    codes = torch.where(has, code.gather(1, w), 0)
    end = off + X.gather(1, P[:, None])[:, 0]
    return {"lengths": lengths, "codes": codes, "data_bytes": data_bytes,
            "end": end}


def decode_huffman_batch(stream, off, dlen, N: int):
    """The blob at byte off of each row -> its residual bytes [B, N] u8:
    dataBytes of them (at most dlen), decoded by C2 with the row's
    table.  ValueError where a row's walk stops short (a cut or corrupt
    stream)."""
    Mw = stream.shape[1]
    t = parse_tables_batch(stream, off)
    cnt = torch.minimum(t["data_bytes"], dlen.to(torch.int64).clamp(min=0))
    data, got = huffman_decode_rows(
        stream, t["end"].clamp(0, Mw).to(torch.int32),
        cnt.clamp(max=N).to(torch.int32), N, t["lengths"], t["codes"])
    if bool((got < cnt.clamp(max=N)).any()):
        raise ValueError("huffman stream corrupt: a row decoded fewer "
                         "symbols than its dataBytes")
    return data


# ---------------------------------------------------------------------------
# the codecs: press(sig [B, L] int16, n, kind, emax) -> (stream [B, M]
# u8, len [B]); depress(stream, n, kind, L, emax) -> [B, L] int16
# ---------------------------------------------------------------------------


def press_huffman_batch(sig, n, kind: str, emax: int = None):
    """huffman_<kind>_zd (codecs/huffman.py HuffmanVbZd)."""
    from honours_tpu_torch.engine.rc import vb_zd_parts

    segs, width, data, dlen = vb_zd_parts(sig, n, kind, emax or sig.shape[1])
    body, bwidth = encode_huffman_batch(data, dlen)
    return rowwise_concat(segs + body, width + bwidth)


def depress_huffman_batch(stream, n, kind: str, L: int, emax: int = None):
    from honours_tpu_torch.engine.rc import vb_zd_fill, vb_zd_parse

    zero = torch.zeros((stream.shape[0],), dtype=torch.int64,
                       device=stream.device)
    p = vb_zd_parse(stream, n, kind, L, emax, zero)
    data = decode_huffman_batch(stream, p["off"], p["count"], L)
    return vb_zd_fill(p, data, n, L)
