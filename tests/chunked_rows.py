"""Adversarial rows for kernels B (rice decode) and C (static-Huffman
decode), whose chunked decode cuts each row's bit stream into chunks
(engine/rice_cuda.py CHUNK_BITS) and makes them exact by
self-synchronisation.  Imports only numpy, torch and the port, so both
tests/test_torch_chunked_decode.py (CPU, with the JAX package) and
tests/test_torch_gpu.py (the card, no JAX) use it.

A case is (stream [B, M] u8, off [B] i32, count [B] i32, N); Huffman
cases also carry their decode tables."""

import functools

import numpy as np
import torch

RICE_NAMES = ("k0_runs", "chunk_end_phases", "two_tiles", "counts_mid_chunk",
              "all_ff", "cut_and_wild")
HUFFMAN_NAMES = ("random", "counts_mid_chunk", "two_tiles", "zero_tail",
                 "zero_tail_count_past", "guard_before_count",
                 "guard_after_count", "cut_and_wild")


def _pack(rows, encode):
    """Rows of values -> their streams as byte strings, through the
    port's batched encoder `encode(data [B, N] u8, count [B]) -> (blob,
    blob_len)`."""
    N = max(1, max(r.size for r in rows))
    data = np.zeros((len(rows), N), np.uint8)
    for i, r in enumerate(rows):
        data[i, : r.size] = r
    cnt = torch.tensor([r.size for r in rows], dtype=torch.int32)
    blob, blen = encode(torch.from_numpy(data), cnt)
    return [blob[i, : int(blen[i])].numpy().tobytes()
            for i in range(len(rows))]


def place(streams, offs, M=None, fill=0):
    """Streams at byte offs[i] of rows of M bytes (long enough by
    default) of `fill` bytes, zeros after each stream."""
    M = M or max(o + len(s) for s, o in zip(streams, offs)) + 3
    st = np.full((len(streams), M), fill, np.uint8)
    for i, (s, o) in enumerate(zip(streams, offs)):
        st[i, max(o, 0):] = 0
        b = np.frombuffer(s, np.uint8)[: max(0, M - o)]
        st[i, o: o + b.size] = b
    return st


def rice_streams(rows):
    from honours_tpu_torch.engine.rice import rice_encode_batch

    return _pack(rows, rice_encode_batch)


def rice_k(blob: bytes) -> int:
    return (blob[0] & 1) << 2 | (blob[0] >> 1 & 1) << 1 | (blob[0] >> 2 & 1)


def _case(streams, offs, counts, N, M=None, fill=0):
    return (place(streams, offs, M, fill), np.asarray(offs, np.int32),
            np.asarray(counts, np.int32), N)


def rice_value_rows(seed=0):
    """The value rows of the rice cases that decode whole streams."""
    rng = np.random.default_rng(seed)
    # k = 0 (values mostly 0) with runs of 200 to 255 ones that cross
    # chunk ends
    runs = np.zeros(3000, np.int64)
    runs[::200] = rng.integers(200, 256, runs[::200].size)
    # codes of 7 and 8 bits after a prefix of j long ones: the chunk ends
    # fall at every bit offset mod 8 inside a code
    phase = [np.concatenate([np.full(j, 200), rng.integers(0, 128, 900)])
             for j in range(8)]
    # two tiles and more, every k
    long = rng.geometric(1 / 6, 40_000).clip(1, 256) - 1
    return {"runs": [runs, runs[:1500]], "phase": phase, "long": [long]}


@functools.cache
def rice_cases(seed=0):
    """name -> (stream, off, count, N) of kernel B."""
    rows = rice_value_rows(seed)
    cases = {}
    s = rice_streams(rows["runs"])
    cases["k0_runs"] = _case(s, [0, 5], [3000, 1500], 3001)
    s = rice_streams(rows["phase"])
    cases["chunk_end_phases"] = _case(s, list(range(8)),
                                      [r.size for r in rows["phase"]], 910)
    s = rice_streams(rows["long"])
    n = rows["long"][0].size
    cases["two_tiles"] = _case(s, [3], [n], n)
    # counts ending mid-chunk, and past the values coded
    s = rice_streams(rows["runs"])
    cases["counts_mid_chunk"] = _case(s, [0, 2], [777, 2999], 3002)
    # all 0xFF: one unary run to the end of the row, then zeros
    ff = np.full((3, 2000), 0xFF, np.uint8)
    cases["all_ff"] = (ff, np.array([0, 7, 1999], np.int32),
                       np.array([40, 2000, 5], np.int32), 2003)
    # streams cut inside their last chunk (a code runs past the row),
    # offsets past M and negative, counts past N and negative
    s = rice_streams([rows["runs"][0], rows["phase"][3]])
    cut = place(s, [0, 0], M=300)
    cases["cut_and_wild"] = (np.concatenate([cut, cut]),
                             np.array([0, 3, 300, -4], np.int32),
                             np.array([3000, 5000, 9, -2], np.int32), 1001)
    return cases


def huffman_tables():
    from honours_tpu_torch.engine.pipeline import canned_huffman_tables

    return canned_huffman_tables("cpu")


def zero_length_tables(sym: int):
    """The canned tables with symbol `sym`'s code made a window no code
    starts (length 0: the decode's corrupt-stream guard), in lut and in
    l1 (as first and as second code)."""
    tabs = huffman_tables()
    lut = tabs["lut"].numpy().copy()
    l1 = tabs["l1"].numpy().copy()
    lut[(lut & 0xFF) == sym] = 0
    first = ((l1 >> 8) & 31) > 0
    l1[first & ((l1 & 0xFF) == sym)] = 0
    second = (l1 >> 24) > 0
    l1[second & (((l1 >> 16) & 0xFF) == sym)] &= 0xFFFF
    return {"lut": torch.from_numpy(lut), "l1": torch.from_numpy(l1)}


def huffman_streams(rows):
    from honours_tpu_torch.engine.entropy import shuff_encode_batch

    tabs = huffman_tables()
    blobs = _pack(rows, lambda d, c: shuff_encode_batch(d, c, tabs))
    return [b[4:] for b in blobs]  # past the 4-byte dataBytes header


#: the symbol of the zero-length guard rows, and the zero window's
#: symbol (its code is all zeros)
GUARD_SYM = 200
ZERO_SYM = 7


def huffman_value_rows(seed=0):
    rng = np.random.default_rng(seed)
    # the guard's code at symbols 5000, 2500 and 5999 (chunks 100 and
    # later of about 45 symbols each)
    guard = [rng.integers(0, GUARD_SYM, 6000) for _ in range(3)]
    for g, at in zip(guard, (5000, 2500, 5999)):
        g[at] = GUARD_SYM
    return {
        "random": [rng.integers(0, 256, 5000), rng.integers(0, 40, 3000),
                   np.full(2000, 255), np.array([9])],
        "long": [(rng.geometric(0.3, 60_000) - 1).clip(0, 255)],
        "zero_tail": [np.concatenate([rng.integers(0, 256, 3000),
                                      np.full(500, ZERO_SYM)]),
                      np.full(900, ZERO_SYM)],
        "guard": guard,
    }


@functools.cache
def huffman_cases(seed=0):
    """name -> (stream, off, count, N, tables) of kernel C."""
    rows = huffman_value_rows(seed)
    tabs = huffman_tables()
    cases = {}
    r = rows["random"]
    s = huffman_streams(r)
    cases["random"] = (*_case(s, [0, 1, 2, 3], [x.size for x in r], 5003,
                              fill=0xEE), tabs)
    cases["counts_mid_chunk"] = (*_case(s, [0, 1, 2, 3], [2501, 1234, 999,
                                                          0], 5000), tabs)
    s = huffman_streams(rows["long"])
    n = rows["long"][0].size
    cases["two_tiles"] = (*_case(s, [2], [n], n + 1), tabs)
    # the zero window's code to the end of the row, and counts past it
    r = rows["zero_tail"]
    s = huffman_streams(r)
    cases["zero_tail"] = (*_case(s, [0, 0], [x.size for x in r], 4000,
                                 M=max(map(len, s)) + 700), tabs)
    cases["zero_tail_count_past"] = (*_case(
        s, [0, 0], [4000, 4000], 4002, M=max(map(len, s)) + 700), tabs)
    # a window no code starts in a late chunk, before and after count
    g = rows["guard"]
    s = huffman_streams(g)
    bad = zero_length_tables(GUARD_SYM)
    cases["guard_before_count"] = (*_case(s, [0, 1, 0], [6000] * 3, 6000),
                                   bad)
    cases["guard_after_count"] = (*_case(s, [0, 1, 0], [4000, 1000, 5999],
                                         6001), bad)
    # streams cut inside their last chunk (a code runs past the row),
    # offsets past M and negative, counts past N and negative
    s = huffman_streams(rows["random"][:2])
    cut = place(s, [0, 0], M=300)
    cases["cut_and_wild"] = (np.concatenate([cut, cut]),
                             np.array([0, 3, 300, -4], np.int32),
                             np.array([5000, 9000, 9, -2], np.int32), 1001,
                             tabs)
    return cases
