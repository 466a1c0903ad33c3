"""Bucketed execution of whole read sets through the batched engines.

Reads are grouped into power-of-two padded buckets (io/batching.py),
each bucket runs the batched engine of the codec on the device, and
per-read streams come back in original order, byte-identical to
honours_tpu's engine (and to its host codec for every read of n >= 1;
for shuffman, to the host codec where that engine cuts a row's bits,
engine/entropy.py).
Codecs and their engines:
  drans_vbbe21_zd     engine/drans.py     (batch-shared table fit)
  srans_vbbe21_zd     engine/pipeline.py  (canned order-0 rANS)
  srans2_vbbe21_zd    engine/pipeline.py  (canned order-1 rANS)
  srans3_vbbe21_zd    engine/pipeline.py  (nibble order-1 rANS)
  shuffman_vbbe21_zd  engine/pipeline.py  (canned static Huffman)
  svb12_zd, svb12     engine/svb16.py     (VBZ container, with/without zd)
  vb1e2_zd, vbe21_zd, vbbe21_zd, vbsbe21_zd, vbsse21_zd
                      engine/vb_batch.py  (vb exception containers)
  svb_zd, svb0124_zd  engine/vb_batch.py  (classic svb32 over zd)
  hasgam_vbsse21_zdq  engine/exzd.py      (ex-zd, slow5lib's variant)
  rice_vbe21_zd, rice_vbbe21_zd, rice_vbsbe21_zd, rice_vbsse21_zd
                      engine/rice.py      (rice-coded residual bytes)
  dstall_srans2       engine/dstall.py    (stall split, srans2 branches)
  dstall_drans        engine/dstall_drans.py (stall split, drans branches)
These are the 21 codecs of honours_tpu's ENGINE_CODECS; where its
runner decodes on the host (shuffman and rice), the port decodes on the
device.  RC_CODECS are 25 more, which honours_tpu runs on the host only
(its registry's codecs/rc.py and codecs/stall.py), here on the device
with the range coder of kernels D and E:
  rc_*, rcc_*, rccm_* (vb containers with and without zd), rc_zd,
  rccm_svb_zd, rccm_svb12_zd, rccm_vbbe21_submin
                      engine/rc.py
  rccm_svbbe21_zd, dstall_fz_1500, dstall_fz
                      engine/stall_fz.py  (stall split, rccm branches)
Their streams are the host codec's for every read (its press bytes for
n = 0).  ENTROPY_CODECS are 11 more, the per-read entropy codecs that
honours_tpu runs on the host only (codecs/rc.py's rccdf, codecs/
huffman.py), here on the device:
  rccdf_vbe21_zd, rccdf_vbbe21_zd, rccdf_vbsbe21_zd, rccdf_vbsse21_zd
                      engine/rc.py, engine/rccdf.py (kernels F and G)
  huffman_vbe21_zd, huffman_vbbe21_zd, huffman_vbsbe21_zd,
  huffman_vbsse21_zd  engine/huffman.py (kernel H, and C2 to decode)
  shuffman_vbe21_zd, shuffman_vbsbe21_zd, shuffman_vbsse21_zd
                      engine/pipeline.py (as shuffman_vbbe21_zd)
Their streams are the host codec's for every read of n >= 1 (rccdf's and
huffman's press bytes for n = 0 too; shuffman's keep their zd0 there, as
shuffman_vbbe21_zd's engine does).  RAW_CODECS are 16 more, the raw-sample
containers and the bit-packing codecs, which honours_tpu also runs on the
host only (codecs/vb.py, svb.py, uintc.py, flats.py):
  vb1e2, vbe21, vbbe21, vbsbe21, vbsse21, svb, svb0124
                      engine/vb_batch.py  (the samples as uint16)
  svb12_nosimd, svb12_zd_nosimd
                      engine/svb16.py     (svb12's and svb12_zd's format)
  uintx_16, uint11, uint, uint_submin, uint_zd, uint_zsm
                      engine/uint.py      (kernels I and J, L's mean)
  flat_uint_submin    engine/flats.py     (kernel K's partition, I, J,
                                           M's header walk)
Their streams are the host codec's for every read, n = 0 included.
BLOCK_CODECS and LAYER_CODECS are the last 33 of honours_tpu's registry,
which it also runs on the host only (codecs/pfor.py, flac.py, raw.py,
generic.py):
  turbopfor           engine/pfor.py      (kernels I, J and M)
  flac                engine/flac.py      (kernel N to decode)
  none                engine/layers.py    (the raw samples' bytes)
  zlib, zstd, bzip2, fast_lzma2 and their 26 compositions
  <layer>_<inner>     engine/layers.py    (the inner codec on the
                                           device, the layer on the host)
Their streams are the host codec's for every read, n = 0 included.

Two kinds of rows leave the bucket's group and run alone, as one-row
batches with emax = L (the grouping of a single-read host press, so the
bytes are the host codec's):
- encode and decode rows with more exceptions than the bucket's cap
  emax = L/16 (the exception count in the stream header, or in each
  branch blob's header for the dstall codecs, is exact even when the
  capped buffers overflowed, so such rows are found from their own
  bytes); svb streams have no exception cap;
- drans and dstall_drans decode rows whose (largest branch) G header is
  <= 1 (streams written per read).

A bucket whose working set would not fit the device is coded in row
slices (press_bucket, depress_bucket), and stays the coding group: the
slice size follows from the bucket's L, the codec's bytes a slot
(BYTES_A_SLOT, measured on the card) and the device's memory.  A
per-read codec codes its slices one after another; drans and
dstall_drans take the slice size into their engines, which fit one
table over all the slices (engine/drans.py), so the streams are those
of the unsliced bucket.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from honours_tpu_torch.device import resolve_device
from honours_tpu_torch.engine.drans import (
    depress_drans_batch,
    press_drans_batch,
    row_slices,
)
from honours_tpu_torch.engine.dstall import (
    depress_dstall_batch,
    press_dstall_batch,
)
from honours_tpu_torch.engine.dstall_drans import (
    depress_dstall_drans_batch,
    press_dstall_drans_batch,
)
from honours_tpu_torch.engine.exzd import depress_exzd_batch, press_exzd_batch
from honours_tpu_torch.engine.flac import depress_flac_batch, press_flac_batch
from honours_tpu_torch.engine.flats import (
    depress_flats_batch,
    press_flats_batch,
)
from honours_tpu_torch.engine.huffman import STATE_BYTES as HUFF_STATE
from honours_tpu_torch.engine.huffman import (
    depress_huffman_batch,
    press_huffman_batch,
)
from honours_tpu_torch.engine import layers, rc
from honours_tpu_torch.engine.pipeline import (
    canned_huffman_tables,
    canned_o1_device_tables,
    canned_o1n_device_tables,
    canned_rans_tables,
    depress_shuff_batch,
    depress_srans2_batch,
    depress_srans3_batch,
    depress_srans_batch,
    press_shuff_batch,
    press_srans2_batch,
    press_srans3_batch,
    press_srans_batch,
)
from honours_tpu_torch.engine.pfor import depress_pfor_batch, press_pfor_batch
from honours_tpu_torch.engine.rice import (
    depress_rice_vb_zd_batch,
    press_rice_vb_zd_batch,
)
from honours_tpu_torch.engine.rangecoder import STATE_BYTES
from honours_tpu_torch.engine.rccdf import STATE_BYTES as RCCDF_STATE
from honours_tpu_torch.engine.stall_fz import coder_rows as stall_fz_coder_rows
from honours_tpu_torch.engine.stall_fz import (
    depress_stall_fz_batch,
    press_stall_fz_batch,
    stall_fz_overflowed,
)
from honours_tpu_torch.engine.svb16 import (
    svb16_decode_batch,
    svb16_encode_batch,
)
from honours_tpu_torch.engine.uint import depress_uint_batch, press_uint_batch
from honours_tpu_torch.engine.vb_batch import (
    depress_svb_batch,
    depress_svb_zd_batch,
    depress_vb_batch,
    depress_vb_zd_batch,
    press_svb_batch,
    press_svb_zd_batch,
    press_vb_batch,
    press_vb_zd_batch,
)
from honours_tpu_torch.io.batching import bucket_reads, restore_order

#: codec name -> engine kind (as honours_tpu/engine/runner.py names them;
#: "family:container" for the vb, svb32 and rice families)
ENGINE_CODECS = {
    "drans_vbbe21_zd": "drans",
    "srans_vbbe21_zd": "srans",
    "srans2_vbbe21_zd": "srans2",
    "srans3_vbbe21_zd": "srans3",
    "shuffman_vbbe21_zd": "shuff",
    "svb12_zd": "svb16_zd",
    "svb12": "svb16",
    "vb1e2_zd": "vb_zd:vb1e2",
    "vbe21_zd": "vb_zd:vbe21",
    "vbbe21_zd": "vb_zd:vbbe21",
    "vbsbe21_zd": "vb_zd:vbsbe21",
    "vbsse21_zd": "vb_zd:vbsse21",
    "svb_zd": "svb32_zd:1234",
    "svb0124_zd": "svb32_zd:0124",
    "hasgam_vbsse21_zdq": "exzd",
    "rice_vbe21_zd": "rice_zd:vbe21",
    "rice_vbbe21_zd": "rice_zd:vbbe21",
    "rice_vbsbe21_zd": "rice_zd:vbsbe21",
    "rice_vbsse21_zd": "rice_zd:vbsse21",
    "dstall_srans2": "dstall",
    "dstall_drans": "dstall_drans",
}

#: the range-coder codecs (honours_tpu/codecs/rc.py, codecs/stall.py):
#: codec name -> engine kind ("family:coder:container" for the vb ones)
RC_CODECS = {
    **{f"{c}_{k}_zd": f"rc_vb_zd:{c}:{k}" for c in ("rc", "rcc", "rccm")
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")},
    **{f"{c}_{k}": f"rc_vb:{c}:{k}" for c in ("rc", "rccm")
       for k in ("vbbe21", "vbsbe21", "vbsse21")},
    "rc_zd": "rc_zd",
    "rccm_svb_zd": "rccm_svb:svb32",
    "rccm_svb12_zd": "rccm_svb:svb16",
    "rccm_vbbe21_submin": "rc_submin",
    "rccm_svbbe21_zd": "stall_fz:stall",
    "dstall_fz_1500": "stall_fz:dstall",
    "dstall_fz": "stall_fz:pick",
}
#: the per-read entropy codecs (honours_tpu/codecs/rc.py's rccdf,
#: codecs/huffman.py): codec name -> engine kind ("rc_vb_zd:rccdf:<vb>",
#: "huffman_zd:<vb>", "shuff:<vb>")
ENTROPY_CODECS = {
    **{f"rccdf_{k}_zd": f"rc_vb_zd:rccdf:{k}"
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")},
    **{f"huffman_{k}_zd": f"huffman_zd:{k}"
       for k in ("vbe21", "vbbe21", "vbsbe21", "vbsse21")},
    **{f"shuffman_{k}_zd": f"shuff:{k}"
       for k in ("vbe21", "vbsbe21", "vbsse21")},
}
#: the raw-sample containers and the bit-packing codecs (honours_tpu/
#: codecs/vb.py VbCodec, svb.py, uintc.py, flats.py): codec name -> engine
#: kind ("vb:<vb>", "svb32:<variant>", "uint:<variant>", "flats"; the
#: nosimd pair on svb12's kinds)
RAW_CODECS = {
    **{k: f"vb:{k}" for k in ("vb1e2", "vbe21", "vbbe21", "vbsbe21",
                              "vbsse21")},
    "svb": "svb32:1234",
    "svb0124": "svb32:0124",
    "svb12_nosimd": "svb16",
    "svb12_zd_nosimd": "svb16_zd",
    "uintx_16": "uint:x16",
    "uint11": "uint:x11",
    "uint": "uint:plain",
    "uint_submin": "uint:submin",
    "uint_zd": "uint:zd",
    "uint_zsm": "uint:zsm",
    "flat_uint_submin": "flats",
}
#: turbopfor, flac and none (honours_tpu/codecs/pfor.py, flac.py, raw.py):
#: codec name -> engine kind
BLOCK_CODECS = {"turbopfor": "pfor", "flac": "flac", "none": "none"}
#: the byte layers over none and their compositions (honours_tpu/codecs/
#: generic.py, exzd.py, flac.py): codec name -> "layer:<layer>:<inner>"
LAYER_CODECS = {name: f"layer:{layer}:{inner}"
                for name, (layer, inner, _) in layers.COMPOSED.items()}
#: every codec the port runs: all of honours_tpu's registry
CODECS = {**ENGINE_CODECS, **RC_CODECS, **ENTROPY_CODECS, **RAW_CODECS,
          **BLOCK_CODECS, **LAYER_CODECS}

#: byte offset of the exception count in each capped family's stream:
#: [G:u16][zd0:u16][nex:u32]..., [zd0:u16][nex:u32]..., [min:u16]
#: [nex:u32]..., [nex:u32]... and ex-zd's [ver:1][nin:u64][q:1][zd0:u16]
#: [nex:u32]...; for the dstall families, in each branch blob (srans2's
#: and drans's; stall_fz.stall_fz_overflowed reads the stall-fz blobs);
#: the svb families, rc_zd, uint, flats, pfor, flac and none have no cap
_NEX_AT = {"drans": 4, "srans": 2, "srans2": 2, "srans3": 2, "shuff": 2,
           "vb_zd": 2, "rice_zd": 2, "exzd": 12, "dstall": 2,
           "dstall_drans": 4, "rc_vb_zd": 2, "rc_vb": 0, "rc_submin": 2,
           "huffman_zd": 2, "vb": 0}

#: capped kind -> (device tables, batched press, batched depress)
_CAPPED = {
    "drans": (canned_o1_device_tables, press_drans_batch,
              depress_drans_batch),
    "srans": (canned_rans_tables, press_srans_batch, depress_srans_batch),
    "srans2": (canned_o1_device_tables, press_srans2_batch,
               depress_srans2_batch),
    "srans3": (canned_o1n_device_tables, press_srans3_batch,
               depress_srans3_batch),
    "shuff": (canned_huffman_tables, press_shuff_batch, depress_shuff_batch),
    "dstall": (canned_o1_device_tables, press_dstall_batch,
               depress_dstall_batch),
    "dstall_drans": (canned_o1_device_tables, press_dstall_drans_batch,
                     depress_dstall_drans_batch),
}


#: the kinds whose bucket is one coding group: one table fitted over all
#: its rows, so their engines take the slice size themselves
_GROUPED = ("drans", "dstall_drans")

#: bytes of device memory a bucket slot (one sample of one row) takes at
#: the peak of the codec's press or depress, the larger of the two: an
#: unsliced [16, 2^20] bucket of synthetic reads on an NVIDIA H100 80GB
#: HBM3 (700 W), rounded up (tools/bytes_a_slot.py); flat in B and L
#: (tools/long_reads_probe.py).  The range-coder codecs': [16, 2^17] for
#: rc and rcc (whose coder state is small), [8, 2^21] for rccm and the
#: stall-fz codecs, where the stages' peak passes the coder launch's
#: (rccm_vbbe21_zd's 61 stands for its three sibling containers, the
#: submin codec's 43 for the three raw rccm kinds); ROW_BYTES adds the
#: coder's state.  The per-read entropy codecs': [16, 2^20] (tools/
#: bytes_a_slot.py --entropy), rccdf's peak the depress's, huffman's and
#: shuffman's the press's.  The raw codecs': [16, 2^20] (tools/
#: bytes_a_slot.py --raw; the raw vb containers' rows overflow the
#: exception cap there and are pressed alone).  turbopfor's, flac's and
#: none's: [16, 2^20] (tools/bytes_a_slot.py --block); a layer codec
#: takes its inner codec's, as its layer runs on the host.
BYTES_A_SLOT = {
    "drans_vbbe21_zd": 64, "srans_vbbe21_zd": 61, "srans2_vbbe21_zd": 61,
    "srans3_vbbe21_zd": 61, "shuffman_vbbe21_zd": 182, "svb12_zd": 5,
    "svb12": 5, "vb1e2_zd": 59, "vbe21_zd": 61, "vbbe21_zd": 61,
    "vbsbe21_zd": 61, "vbsse21_zd": 61, "svb_zd": 84, "svb0124_zd": 84,
    "hasgam_vbsse21_zdq": 74, "rice_vbe21_zd": 196, "rice_vbbe21_zd": 196,
    "rice_vbsbe21_zd": 196, "rice_vbsse21_zd": 196, "dstall_srans2": 63,
    "dstall_drans": 73,
    **{name: 61 for name, kind in RC_CODECS.items()
       if kind.startswith("rc_vb_zd:")},
    "rc_vbbe21": 33, "rc_vbsbe21": 34, "rc_vbsse21": 34, "rc_zd": 66,
    "rccm_vbbe21": 43, "rccm_vbsbe21": 43, "rccm_vbsse21": 43,
    "rccm_svb_zd": 87, "rccm_svb12_zd": 27, "rccm_vbbe21_submin": 43,
    "rccm_svbbe21_zd": 62, "dstall_fz_1500": 61, "dstall_fz": 61,
    **{name: 61 for name in ENTROPY_CODECS if name.startswith("rccdf")},
    **{name: 163 for name in ENTROPY_CODECS if name.startswith("huffman")},
    "shuffman_vbe21_zd": 182, "shuffman_vbsbe21_zd": 181,
    "shuffman_vbsse21_zd": 181,
    "vb1e2": 30, "vbe21": 34, "vbbe21": 33, "vbsbe21": 34, "vbsse21": 34,
    "svb": 84, "svb0124": 84, "svb12_nosimd": 5, "svb12_zd_nosimd": 5,
    "uintx_16": 32, "uint11": 31, "uint": 31, "uint_submin": 31,
    "uint_zd": 51, "uint_zsm": 46, "flat_uint_submin": 55,
    "turbopfor": 105, "flac": 191, "none": 8,
}
BYTES_A_SLOT.update({name: BYTES_A_SLOT[inner]
                     for name, (_, inner, _) in layers.COMPOSED.items()})
def _coder_state(kind: str) -> int:
    """Device bytes of a range-coder kind's model state a bucket row:
    rangecoder.STATE_BYTES for each coder row its engine launches."""
    family, _, sub = kind.partition(":")
    model, rows = (stall_fz_coder_rows(sub) if family == "stall_fz"
                   else rc.coder_rows(kind))
    return rows * STATE_BYTES[model]


#: bytes of device memory a bucket row takes beside its slots: the range
#: coder's model state, rccdf's and huffman's per-row tables
#: (rccdf.STATE_BYTES, huffman.STATE_BYTES); 0 for the engine codecs and
#: shuffman
ROW_BYTES = {**{name: 0 for name in ENGINE_CODECS},
             **{name: 0 for name in RAW_CODECS},
             **{name: 0 for name in BLOCK_CODECS},
             **{name: _coder_state(kind) for name, kind in RC_CODECS.items()},
             **{name: {"rc_vb_zd": RCCDF_STATE, "huffman_zd": HUFF_STATE}.get(
                 kind.partition(":")[0], 0)
                for name, kind in ENTROPY_CODECS.items()}}
ROW_BYTES.update({name: ROW_BYTES[inner]
                  for name, (_, inner, _) in layers.COMPOSED.items()})
#: the share of the device's memory one slice's working set may take;
#: the rest holds what a bucket keeps on the device whole (for drans and
#: dstall_drans its signal, branch signals and streams) and the
#: allocator's slack
SLICE_SHARE = 1 / 3


def device_memory(dev: torch.device) -> int:
    """Bytes of memory of a device: the card's, or the host's RAM."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def slice_rows(codec_name: str, L: int, dev: torch.device) -> int:
    """Rows a slice of an L-wide bucket of `codec_name` holds on `dev`:
    as many as keep one slice's working set (its slots and its rows'
    coder state) within SLICE_SHARE of the device's memory, at least
    one."""
    need = BYTES_A_SLOT[codec_name] * L + ROW_BYTES[codec_name]
    return max(1, int(SLICE_SHARE * device_memory(dev)) // need)


def engine_kind(codec_name: str) -> str:
    """The engine kind of a ported codec; NotImplementedError for any
    other name."""
    if codec_name not in CODECS:
        raise NotImplementedError(
            f"{codec_name} is not one of the {len(CODECS)} codecs this "
            f"port runs: {', '.join(sorted(CODECS))}")
    return CODECS[codec_name]


def engine_codec_names() -> list[str]:
    """The engine codecs in honours_tpu's engine_codec_names() order."""
    return sorted(ENGINE_CODECS)


def codec_names() -> list[str]:
    """Every codec the port runs (ENGINE_CODECS, RC_CODECS,
    ENTROPY_CODECS, RAW_CODECS, BLOCK_CODECS and LAYER_CODECS), sorted:
    honours_tpu.codecs.base.names()."""
    return sorted(CODECS)


def _rc_engine(family: str, sub: str):
    """batch_engine's pair for a range-coder codec."""
    if family == "rc_vb_zd":
        coder, kind = sub.split(":")
        return (lambda sig, n, emax: rc.press_rc_vb_zd_batch(
                    sig, n, coder, kind, emax),
                lambda buf, n, L, emax: rc.depress_rc_vb_zd_batch(
                    buf, n, coder, kind, L, emax))
    if family == "rc_vb":
        coder, kind = sub.split(":")
        return (lambda sig, n, emax: rc.press_rc_vb_batch(
                    sig, n, coder, kind, emax),
                lambda buf, n, L, emax: rc.depress_rc_vb_batch(
                    buf, n, coder, kind, L, emax))
    if family == "rc_zd":
        return (lambda sig, n, emax: rc.press_rc_zd_batch(sig, n),
                lambda buf, n, L, emax: rc.depress_rc_zd_batch(buf, n, L))
    if family == "rccm_svb":
        return (lambda sig, n, emax: rc.press_rccm_svb_batch(sig, n, sub),
                lambda buf, n, L, emax: rc.depress_rccm_svb_batch(
                    buf, n, L, sub))
    if family == "rc_submin":
        return (rc.press_rc_submin_batch, rc.depress_rc_submin_batch)
    return (lambda sig, n, emax: press_stall_fz_batch(sig, n, sub, emax),
            depress_stall_fz_batch)


def batch_engine(codec_name: str, dev):
    """(press(sig, n, emax) -> (stream, len), depress(buf, n, L, emax) ->
    [B, L] int16): the batched engine of a codec on device `dev`.  The
    engines of drans and dstall_drans also take `rows`, the slice size
    they code the batch in."""
    kind = engine_kind(codec_name)
    family, _, sub = kind.partition(":")
    if family == "layer":
        return layers.layer_engine(codec_name,
                                   batch_engine(_inner(kind), dev), dev)
    if codec_name in RC_CODECS or family == "rc_vb_zd":
        return _rc_engine(family, sub)
    if family == "huffman_zd":
        return (lambda sig, n, emax: press_huffman_batch(sig, n, sub, emax),
                lambda buf, n, L, emax: depress_huffman_batch(
                    buf, n, sub, L, emax))
    if family == "shuff" and sub:
        tabs = canned_huffman_tables(dev)
        return (lambda sig, n, emax: press_shuff_batch(sig, n, tabs, emax,
                                                       sub),
                lambda buf, n, L, emax: depress_shuff_batch(
                    buf, n, tabs, L, emax, sub))
    if kind in _GROUPED:
        tables, press, depress = _CAPPED[kind]
        tabs = tables(dev)
        return (lambda sig, n, emax, rows=None: press(sig, n, tabs, emax,
                                                      rows=rows),
                lambda buf, n, L, emax, rows=None: depress(
                    buf, n, tabs, L, emax=emax, rows=rows))
    if kind in _CAPPED:
        tables, press, depress = _CAPPED[kind]
        tabs = tables(dev)
        return (lambda sig, n, emax: press(sig, n, tabs, emax),
                lambda buf, n, L, emax: depress(buf, n, tabs, L, emax=emax))
    if family == "vb_zd":
        return (lambda sig, n, emax: press_vb_zd_batch(sig, n, sub, emax),
                lambda buf, n, L, emax: depress_vb_zd_batch(buf, n, sub, L,
                                                            emax))
    if family == "svb32_zd":
        return (lambda sig, n, emax: press_svb_zd_batch(sig, n, sub),
                lambda buf, n, L, emax: depress_svb_zd_batch(buf, n, L, sub))
    if family == "exzd":
        return press_exzd_batch, depress_exzd_batch
    if family == "rice_zd":
        return (lambda sig, n, emax: press_rice_vb_zd_batch(sig, n, sub,
                                                            emax),
                lambda buf, n, L, emax: depress_rice_vb_zd_batch(
                    buf, n, sub, L, emax))
    if family == "vb":
        return (lambda sig, n, emax: press_vb_batch(sig, n, sub, emax),
                lambda buf, n, L, emax: depress_vb_batch(buf, n, sub, L,
                                                         emax))
    if family == "svb32":
        return (lambda sig, n, emax: press_svb_batch(sig, n, sub),
                lambda buf, n, L, emax: depress_svb_batch(buf, n, L, sub))
    if family == "uint":
        return (lambda sig, n, emax: press_uint_batch(sig, n, sub),
                lambda buf, n, L, emax: depress_uint_batch(buf, n, L, sub))
    if family in _BLOCK_ENGINES:
        press, depress = _BLOCK_ENGINES[family]
        return (lambda sig, n, emax: press(sig, n),
                lambda buf, n, L, emax: depress(buf, n, L))
    zd = kind == "svb16_zd"
    return (lambda sig, n, emax: svb16_encode_batch(sig, n, zd),
            lambda buf, n, L, emax: svb16_decode_batch(buf, n, L, zd))


#: uncapped kind -> (batched press(sig, n), batched depress(buf, n, L))
_BLOCK_ENGINES = {
    "flats": (press_flats_batch, depress_flats_batch),
    "pfor": (press_pfor_batch, depress_pfor_batch),
    "flac": (press_flac_batch, depress_flac_batch),
    "none": (layers.press_none_batch, layers.depress_none_batch),
}


def _inner(kind: str):
    """The inner codec of a layer kind, else None."""
    family, _, sub = kind.partition(":")
    return sub.partition(":")[2] if family == "layer" else None


def _emax(L: int) -> int:
    return max(64, L // 16)


def _nex_overflowed(blob: bytes, kind: str, emax: int) -> bool:
    """The exact exception count in the stream header exceeds emax."""
    family = kind.partition(":")[0]
    at = _NEX_AT.get(family)
    if family in ("dstall", "dstall_drans"):
        return _dstall_overflowed(blob, at, emax)
    if family == "stall_fz":
        return stall_fz_overflowed(blob, emax)
    if at is None or len(blob) < at + 4:
        return False
    (nex,) = struct.unpack_from("<I", blob, at)
    return nex > emax


def _dstall_overflowed(blob: bytes, at: int, emax: int) -> bool:
    """A dstall stream's branch blob, [0][len:u32][blob] or [1][start:u16]
    [length:u16][stall_len:u32][stall blob][ns_len:u32][nonstall blob],
    has its exception count (at byte `at` of the blob) above emax; a
    split stream too short to hold its nonstall blob's count counts as
    overflowed."""
    if len(blob) < 9 + at:
        return False
    if not blob[0]:
        return struct.unpack_from("<I", blob, 5 + at)[0] > emax
    (stall_len,) = struct.unpack_from("<I", blob, 5)
    ns_off = 9 + stall_len + 4
    if len(blob) < ns_off + at + 4:
        return True
    return (struct.unpack_from("<I", blob, 9 + at)[0] > emax
            or struct.unpack_from("<I", blob, ns_off + at)[0] > emax)


def _gmax(blob: bytes) -> int:
    """The largest branch-blob G header of a dstall_drans stream."""
    if not blob[0]:
        return struct.unpack_from("<H", blob, 5)[0]
    (stall_len,) = struct.unpack_from("<I", blob, 5)
    g1 = struct.unpack_from("<H", blob, 9)[0] if stall_len >= 2 else 0
    off = 9 + stall_len
    (ns_len,) = struct.unpack_from("<I", blob, off)
    g2 = struct.unpack_from("<H", blob, off + 4)[0] if ns_len >= 2 else 0
    return max(g1, g2)


def _per_read(blob: bytes, kind: str) -> bool:
    """drans and dstall_drans streams with G <= 1 were pressed alone and
    decode alone."""
    if kind == "drans":
        return len(blob) >= 2 and struct.unpack_from("<H", blob, 0)[0] <= 1
    return kind == "dstall_drans" and _gmax(blob) <= 1


def _press_one(press, sig: np.ndarray, L: int, dev) -> bytes:
    s = torch.zeros((1, L), dtype=torch.int16, device=dev)
    s[0, : sig.size] = torch.from_numpy(sig).to(dev)
    n = torch.tensor([sig.size], dtype=torch.int32, device=dev)
    st, sl = press(s, n, L)
    return st[0, : int(sl[0])].cpu().numpy().tobytes()


def _depress_one(depress, blob: bytes, nin: int, L: int, dev) -> np.ndarray:
    W = max(128, -(-len(blob) // 128) * 128)
    buf = np.zeros((1, W), np.uint8)
    buf[0, : len(blob)] = np.frombuffer(blob, np.uint8)
    n = torch.tensor([nin], dtype=torch.int32, device=dev)
    out = depress(torch.from_numpy(buf).to(dev), n, L, L)
    return out[0, :nin].cpu().numpy()


def press_read(signal, codec_name: str = "drans_vbbe21_zd",
               device="cuda") -> bytes:
    """Compress one read alone: a one-row batch at its bucket's width
    with emax = L, the one-row path of press_signals, whose bytes are
    the host codec's press of that read (for n >= 1)."""
    inner = _inner(engine_kind(codec_name))
    if inner:
        return layers.wrap(codec_name, [press_read(signal, inner, device)],
                           [np.asarray(signal).size])[0]
    dev = resolve_device(device)
    press, _ = batch_engine(codec_name, dev)
    sig = np.asarray(signal, np.int16)
    (b,) = bucket_reads([sig])
    return _press_one(press, sig, b.L, dev)


def press_bucket(sig: np.ndarray, n: np.ndarray, codec_name: str,
                 device="cuda", rows: int = None) -> list[bytes]:
    """Compress one bucket, sig [B, L] int16 (first n[b] valid), -> each
    row's stream.  The bucket is coded in slices of `rows` rows
    (slice_rows by default); the streams do not depend on it."""
    kind = engine_kind(codec_name)
    inner = _inner(kind)
    if inner:  # the inner codec on the device, the layer on the host
        return layers.wrap(codec_name, press_bucket(sig, n, inner, device,
                                                    rows), n)
    dev = resolve_device(device)
    press, _ = batch_engine(codec_name, dev)
    B, L = sig.shape
    emax = _emax(L)
    rows = rows or slice_rows(codec_name, L, dev)

    def on(a):
        return torch.from_numpy(a).to(dev)

    if kind in _GROUPED:
        parts = [(slice(0, B), press(on(sig), on(n), emax, rows))]
    else:
        parts = [(s, press(on(sig[s]), on(n[s]), emax))
                 for s in row_slices(B, rows)]
    out = []
    for s, (st, sl) in parts:
        st, sl = st.cpu().numpy(), sl.cpu().numpy()
        for i, j in enumerate(range(s.start, s.stop)):
            blob = st[i, : sl[i]].tobytes()
            if _nex_overflowed(blob, kind, emax):
                blob = _press_one(press, sig[j, : n[j]], L, dev)
            out.append(blob)
    return out


def depress_bucket(streams, n: np.ndarray, L: int, codec_name: str,
                   device="cuda", rows: int = None) -> list[np.ndarray]:
    """Decode one bucket's streams (the rows of one press_bucket, from
    either package) -> each row's int16 signal.  Decodes in slices of
    `rows` rows (slice_rows by default); the output does not depend on
    it."""
    kind = engine_kind(codec_name)
    inner = _inner(kind)
    if inner:
        return depress_bucket(layers.unwrap(codec_name, streams, n), n, L,
                              inner, device, rows)
    dev = resolve_device(device)
    _, depress = batch_engine(codec_name, dev)
    B = len(streams)
    emax = _emax(L)
    rows = rows or slice_rows(codec_name, L, dev)
    alone = {j for j, blob in enumerate(streams)
             if _nex_overflowed(blob, kind, emax) or _per_read(blob, kind)}

    def buf_of(s):
        # rows decoded alone stay zero here: a zero row parses as an
        # empty stream, so the group keeps the encoder's membership
        W = max(128, -(-max(len(streams[j]) for j in range(s.start, s.stop))
                     // 128) * 128)
        buf = np.zeros((s.stop - s.start, W), np.uint8)
        for i, j in enumerate(range(s.start, s.stop)):
            if j not in alone:
                buf[i, : len(streams[j])] = np.frombuffer(streams[j],
                                                          np.uint8)
        return torch.from_numpy(buf).to(dev)

    def n_of(s):
        return torch.from_numpy(n[s]).to(dev)

    dec = [None] * B
    if kind in _GROUPED:
        parts = [slice(0, B)] if len(alone) < B else []
        outs = [depress(buf_of(s), n_of(s), L, emax, rows) for s in parts]
    else:
        parts = [s for s in row_slices(B, rows)
                 if any(j not in alone for j in range(s.start, s.stop))]
        outs = [depress(buf_of(s), n_of(s), L, emax) for s in parts]
    for s, out in zip(parts, outs):
        out = out.cpu().numpy()
        for i, j in enumerate(range(s.start, s.stop)):
            if j not in alone:
                dec[j] = out[i, : n[j]]
    for j in alone:
        dec[j] = _depress_one(depress, streams[j], int(n[j]), L, dev)
    return dec


def press_signals(signals, codec_name: str = "drans_vbbe21_zd",
                  max_b: int = 256, device="cuda"):
    """Compress int16 reads -> list[bytes] in original order."""
    engine_kind(codec_name)
    buckets = bucket_reads(signals, max_b=max_b)
    return restore_order(buckets, [
        press_bucket(b.sig, b.n, codec_name, device) for b in buckets])


def depress_signals(streams, lengths, codec_name: str = "drans_vbbe21_zd",
                    max_b: int = 256, device="cuda"):
    """Decode per-read streams (from either package) -> int16 arrays in
    original order.  The bucketing must match the encoder's max_b."""
    engine_kind(codec_name)
    buckets = bucket_reads([np.zeros(int(m), np.int16) for m in lengths],
                           max_b=max_b)
    return restore_order(buckets, [
        depress_bucket([streams[i] for i in b.indices], b.n, b.L,
                       codec_name, device) for b in buckets])
