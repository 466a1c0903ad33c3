"""The batched stall segmenter: the first stall segment of each read.

The counterpart of honours_tpu/segment/__init__.py find_stall_batch,
whose contract is the serial C oracle honours_tpu/native/segment.c (the
reference's jnn adaptor/stall detector, cDNA parameter profile): clamp
to [0, 1200], float32 mean and standard deviation summed serially in
sample order, in-band thresholds mean +- 0.75 sd, then a run state
machine that counts in-band samples, tolerates short excursions and
merges nearby segments.  Kernel A (csrc/segment.cu, segment_cuda.py)
runs a block a read, its serial sums composed chunk by chunk and its run
machine scanned chunk by chunk; the plain version repeats the C's
arithmetic sample by sample.

Parameters below are the port's own copies of the segmenter's
(honours_tpu/segment/__init__.py).  The stall codecs' threshold and
margin are utils/config.py's.
"""

from __future__ import annotations

import torch

CLAMP_MIN = 0.0
CLAMP_MAX = 1200.0
STD_SCALE = 0.75
CORRECTOR = 50
SEG_DIST = 50
WINDOW = 150
STALL_LEN = 0.25
ERROR = 5


def find_stall_batch(sig, n):
    """[B, L] int16 signals (first n valid) -> (exists [B] bool, start
    [B] int32, length [B] int32) of the first stall segment per read;
    start and length are 0 where there is none.  Equal to
    native.find_stall per read, except that start and length are not
    truncated to uint16."""
    from honours_tpu_torch.segment import segment_cuda

    return segment_cuda.find_stall(sig.contiguous(),
                                   n.to(torch.int32).contiguous())
