"""Kernel F's division (csrc/rccdf.cu symbol_entry and encode_step),
checked on the CPU: a numpy model of its per-symbol reciprocal (ryg's
rcp_freq with s = ceil(log2 f), the shift s - 1, and x itself through a
mask for f = 1) gives x // f for every f in [1, 4096] at x = 0, at the
largest state the encode divides (f << 19) - 1, at multiples k f and k f
- 1 near the ends and the middle of that range and at seeded random x,
and the step's multiply-add gives the state of the plain version
(engine/rccdf.py rccdf_encode_plain).  No JAX."""

import numpy as np

from honours_tpu_torch.engine import rans_encode_cuda as E
from honours_tpu_torch.engine.rccdf import RENORM_SHIFT
from honours_tpu_torch.kernels.rans import M, PROB_BITS
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

F = np.arange(1, M + 1, dtype=np.uint64)[:, None]


def symbol_entries(f):
    """symbol_entry's (reciprocal, shift, mask) of f (uint64 in [1, M])."""
    s = np.array([(int(v) - 1).bit_length() for v in f.ravel()],
                 np.uint64).reshape(f.shape)
    rcp = np.where(f < 2, 0, ((np.uint64(1) << (np.uint64(31) + s)) + f
                              - np.uint64(1)) // f)
    shift = (s.astype(np.int64) - 1) & 31
    mask = np.where(f == 1, np.uint64(0xFFFFFFFF), np.uint64(0))
    return rcp.astype(np.uint64), shift.astype(np.uint64), mask


def quotient(x, f):
    """encode_step's q: (umulhi(x, rcp) >> shift) | (x & mask)."""
    rcp, shift, mask = symbol_entries(f)
    return (((x * rcp) >> np.uint64(32)) >> shift) | (x & mask)


def _states(seed: int):
    """[M, X] states below f << 19 for each f: 0, 1, the largest, k f and
    k f - 1 for k near 1, near 2^18 and near 2^19, and seeded random
    ones."""
    top = F << np.uint64(RENORM_SHIFT)
    k = np.array([1, 2, 3, (1 << 18) - 1, 1 << 18, (1 << 18) + 1,
                  (1 << 19) - 2, (1 << 19) - 1], np.uint64)[None, :]
    rng = np.random.default_rng(seed)
    rand = (rng.random((M, 64)) * top).astype(np.uint64)
    x = np.concatenate([np.zeros_like(F), np.ones_like(F), top - 1, k * F,
                        k * F - np.uint64(1), rand], axis=1)
    return np.minimum(x, top - np.uint64(1))


def test_reciprocal_division_is_exact_for_every_f():
    x = _states(0)
    f = np.broadcast_to(F, x.shape)
    assert (x < np.uint64(1 << 31)).all()
    assert np.array_equal(quotient(x, f), x // f)


def test_reciprocals_are_kernel_3s():
    """The same table as kernel 3's (rans_encode_cuda.reciprocals)."""
    rcp, _, _ = symbol_entries(F)
    assert np.array_equal(rcp[:, 0], E.reciprocals()[1: M + 1])


def test_step_gives_the_plain_state():
    """x + q (4096 - f) + c = (x // f << 12) + x % f + c for a valid
    table (f + c <= 4096), and stays below 2^31; the idle entry (f =
    4096, c = 0) leaves x as it is."""
    x = _states(1)
    f = np.broadcast_to(F, x.shape)
    rng = np.random.default_rng(2)
    c = (rng.random(x.shape) * (np.uint64(M) - f + np.uint64(1))).astype(
        np.uint64)
    got = x + quotient(x, f) * (np.uint64(M) - f) + c
    want = ((x // f) << np.uint64(PROB_BITS)) + x % f + c
    assert np.array_equal(got, want) and (got < np.uint64(1 << 31)).all()
    idle = np.full_like(x, M)
    assert np.array_equal(x + quotient(x, idle) * np.uint64(0), x)
