"""Data-parallel sharding of read batches over torch.distributed ranks.

The counterpart of honours_tpu/shard/mesh.py in PyTorch's idiom: one
process a rank, and an explicit device and process group everywhere.
Reads shard over the ranks by contiguous blocks of rows (rank r of W
holds rows [r*B/W, (r+1)*B/W)); every rank builds its own copy of the
codec tables; byte metrics reduce with one all_reduce; per-read
payloads come back in global row order, lengths first, then bounded
windows of each rank's stream.

The backend is always the caller's choice.  On one card, several ranks
share it over gloo, which stages the few small reduced tensors through
the host while every tensor of the data stays on the card; NCCL takes
one card a rank.  The drans engines take `mesh.group` to reduce their
shared fit (engine/drans.py, engine/dstall_drans.py) through
`all_reduce` and `any_across` below.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from honours_tpu_torch.device import resolve_device

#: the process group's timeout: a collective that a rank never joins
#: fails after this long instead of hanging
DEFAULT_TIMEOUT_S = 300
#: profiler label of every collective this module issues
LABEL = "htt.collective"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def init_distributed(backend: str, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that torchrun's environment describes
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK); a no-op
    that returns False without it.

    `backend` is "gloo" or "nccl", never chosen here.  NCCL takes one
    card a rank: more local ranks than cards raise RuntimeError.  For a
    CUDA device the rank's card (LOCAL_RANK modulo the card count)
    becomes the current one."""
    if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                         "RANK", "WORLD_SIZE")):
        return False
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    dev = resolve_device(device)
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if local > cards:
            raise RuntimeError(
                f"nccl needs a card a rank: {local} local ranks, {cards} "
                "cards (gloo shares one card among ranks)")
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_card(dev))
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _rank_card(dev: torch.device) -> torch.device:
    if dev.index is not None:
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D `reads` mesh seen from one rank.  `group` is None for a
    world of one without torch.distributed (no collective is issued)."""

    group: object
    rank: int
    world: int
    device: torch.device

    def rows(self, B: int) -> tuple[int, int]:
        """This rank's block [r0, r1) of a batch of B rows."""
        if B % self.world:
            raise ValueError(f"{B} rows do not split over {self.world} "
                             "ranks: pad with pad_rows_to_devices")
        b = B // self.world
        return self.rank * b, (self.rank + 1) * b


def make_mesh(group=None, device="cuda") -> Mesh:
    """The mesh of `group` (the default group when torch.distributed is
    initialized, else a world of one) on the rank's device: for "cuda",
    the card LOCAL_RANK modulo the card count."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = _rank_card(dev)
    if not dist.is_initialized():
        if group is not None:
            raise RuntimeError("a group needs torch.distributed initialized")
        return Mesh(None, 0, 1, dev)
    group = group if group is not None else dist.group.WORLD
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def shard_batch(mesh: Mesh, sig, n):
    """This rank's block of rows of sig [B, L] and n [B] (numpy arrays or
    tensors), on the rank's device."""
    r0, r1 = mesh.rows(sig.shape[0])
    return (torch.as_tensor(sig[r0:r1]).to(mesh.device),
            torch.as_tensor(n[r0:r1]).to(mesh.device))


def pad_rows_to_devices(sig: np.ndarray, n: np.ndarray, n_devices: int):
    """Pad the batch dim to a multiple of the mesh size (pad rows n=0)."""
    B = sig.shape[0]
    Bp = -(-B // n_devices) * n_devices
    if Bp != B:
        sig = np.concatenate(
            [sig, np.zeros((Bp - B, sig.shape[1]), sig.dtype)], axis=0
        )
        n = np.concatenate([n, np.zeros(Bp - B, n.dtype)])
    return sig, n


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce `t` in place over `group` ("sum" or "max") and return it;
    with no group, return it as it is.  Integer tensors only: bool
    tensors do not reduce on every backend."""
    if group is None:
        return t
    if t.is_floating_point() or t.dtype == torch.bool:
        raise TypeError(f"all_reduce takes integer tensors, not {t.dtype}")
    nbytes = t.numel() * t.element_size()
    with torch.profiler.record_function(f"{LABEL} all_reduce {op} {nbytes}"):
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def any_across(flags, group) -> list[bool]:
    """Host decisions that every rank of `group` takes alike: each flag (a
    0-d tensor) true where it is true on some rank.  One MAX all_reduce
    of int64 flags, and one host sync."""
    t = torch.stack([torch.as_tensor(f).to(torch.int64) for f in flags])
    return [bool(v) for v in all_reduce(t, group, "max").tolist()]


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> np.ndarray:
    """Every rank's equal-sized block of rows of `t`, in rank order, as
    one host array on every rank."""
    if mesh.group is None:
        return t.cpu().numpy()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    nbytes = t.numel() * t.element_size()
    with torch.profiler.record_function(f"{LABEL} all_gather {nbytes}"):
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def _metrics_psum(mesh: Mesh, out_len, n) -> tuple[int, int]:
    """(compressed bytes, raw int16 bytes) summed over the mesh."""
    t = torch.stack([out_len.to(torch.int64).sum(),
                     n.to(torch.int64).sum() * 2])
    comp, raw = all_reduce(t, mesh.group).tolist()
    return comp, raw


def _replicate(t, device):
    if isinstance(t, dict):
        return {k: _replicate(v, device) for k, v in t.items()}
    return torch.as_tensor(t).to(device)


def sharded_encode(mesh: Mesh, encode_fn, sig, n, *tables):
    """Run a batched encode over the mesh.

    encode_fn(sig, n, *tables) -> (stream, out_len) runs on this rank's
    block of rows, with the tables (tensors or dicts of them) on the
    rank's device.  Returns (stream, out_len, comp_bytes, raw_bytes),
    stream and out_len still the rank's shard; use gather_lengths /
    iter_ordered_payloads for the ragged ordered gather."""
    sig_s, n_s = shard_batch(mesh, sig, n)
    reps = [_replicate(t, mesh.device) for t in tables]
    stream, out_len = encode_fn(sig_s, n_s, *reps)
    comp, raw = _metrics_psum(mesh, out_len, n_s)
    return stream, out_len, comp, raw


def profile_collectives(fn, *args):
    """fn(*args) under torch.profiler -> (its result, the names of the
    collectives it issued, c10d's own op names such as
    "c10d::allreduce_", and the labels of this module's collectives,
    which carry the bytes each moved)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    # the raw events: building the profiler's event tree costs seconds
    # for the plain versions' step loops on the CPU
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return (out, [m for m in names if m.startswith("c10d::")],
            [m[len(LABEL) + 1:] for m in names if m.startswith(LABEL)])


def assert_no_collectives(fn, *args):
    """Run fn(*args) and assert that it issued no collective: the reads
    axis is embarrassingly parallel, and any collective in an encode
    body means a sharding regression.  Returns fn's result."""
    out, ops, _ = profile_collectives(fn, *args)
    assert not ops, f"encode body issued collectives: {ops}"
    return out


def gather_lengths(mesh: Mesh, out_len) -> np.ndarray:
    """Global [B] compressed lengths on every rank (phase 1 of the
    ragged ordered gather: lengths travel first)."""
    return all_gather_rows(mesh, out_len.to(torch.int64))


def iter_ordered_payloads(mesh: Mesh, stream, out_len,
                          window_rows: int = 64):
    """Phase 2: (global_row, payload_bytes) for this rank's rows, in
    global row order, copying at most `window_rows` rows of its stream
    (up to their longest payload) to the host a transfer: the shard is
    never on the host whole.  The lengths gather now, so every rank
    must call this; the payloads come as the result is iterated.  A
    world of one yields every row."""
    lens = gather_lengths(mesh, out_len)
    r0, r1 = mesh.rows(lens.size)

    def rows():
        for j0 in range(0, r1 - r0, window_rows):
            j1 = min(j0 + window_rows, r1 - r0)
            width = int(lens[r0 + j0: r0 + j1].max(initial=0))
            window = stream[j0:j1, :width].cpu().numpy()
            for j in range(j1 - j0):
                g = r0 + j0 + j
                yield g, window[j, : lens[g]].tobytes()

    return rows()
