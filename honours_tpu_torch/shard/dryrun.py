"""Multi-rank dry run of the port's data parallelism (shard/mesh.py).

    python -m honours_tpu_torch.shard.dryrun --world 4 --backend gloo \\
        [--device cuda|cpu] [--B 256] [--L 65536] [--stall 30000] \\
        [--seed 0]

The counterpart of honours_tpu's `__graft_entry__.dryrun_multichip`.
Outside torchrun it spawns --world ranks of itself (torchrun's
environment, a free localhost port) and waits for them; a rank that
fails ends the world (the others are killed) and the run, with that
rank's output.  Under torchrun it runs as the rank it is given.  The
backend is the caller's: NCCL takes a card a rank and refuses more
ranks than cards; gloo lets several ranks share one card (every tensor
of the data stays on the card, gloo stages the reduced ones through the
host).  The default device is the card.

Every rank builds the same seeded batch (synth.synthesize_bucket: B
reads of lengths in (L/2, L], padded to a multiple of the world) and
the stall set (synth.stall_set: 16 reads of a --stall-sample stall),
takes its block of rows, and runs:
  srans2        sharded encode, its body free of collectives; the
                ordered gather in windows of fewer rows than a shard;
                sharded decode;
  drans         the shared-fit sharded encode (one collective, and the
                metrics' one) and the two-phase sharded decode (two);
  dstall_drans  the min-pick encode and the three member-masked
                decodes, over the bucket and over the stall set, whose
                rows are reordered, if need be, so that some rank holds
                a split row and some rank none.
Each rank's streams must equal, row for row, those of the unsharded
engine over the whole batch on the same device, and every row must
decode bit for bit.  Rank 0 checks that the gathered rows are every row
once, in order, and that the reduced metrics equal the sums over the
gathered lengths and n.  Each rank prints one line
`dryrun rank {json}`: its wall over the sharded calls, its collectives
a call, the bytes of each, its kernel launches and its split rows;
rank 0 then one summary line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from honours_tpu_torch.shard.mesh import (
    DEFAULT_TIMEOUT_S,
    all_gather_rows,
    assert_no_collectives,
    init_distributed,
    iter_ordered_payloads,
    make_mesh,
    pad_rows_to_devices,
    profile_collectives,
    shard_batch,
    sharded_encode,
)

REPORT = "dryrun rank "
#: collectives of each sharded call: sharded_encode's metrics all_reduce,
#: and drans's fit (encode), and its fit and G check (decode)
COLLECTIVES = {"srans2 encode+metrics": 1, "srans2 decode": 0,
               "drans encode+metrics": 2, "drans decode": 2}


def spawn_world(cmd: list[str], world: int, timeout_s: float) -> list[str]:
    """Run `cmd` as `world` ranks with torchrun's environment (a free
    localhost port) and return each rank's output.  A rank that exits
    non-zero, or a world past `timeout_s`, kills every rank still
    running and raises RuntimeError with that rank's output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                PYTHONPATH=os.pathsep.join([root] + ([path] if path else [])))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs, failed = [], None
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                cmd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=logs[r], stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"rank {bad[0]} exited with "
                          f"{codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = (0, f"the world of {world} ran past {timeout_s} s")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None:
        r, why = failed
        raise RuntimeError(f"{why}; its ranks were ended. Rank {r}'s "
                           f"output:\n{outs[r][-6000:]}")
    return outs


def reports(outs: list[str]) -> list[dict]:
    """Each rank's `dryrun rank` report from spawn_world's outputs."""
    found = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith(REPORT)]
        if len(lines) != 1:
            raise RuntimeError(f"a rank printed {len(lines)} reports:\n"
                               f"{out[-3000:]}")
        found.append(json.loads(lines[0][len(REPORT):]))
    return found


def launch(world: int, backend: str, device: str = "cuda", B: int = 256,
           L: int = 1 << 16, stall: int = 30000, seed: int = 0,
           pg_timeout_s: float = DEFAULT_TIMEOUT_S,
           timeout_s: float = 900) -> tuple[list[str], list[dict]]:
    """Build the kernels once (for the card), then run the dry run as a
    world of `world` ranks; returns their outputs and reports."""
    if torch.device(device).type == "cuda":
        from honours_tpu_torch import _build

        _build.build()
    cmd = [sys.executable, "-m", "honours_tpu_torch.shard.dryrun",
           "--world", str(world), "--backend", backend, "--device", device,
           "--B", str(B), "--L", str(L), "--stall", str(stall),
           "--seed", str(seed),
           "--pg-timeout", str(pg_timeout_s)]
    outs = spawn_world(cmd, world, timeout_s)
    return outs, reports(outs)


def _rows(reads, L: int):
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    return sig, np.array([r.size for r in reads], np.int32)


def _row_bytes(st, sl, r0: int, r1: int) -> list[bytes]:
    st, sl = st[r0:r1].cpu().numpy(), sl[r0:r1].cpu().numpy()
    return [st[i, : sl[i]].tobytes() for i in range(r1 - r0)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Rank:
    """One rank's sharded calls, with the collectives each issued where
    they are counted."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.calls = {}
        self.labels = collections.Counter()

    def call(self, name: str, counted: bool, fn, *args):
        if not counted:
            return fn(*args)
        out, ops, labels = profile_collectives(fn, *args)
        self.calls[name] = len(ops)
        self.labels.update(labels)
        return out

    def codec(self, name, encode, decode, sig, n, L, window, want,
              counted=True):
        """Sharded encode, ordered gather and decode of one batch; every
        row must equal `want` (the unsharded engine's rows of this
        rank) and decode to its samples.  Returns (gathered rows, comp,
        raw)."""
        mesh = self.mesh
        stream, lens, comp, raw = self.call(f"{name} encode+metrics",
                                            counted, sharded_encode, mesh,
                                            encode, sig, n)
        rows = self.call(f"{name} gather", counted, lambda: list(
            iter_ordered_payloads(mesh, stream, lens, window)))
        r0, r1 = mesh.rows(sig.shape[0])
        if [g for g, _ in rows] != list(range(r0, r1)):
            raise AssertionError(f"{name}: rank {mesh.rank} yielded rows "
                                 f"{[g for g, _ in rows]}, not {r0}..{r1}")
        for (g, blob), ref in zip(rows, want):
            if blob != ref:
                raise AssertionError(f"{name}: row {g} differs from the "
                                     "unsharded engine's stream")
        sig_s, n_s = shard_batch(mesh, sig, n)
        out = self.call(f"{name} decode", counted, decode, stream, n_s)
        if not torch.equal(out, sig_s):
            bad = torch.nonzero((out != sig_s).any(dim=1)).flatten() + r0
            raise AssertionError(f"{name}: rows {bad[:8].tolist()} did not "
                                 "decode bit for bit")
        return rows, comp, raw


def _stall_layout(sig, n, world: int, reference):
    """The stall set's rows, reordered so that, where the seed's order
    does not give it, some rank holds a split row and some rank none:
    the split rows first (stable).  Returns (sig, n, unsharded streams,
    split flags, reordered)."""
    st, sl = reference(sig, n)
    flags = st[:, 0].cpu().numpy() == 1
    per_rank = flags.reshape(world, -1).sum(axis=1)
    if world == 1 or (per_rank.min() == 0 and per_rank.max() > 0):
        return sig, n, (st, sl), flags, False
    order = np.argsort(~flags, kind="stable")
    sig, n = sig[order], n[order]
    st, sl = reference(sig, n)
    return sig, n, (st, sl), st[:, 0].cpu().numpy() == 1, True


def run_rank(args) -> dict:
    """This rank's part of the dry run; returns its report."""
    from honours_tpu_torch._build import KERNELS
    from honours_tpu_torch.engine.drans import (
        depress_drans_batch,
        press_drans_batch,
    )
    from honours_tpu_torch.engine.dstall_drans import (
        depress_dstall_drans_batch,
        press_dstall_drans_batch,
    )
    from honours_tpu_torch.engine.pipeline import (
        canned_o1_device_tables,
        depress_srans2_batch,
        press_srans2_batch,
    )
    from honours_tpu_torch.synth import stall_set, synthesize_bucket

    mesh = make_mesh(device=args.device)
    W, dev, g = mesh.world, mesh.device, mesh.group
    if dev.type == "cpu":
        # the ranks share the host's cores, and the plain versions' small
        # ops gain nothing from intra-op threads
        torch.set_num_threads(1)
    tabs = canned_o1_device_tables(dev)
    sig, n = pad_rows_to_devices(*synthesize_bucket(args.B, args.L,
                                                    args.seed), W)
    B, L = sig.shape
    r0, r1 = mesh.rows(B)
    window = max(1, (r1 - r0) // 3)

    def to_dev(s, nn):
        return torch.from_numpy(s).to(dev), torch.from_numpy(nn).to(dev)

    def dstall_ref(s, nn):
        return press_dstall_drans_batch(*to_dev(s, nn), tabs)

    # the unsharded engines over the whole batch, this rank's rows
    whole = to_dev(sig, n)
    want = {
        "srans2": _row_bytes(*press_srans2_batch(*whole, tabs), r0, r1),
        "drans": _row_bytes(*press_drans_batch(*whole, tabs), r0, r1),
        "dstall_drans": _row_bytes(*press_dstall_drans_batch(*whole, tabs),
                                   r0, r1),
    }
    stalls = stall_set(args.seed, args.stall)
    ssig, sn = pad_rows_to_devices(*_rows(stalls, stalls[0].size), W)
    ssig, sn, sref, sflags, reordered = _stall_layout(ssig, sn, W,
                                                      dstall_ref)
    s0, s1 = mesh.rows(ssig.shape[0])
    want["dstall_drans stall set"] = _row_bytes(*sref, s0, s1)
    del whole, sref

    rank = _Rank(mesh)
    for k in KERNELS.values():
        k.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    srans2 = (lambda s, nn: press_srans2_batch(s, nn, tabs),
              lambda st, nn: depress_srans2_batch(st, nn, tabs, L))
    rows, comp, raw = rank.codec("srans2", *srans2, sig, n, L, window,
                                 want["srans2"])
    assert_no_collectives(srans2[0], *shard_batch(mesh, sig, n))
    drans = (lambda s, nn: press_drans_batch(s, nn, tabs, group=g),
             lambda st, nn: depress_drans_batch(st, nn, tabs, L, group=g))
    rows_d, comp_d, raw_d = rank.codec("drans", *drans, sig, n, L, window,
                                       want["drans"])

    # the profiler multiplies the time of the plain versions' step loops
    # on the CPU (tests/test_torch_shard.py counts dstall_drans's there)
    counted = dev.type == "cuda"

    def dstall_encode(s, nn):
        return press_dstall_drans_batch(s, nn, tabs, group=g)

    def dstall_decode(Lx):
        return lambda st, nn: depress_dstall_drans_batch(st, nn, tabs, Lx,
                                                         group=g)

    rows_s, _, _ = rank.codec("dstall_drans", dstall_encode,
                              dstall_decode(L), sig, n, L, window,
                              want["dstall_drans"], counted=counted)
    rows_t, comp_t, raw_t = rank.codec(
        "dstall_drans stall set", dstall_encode,
        dstall_decode(ssig.shape[1]), ssig, sn, ssig.shape[1],
        max(1, (s1 - s0) // 3), want["dstall_drans stall set"],
        counted=counted)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}

    for name, want_n in COLLECTIVES.items():
        if g is not None and rank.calls[name] != want_n:
            raise AssertionError(f"{name} issued {rank.calls[name]} "
                                 f"collectives, not {want_n}")
    # rank 0's checks of the gather and the metrics, over every rank
    lens = all_gather_rows(mesh, torch.tensor([len(b) for _, b in rows],
                                              device=dev))
    got = all_gather_rows(mesh, torch.tensor([r for r, _ in rows],
                                             device=dev))
    split = all_gather_rows(mesh, torch.tensor(
        [sum(b[0] == 1 for _, b in rows_t)], device=dev))
    if mesh.rank == 0:
        if got.tolist() != list(range(B)):
            raise AssertionError(f"the gathered rows are {got.tolist()}")
        if (comp, raw) != (int(lens.sum()), 2 * int(n.sum())):
            raise AssertionError(f"metrics {comp}, {raw} vs the gathered "
                                 f"{int(lens.sum())}, {2 * int(n.sum())}")
        if (split != sflags.reshape(W, -1).sum(axis=1)).any():
            raise AssertionError(f"split rows by rank {split.tolist()}")
        if W > 1 and not (split.min() == 0 and split.max() > 0):
            raise AssertionError("the stall set gives no rank without a "
                                 f"split row and one with: {split}")
    return {
        "rank": mesh.rank, "world": W, "backend": args.backend,
        "device": str(dev), "cards": (torch.cuda.device_count()
                                      if dev.type == "cuda" else 0),
        "rows": [r0, r1], "wall_s": wall, "collectives": rank.calls,
        "collective_bytes": dict(rank.labels), "launches": launches,
        "split_rows": {"bucket": sum(b[0] == 1 for _, b in rows_s),
                       "stall set": sum(b[0] == 1 for _, b in rows_t)},
        "split_rows_by_rank": split.tolist(), "reordered": reordered,
        "summary": (
            f"dryrun ok: {W} ranks over {args.backend} on {dev}, {B} reads "
            f"[{B}, {L}], {raw} -> {comp} bytes (ratio {raw / comp:.3f}), "
            f"ordered gather {B} rows in windows of {window}, srans2 "
            "encode body collective-free; drans shared-fit encode + "
            f"2-phase decode sharded ({raw_d} -> {comp_d}); dstall_drans "
            f"min-pick sharded over the bucket and the stall set ({raw_t} "
            f"-> {comp_t}, split rows by rank {split.tolist()}"
            + (", rows reordered" if reordered else "") + ") — every row "
            "equal to the unsharded engine's and back bit for bit"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--L", type=int, default=1 << 16)
    ap.add_argument("--stall", type=int, default=30000,
                    help="the stall set's stall length (its walk is twice "
                    "as long)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pg-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a collective may wait for the others")
    args = ap.parse_args(argv)
    if "RANK" not in os.environ:
        outs, reps = launch(args.world, args.backend, args.device, args.B,
                            args.L, args.stall, args.seed, args.pg_timeout)
        for rep in reps:
            print(REPORT + json.dumps(rep), flush=True)
        print(reps[0]["summary"], flush=True)
        return 0
    if not init_distributed(args.backend, args.device, args.pg_timeout):
        raise RuntimeError("torchrun's environment is incomplete")
    if dist.get_world_size() != args.world:
        raise RuntimeError(f"--world {args.world}, but the world has "
                           f"{dist.get_world_size()} ranks")
    report = run_rank(args)
    print(REPORT + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
