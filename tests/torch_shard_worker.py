"""A rank of the port's sharded codec checks (tests/test_torch_shard.py,
and the 2-rank world of tests/test_torch_gpu.py).

    python tests/torch_shard_worker.py --inputs IN.npz --out DIR \\
        --backend gloo --device cpu [--pg-timeout 60] [--fail-rank R]

Run as every rank of a world by `run_world` (shard.dryrun.spawn_world:
torchrun's environment).  Each rank takes its block of rows of each
batch in IN.npz and runs the sharded encode, the ordered gather and the
sharded decode of srans, srans2, drans and dstall_drans, then a drans
decode of its streams with the G header of the last rank's first row
altered.  It writes DIR/rank{r}.npz (each case's gathered rows,
payloads and decoded rows) and DIR/rank{r}.json (reduced metrics,
collectives a call, the split flags, each rank's ValueError); the test
process holds them against the JAX package, the host codecs and the
port's unsharded engines.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CASES = ("srans", "srans2", "drans", "dstall_drans")
WINDOW = {"srans": 64, "srans2": 3, "drans": 2, "dstall_drans": 2}


def run_world(batches: dict, world: int, tmp: Path, backend: str = "gloo",
              device: str = "cpu", fail_rank: int = None,
              timeout_s: float = 180, pg_timeout_s: float = 60):
    """Run this worker as a world of `world` ranks on `batches` ({case:
    (sig [B, L] int16, n [B])} for each of CASES); returns each rank's
    (arrays, json) results."""
    from honours_tpu_torch.shard.dryrun import spawn_world

    if device == "cuda":  # once, before the ranks start
        from honours_tpu_torch import _build

        _build.build()
    tmp.mkdir(parents=True, exist_ok=True)
    inputs = {}
    for case, (sig, n) in batches.items():
        inputs[f"{case}_sig"], inputs[f"{case}_n"] = sig, n
    np.savez(tmp / "inputs.npz", **inputs)
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--inputs", str(tmp / "inputs.npz"), "--out", str(tmp),
           "--backend", backend, "--device", device,
           "--pg-timeout", str(pg_timeout_s)]
    if fail_rank is not None:
        cmd += ["--fail-rank", str(fail_rank)]
    spawn_world(cmd, world, timeout_s)
    return [(dict(np.load(tmp / f"rank{r}.npz")),
             json.loads((tmp / f"rank{r}.json").read_text()))
            for r in range(world)]


def srans_batch():
    """tests/test_shard.py::test_sharded_encode_matches_single_device's."""
    rng = np.random.default_rng(5)
    sig = rng.integers(300, 900, (16, 512)).astype(np.int16)
    n = np.full((16,), 512, np.int32)
    n[3] = 100
    return sig, n


def srans2_batch():
    """tests/test_shard.py::test_ordered_ragged_gather's."""
    rng = np.random.default_rng(4)
    sig = rng.integers(400, 700, (16, 256)).astype(np.int16)
    n = rng.integers(1, 257, 16).astype(np.int32)
    return sig, n


def drans_batch():
    """14 random-walk reads of up to 1024 samples (zero past n)."""
    rng = np.random.default_rng(9)
    sig = np.cumsum(rng.integers(-40, 41, (14, 1024)), axis=1)
    sig = sig.clip(-2000, 2000).astype(np.int16)
    n = rng.integers(1, 1025, 14).astype(np.int32)
    n[:2] = 1024, 1
    sig[np.arange(1024)[None, :] >= n[:, None]] = 0
    return sig, n


def rows(reads, L: int):
    """Reads padded to [B, L] int16, and their lengths."""
    sig = np.zeros((len(reads), L), np.int16)
    for i, r in enumerate(reads):
        sig[i, : r.size] = r
    return sig, np.array([r.size for r in reads], np.int32)


def gathered(results, case: str) -> tuple[list[int], list[bytes]]:
    """(global rows, payloads) of one case over every rank, rank order."""
    rows, blobs = [], []
    for arrays, _ in results:
        lens = arrays[f"{case}_lens"]
        blob = arrays[f"{case}_blob"].tobytes()
        offs = np.concatenate([[0], np.cumsum(lens)])
        rows += arrays[f"{case}_rows"].tolist()
        blobs += [blob[offs[i]: offs[i + 1]] for i in range(lens.size)]
    return rows, blobs


def decoded(results, case: str) -> np.ndarray:
    """Every rank's decoded rows of one case, as one [B, L] array."""
    return np.concatenate([arrays[f"{case}_out"] for arrays, _ in results])


def _rank(args) -> None:
    import torch

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
        canned_rans_tables,
        depress_srans2_batch,
        depress_srans_batch,
        press_srans2_batch,
        press_srans_batch,
    )
    from honours_tpu_torch.shard import mesh as M

    if not M.init_distributed(args.backend, args.device, args.pg_timeout):
        raise RuntimeError("no torchrun environment")
    mesh = M.make_mesh(device=args.device)
    if mesh.rank == args.fail_rank:
        raise RuntimeError(f"rank {mesh.rank} fails on purpose")
    if mesh.device.type == "cpu":  # as shard/dryrun.py's ranks
        torch.set_num_threads(1)
    g = mesh.group
    o0 = canned_rans_tables(mesh.device)
    o1 = canned_o1_device_tables(mesh.device)
    coders = {
        "srans": (lambda s, n, t: press_srans_batch(s, n, t),
                  lambda st, n, L: depress_srans_batch(st, n, o0, L), o0),
        "srans2": (lambda s, n, t: press_srans2_batch(s, n, t),
                   lambda st, n, L: depress_srans2_batch(st, n, o1, L), o1),
        "drans": (lambda s, n, t: press_drans_batch(s, n, t, group=g),
                  lambda st, n, L: depress_drans_batch(st, n, o1, L,
                                                       group=g), o1),
        "dstall_drans": (
            lambda s, n, t: press_dstall_drans_batch(s, n, t, group=g),
            lambda st, n, L: depress_dstall_drans_batch(st, n, o1, L,
                                                        group=g), o1),
    }
    inputs = np.load(args.inputs)
    arrays, info = {}, {"rank": mesh.rank, "world": mesh.world,
                        "collectives": {}}

    def counted(name, fn, *a):
        out, ops, _ = M.profile_collectives(fn, *a)
        info["collectives"][name] = len(ops)
        return out

    streams = {}
    T0 = time.perf_counter(); info["t"] = {}
    for case in CASES:
        info["t"][case] = time.perf_counter() - T0
        encode, decode, tabs = coders[case]
        sig, n = M.pad_rows_to_devices(inputs[f"{case}_sig"],
                                       inputs[f"{case}_n"], mesh.world)
        stream, lens, comp, raw = counted(f"{case} encode+metrics",
                                          M.sharded_encode, mesh, encode,
                                          sig, n, tabs)
        rows = list(M.iter_ordered_payloads(mesh, stream, lens,
                                            WINDOW[case]))
        sig_s, n_s = M.shard_batch(mesh, sig, n)
        out = counted(f"{case} decode", decode, stream, n_s, sig.shape[1])
        arrays[f"{case}_rows"] = np.array([r for r, _ in rows], np.int64)
        arrays[f"{case}_lens"] = np.array([len(b) for _, b in rows],
                                          np.int64)
        arrays[f"{case}_blob"] = np.frombuffer(
            b"".join(b for _, b in rows), np.uint8)
        arrays[f"{case}_out"] = out.cpu().numpy()
        info[f"{case}_metrics"] = [comp, raw]
        streams[case] = (stream, n_s, sig.shape[1])
        if case == "srans2":
            M.assert_no_collectives(encode, sig_s, n_s, tabs)
            info["srans2_encode_body_collective_free"] = True
        if case == "drans":
            counted("drans encode", encode, sig_s, n_s, tabs)
        if case == "dstall_drans":
            info["split_rows"] = [b[0] == 1 for _, b in rows]

    # a G header altered in the first row of the last rank: every rank
    # must raise, together
    stream, n_s, L = streams["drans"]
    bad = stream.clone()
    if mesh.rank == mesh.world - 1:
        bad[0, 0] ^= 1
    t0 = time.perf_counter()
    try:
        depress_drans_batch(bad, n_s, o1, L, group=g)
        info["g_mismatch"] = None
    except ValueError as e:
        info["g_mismatch"] = str(e)
    info["g_mismatch_s"] = time.perf_counter() - t0

    out = Path(args.out)
    np.savez(out / f"rank{mesh.rank}.npz", **arrays)
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(info))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--pg-timeout", type=float, default=60)
    ap.add_argument("--fail-rank", type=int, default=None)
    _rank(ap.parse_args())
