"""The port's data parallelism (honours_tpu_torch/shard/) on the CPU over
gloo, in worlds of 4 ranks and of 1 (tests/torch_shard_worker.py, one
world of each a module), held against the JAX package's sharded_encode
on its 8-device CPU mesh (at tests/test_shard.py's shapes only), the
host codecs and the port's unsharded engines over the whole batch, pad
rows included.  Streams, lengths, metrics and samples must be equal
(tolerance 0).  No JAX dstall engine is compiled."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import honours_tpu.codecs.dstall_drans as dd
from honours_tpu.codecs.base import get as get_codec
from honours_tpu.codecs.drans import drans_press_reads
from honours_tpu.engine import pipeline as jpipe
from honours_tpu.shard import mesh as jmesh
from honours_tpu_torch.engine import drans as TD
from honours_tpu_torch.engine import dstall_drans as TDD
from honours_tpu_torch.engine import pipeline as tpipe
from honours_tpu_torch.shard import mesh as M
from honours_tpu_torch.shard.dryrun import spawn_world
from test_torch_dstall import mixed  # noqa: F401  (fixture)
import torch_shard_worker as worker
from torch_shard_worker import ROOT, decoded, gathered, run_world
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

O1 = tpipe.canned_o1_device_tables("cpu")
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def batches(mixed):
    """Each case's batch; dstall_drans's is tests/test_torch_dstall.py's
    mixed reads, whose two split rows (3 and 4) fall on rank 1 of 4
    (3 rows a rank once padded to 12), so ranks 0, 2 and 3 hold none."""
    return {"srans": worker.srans_batch(),
            "srans2": worker.srans2_batch(),
            "drans": worker.drans_batch(),
            "dstall_drans": worker.rows(mixed, 4096)}


@pytest.fixture(scope="module")
def runs(batches, tmp_path_factory):
    """This module's three worlds side by side (each waited on by a
    thread): the worker as 4 ranks and as 1, and
    `python -m honours_tpu_torch.shard.dryrun` at a small size (2 ranks,
    a stall set whose one split row, 12, lies on rank 1)."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    dryrun = [sys.executable, "-m", "honours_tpu_torch.shard.dryrun",
              "--world", "2", "--backend", "gloo", "--device", "cpu", "--B",
              "4", "--L", "1024", "--stall", "6000", "--pg-timeout", "60"]
    with ThreadPoolExecutor(3) as ex:
        runs = {W: ex.submit(run_world, batches, W,
                             tmp_path_factory.mktemp(f"world{W}"))
                for W in (4, 1)}
        runs["dryrun"] = ex.submit(subprocess.run, dryrun, cwd=ROOT, env=env,
                                   capture_output=True, text=True,
                                   timeout=180)
        return {k: f.result() for k, f in runs.items()}


@pytest.fixture(scope="module", params=[4, 1], ids=["world4", "world1"])
def world(request, runs):
    return request.param, runs[request.param]


def _padded(batches, case, W):
    return M.pad_rows_to_devices(*batches[case], W)


def _unsharded(press, sig, n, *tabs):
    st, sl = press(torch.from_numpy(sig), torch.from_numpy(n), *tabs)
    return [st[i, : int(sl[i])].numpy().tobytes() for i in range(len(sl))]


def _jax_sharded(encode, sig, n, *tables):
    stream, out_len, comp, raw = jmesh.sharded_encode(
        jmesh.make_mesh(), encode, sig, n, *tables)
    st, sl = np.asarray(stream), np.asarray(out_len)
    return [st[i, : sl[i]].tobytes() for i in range(len(sl))], comp, raw


@pytest.fixture(scope="module")
def jax_srans(batches):
    freqs, cum = jpipe.canned_rans_tables()
    return _jax_sharded(
        lambda s, nn, f, c: jpipe.press_srans_batch(s, nn, f, c),
        *batches["srans"], freqs, cum)


@pytest.fixture(scope="module")
def jax_srans2(batches):
    tabs = jpipe.canned_o1_device_tables()
    return _jax_sharded(lambda s, nn: jpipe.press_srans2_batch(s, nn, tabs),
                        *batches["srans2"])


def _metrics(results, case):
    got = {tuple(info[f"{case}_metrics"]) for _, info in results}
    assert len(got) == 1, got  # every rank holds the reduced totals
    return got.pop()


def test_srans_matches_jax_sharded_encode(world, jax_srans):
    W, results = world
    rows, blobs = gathered(results, "srans")
    assert rows == list(range(16))
    assert blobs == jax_srans[0]
    assert [len(b) for b in blobs] == [len(b) for b in jax_srans[0]]
    assert _metrics(results, "srans") == (jax_srans[1], jax_srans[2])


def test_srans_decodes(world, batches):
    W, results = world
    sig, n = batches["srans"]
    out = decoded(results, "srans")
    for i in range(16):
        assert np.array_equal(out[i, : n[i]], sig[i, : n[i]]), i


def test_srans2_matches_jax_and_host(world, jax_srans2, batches):
    W, results = world
    sig, n = batches["srans2"]
    rows, blobs = gathered(results, "srans2")
    assert blobs == jax_srans2[0]
    host = get_codec("srans2_vbbe21_zd")
    assert blobs == [host.press(sig[g, : n[g]]) for g in range(16)]
    assert _metrics(results, "srans2") == (jax_srans2[1], jax_srans2[2])


def test_srans2_ordered_gather(world):
    """Each rank yields its own block in order (windows of 3 rows, fewer
    than a shard of 4); together every row once, in order."""
    W, results = world
    b = 16 // W
    for r, (arrays, _) in enumerate(results):
        assert arrays["srans2_rows"].tolist() == list(range(r * b,
                                                           (r + 1) * b))
    rows, blobs = gathered(results, "srans2")
    assert rows == list(range(16))
    assert _metrics(results, "srans2")[0] == sum(map(len, blobs))


def test_srans2_encode_issues_no_collective(world):
    W, results = world
    for _, info in results:
        assert info["srans2_encode_body_collective_free"]
        # sharded_encode's only collective is the metrics' all_reduce
        assert info["collectives"]["srans2 encode+metrics"] == 1
        assert info["collectives"]["srans2 decode"] == 0


def test_srans2_decodes(world, batches):
    W, results = world
    sig, n = batches["srans2"]
    out = decoded(results, "srans2")
    for i in range(16):
        assert np.array_equal(out[i, : n[i]], sig[i, : n[i]]), i


def test_drans_matches_host_and_unsharded(world, batches):
    """The shared fit over every rank's rows: the streams of one encode
    of the whole padded batch, and the host group codec's over the 14
    reads (the pad rows stay out of G and of the fit)."""
    W, results = world
    sig, n = _padded(batches, "drans", W)
    rows, blobs = gathered(results, "drans")
    assert rows == list(range(sig.shape[0]))
    assert blobs == _unsharded(TD.press_drans_batch, sig, n, O1)
    assert blobs[:14] == drans_press_reads(
        [sig[i, : n[i]] for i in range(14)])
    assert _metrics(results, "drans") == (sum(map(len, blobs)),
                                          2 * int(n.sum()))


def test_drans_decodes(world, batches):
    W, results = world
    sig, n = _padded(batches, "drans", W)
    assert np.array_equal(decoded(results, "drans"), sig)


def test_drans_collective_counts(world):
    """One all_reduce in the encode (the histogram with G), two in the
    decode (the histogram with G, then the G check's verdict)."""
    W, results = world
    for _, info in results:
        c = info["collectives"]
        assert c["drans encode"] == 1
        assert c["drans encode+metrics"] == 2
        assert c["drans decode"] == 2


def test_drans_g_mismatch_raises_on_every_rank(world):
    """The last rank's first row carries an altered G: every rank raises
    ValueError, together, well inside the group's 60 s timeout."""
    W, results = world
    for r, (_, info) in enumerate(results):
        assert info["g_mismatch"] is not None, r
        assert "group mismatch" in info["g_mismatch"]
        assert info["g_mismatch_s"] < 30
        mine = r == W - 1
        assert ("another rank" in info["g_mismatch"]) != mine


def test_dstall_drans_matches_host_and_unsharded(world, batches, mixed):
    W, results = world
    sig, n = _padded(batches, "dstall_drans", W)
    rows, blobs = gathered(results, "dstall_drans")
    assert rows == list(range(sig.shape[0]))
    assert blobs == _unsharded(TDD.press_dstall_drans_batch, sig, n, O1)
    assert blobs[:9] == dd.dstall_drans_press_reads(mixed)


def test_dstall_drans_split_on_some_ranks_only(world):
    """Rows 3 and 4 split; in the world of 4 they lie on rank 1, and the
    other ranks, with no split row, still take part in every fit.  Each
    rank's encode issues 9 collectives besides the metrics': the plain
    fit, is any row split, the two trial fits, the pick's two flags,
    the two split fits again (some split candidate did not pay, so the
    membership changed), the plain fit over the rows left plain, the
    bound; each decode 6, two a drans decode."""
    W, results = world
    splits = [info["split_rows"] for _, info in results]
    flat = [s for rank in splits for s in rank]
    assert [i for i, s in enumerate(flat) if s] == [3, 4]
    if W == 4:
        assert [any(s) for s in splits] == [False, True, False, False]
    for _, info in results:
        assert info["collectives"]["dstall_drans encode+metrics"] == 10
        assert info["collectives"]["dstall_drans decode"] == 6


def test_dstall_drans_decodes(world, batches):
    W, results = world
    sig, n = _padded(batches, "dstall_drans", W)
    assert np.array_equal(decoded(results, "dstall_drans"), sig)


def test_rank_failure_ends_the_world(tmp_path, batches):
    """A rank that raises ends the world: the others, waiting in their
    first collective, are killed, and the launcher raises with the
    failed rank's traceback."""
    with pytest.raises(RuntimeError, match="rank 1 exited") as e:
        run_world(batches, 2, tmp_path, fail_rank=1, timeout_s=120)
    assert "fails on purpose" in str(e.value)


def test_spawn_world_times_out(tmp_path):
    code = "import time; time.sleep(60)"
    with pytest.raises(RuntimeError, match="ran past"):
        spawn_world([sys.executable, "-c", code], 2, timeout_s=0.5)


def test_dryrun_on_the_cpu(runs):
    """The dry run's 2 ranks over gloo: its last line, with the stall
    set's split row on rank 1 only."""
    out = runs["dryrun"]
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun ok: 2 ranks over gloo on cpu"), last
    assert "split rows by rank [0, 1]" in last


def test_pad_rows_to_devices():
    sig = np.zeros((5, 16), np.int16)
    n = np.ones(5, np.int32)
    sig2, n2 = M.pad_rows_to_devices(sig, n, 8)
    assert sig2.shape == (8, 16) and n2[5:].sum() == 0
    j_sig, j_n = jmesh.pad_rows_to_devices(sig, n, 8)
    assert np.array_equal(sig2, j_sig) and np.array_equal(n2, j_n)
    sig3, n3 = M.pad_rows_to_devices(sig, n, 5)
    assert sig3 is sig and n3 is n


def test_init_distributed_is_a_noop_without_env(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert M.init_distributed("gloo", "cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = M.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world) == (None, 0, 1)
    # a world of one without torch.distributed issues no collective
    sig, n = worker.srans2_batch()
    st, sl, comp, raw = M.sharded_encode(
        mesh, lambda s, nn, t: tpipe.press_srans2_batch(s, nn, t), sig, n,
        O1)
    assert comp == int(sl.sum()) and raw == 2 * int(n.sum())
    assert M.gather_lengths(mesh, sl).tolist() == sl.tolist()


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """No fallback: NCCL needs a card a rank, and without CUDA the card
    itself is refused."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_distributed("nccl", "cuda")
    with pytest.raises(RuntimeError, match="a card a rank"):
        M.init_distributed("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        M.init_distributed("mpi", "cpu")
    assert not torch.distributed.is_initialized()


def test_shard_batch_takes_the_rank_block():
    sig, n = worker.srans2_batch()
    mesh = M.Mesh(None, 2, 4, torch.device("cpu"))
    assert mesh.rows(16) == (8, 12)
    s, nn = M.shard_batch(mesh, sig, n)
    assert np.array_equal(s.numpy(), sig[8:12])
    assert np.array_equal(nn.numpy(), n[8:12])
    with pytest.raises(ValueError, match="pad_rows_to_devices"):
        mesh.rows(15)


def test_any_across_and_all_reduce_without_group():
    flags = M.any_across([torch.tensor(True), torch.tensor(False)], None)
    assert flags == [True, False]
    t = torch.arange(3)
    assert M.all_reduce(t, None) is t
