"""The merge order kernel H (csrc/huffbuild.cu) rests on, checked on the
CPU: a model of its two-queue walk against the reference's tree build
(honours_tpu/tables/huffman.py build_table) and H's plain version
(engine/huffman.py huffman_build_plain).

The reference sorts its list stably by count before every merge and puts
the merged node first, so among equal counts internal nodes come before
leaves and the newest internal node comes first.  The kernel keeps the
leaves sorted and the internal nodes in the order they were made (their
counts never fall), and takes a run of equal-count internal nodes from
its newest end.  It fixes the run's extent only when it takes the run's
first node: every node made after that holds more than the run's count,
while nodes made before it (from smaller items) may still join the run.
The models of two wrong rules (the oldest node of a run first; the extent
fixed when the walk first compares against the run) must each disagree
with the reference on these histograms, so the set reaches the rule.
Lengths and codes must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from entropy_rows import tie_histograms
from honours_tpu.tables.huffman import build_table
from honours_tpu_torch.engine.huffman import huffman_build_plain
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SYMS = 256


def two_queue(h, rule: str = "newest"):
    """(lengths, codes) of histogram h by the kernel's walk.  rule: the
    kernel's ("newest"), or a wrong one: "oldest" (a run from its oldest
    end) or "first_look" (the run's extent fixed at its first comparison)."""
    h = np.asarray(h, np.int64)
    syms = [s for s in range(SYMS) if h[s] > 0]
    order = sorted(syms, key=lambda s: (h[s], s))  # stable by count
    P = len(order)
    lengths = np.zeros(SYMS, np.int32)
    codes = np.zeros(SYMS, np.uint64)
    if P <= 1:
        return lengths, codes
    leaf = [int(h[s]) for s in order]
    node = []  # internal nodes' counts, in the order made
    parent, branch = {}, {}
    li = head = 0
    cur = run_end = -1  # a run [head, cur] of untaken nodes ends at run_end

    def fix_run():
        nonlocal cur, run_end
        run_end = head
        while run_end + 1 < len(node) and node[run_end + 1] == node[head]:
            run_end += 1
        cur = run_end if rule != "oldest" else head

    for _ in range(P - 1):
        kids, total = [], 0
        for _ in range(2):
            avail = head < len(node)
            if rule == "first_look" and avail and cur < 0:
                fix_run()
            if avail and (li >= P or node[head] <= leaf[li]):
                if cur < 0:
                    fix_run()
                total += node[cur]
                kids.append(SYMS + cur)
                if rule == "oldest":
                    cur += 1
                    head = cur
                    if cur > run_end:
                        cur = -1
                else:
                    cur -= 1
                    if cur < head:
                        head, cur = run_end + 1, -1
            else:
                total += leaf[li]
                kids.append(order[li])
                li += 1
        for q, x in enumerate(kids):
            parent[x], branch[x] = SYMS + len(node), q
        node.append(total)
    root = SYMS + len(node) - 1
    for s in syms:  # the path from the leaf up; bit d set on a one branch
        path, x = [], s
        while x != root:
            path.append(branch[x])
            x = parent[x]
        d = len(path)
        code = 0
        for depth, bit in enumerate(reversed(path)):
            if bit and depth < 63:
                code |= 1 << depth
        lengths[s], codes[s] = d, code
    return lengths, codes


@pytest.fixture(scope="module")
def hists():
    hs = tie_histograms()
    return hs, [build_table(h) for h in hs]


def test_two_queue_model_equals_build_table(hists):
    hs, tables = hists
    for i, (h, t) in enumerate(zip(hs, tables)):
        lengths, codes = two_queue(h)
        assert np.array_equal(lengths, t.lengths), i
        assert np.array_equal(codes, t.codes), i


@pytest.mark.parametrize("rule", ["oldest", "first_look"])
def test_wrong_run_rules_differ_from_build_table(hists, rule):
    hs, tables = hists
    wrong = sum(not np.array_equal(two_queue(h, rule)[1], t.codes)
                for h, t in zip(hs, tables))
    assert wrong > 0, rule


def test_plain_version_equals_build_table(hists):
    hs, tables = hists
    lengths, codes = huffman_build_plain(torch.from_numpy(np.stack(hs)))
    for i, t in enumerate(tables):
        assert np.array_equal(lengths[i].numpy(), t.lengths), i
        assert np.array_equal(codes[i].numpy().astype(np.uint64), t.codes), i
