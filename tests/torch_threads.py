"""One intra-op torch thread for the process of a port test module.

The plain versions' ops are small, and under xdist every worker's
default intra-op threads (one a core) oversubscribe the host: a
dstall_srans2 case that takes 1.2 s on one thread took 118 s with the
defaults beside a loaded run, and an unsharded dstall_drans encode of
0.6 s took 96 s.  The ranks of tests/torch_shard_worker.py run one
thread each too.  A test module imports the fixture:

    from torch_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
