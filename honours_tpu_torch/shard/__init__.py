"""Multi-rank data parallelism over torch.distributed (mesh.py), and its
dry run (`python -m honours_tpu_torch.shard.dryrun`, dryrun.py)."""

from honours_tpu_torch.shard.mesh import (
    Mesh,
    all_reduce,
    any_across,
    assert_no_collectives,
    gather_lengths,
    init_distributed,
    iter_ordered_payloads,
    make_mesh,
    pad_rows_to_devices,
    profile_collectives,
    shard_batch,
    sharded_encode,
)

__all__ = [
    "Mesh", "all_reduce", "any_across", "assert_no_collectives",
    "gather_lengths", "init_distributed", "iter_ordered_payloads",
    "make_mesh", "pad_rows_to_devices", "profile_collectives",
    "shard_batch", "sharded_encode",
]
