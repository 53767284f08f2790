"""Scale-out over several devices (counterpart of ``lungmask_tpu.parallel``):
the device mesh, sharded inference and cleanup; ``parallel.multihost`` for
several processes."""

from lungmask_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from lungmask_tpu_torch.parallel.sharded import (
    ShardedUNetRunner,
    make_sharded_argmax,
    make_sharded_postprocess,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
    "ShardedUNetRunner",
    "make_sharded_argmax",
    "make_sharded_postprocess",
]
