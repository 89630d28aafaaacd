"""Tensor parallelism for the serving engine (counterpart of the serving
part of ``kubegpu_tpu/parallel``): the per-leaf sharding specs, the cut of
a parameter tree into a rank's shard, the engine's collectives
(:mod:`.sharding`, :mod:`.collectives`), and the launcher of one process a rank
(:mod:`.launch`).  Training sharding, the ring, the pipeline and expert
parallelism are not ported yet (ROADMAP.md queue 1, item 9)."""

from kubegpu_tpu_torch.parallel.collectives import (
    all_gather_last,
    all_reduce,
    broadcast_float,
)
from kubegpu_tpu_torch.parallel.launch import launch
from kubegpu_tpu_torch.parallel.sharding import (
    pool_specs,
    serve_param_specs,
    shard_tree,
)

__all__ = ["launch", "all_gather_last", "all_reduce", "broadcast_float",
           "pool_specs", "serve_param_specs", "shard_tree"]
