"""Tensor parallelism for the serving engine (counterpart of the serving
part of ``kubegpu_tpu/parallel``): the per-leaf sharding specs, the cut of
a parameter tree into a rank's shard, the engine's collectives
(:mod:`.sharding`, :mod:`.collectives`), and the gang of one process a
rank that a pool replica at tp > 1 runs on, with ``launch``, a gang that
runs one function and ends (:mod:`.launch`).  Training sharding, the ring, the pipeline and expert
parallelism are not ported yet (ROADMAP.md queue 1, item 9)."""

from kubegpu_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_gather_last,
    all_reduce,
    broadcast_float,
)
from kubegpu_tpu_torch.parallel.launch import Gang, launch
from kubegpu_tpu_torch.parallel.sharding import (
    pool_specs,
    serve_param_specs,
    shard_tree,
)

__all__ = ["Gang", "launch", "all_gather_dim", "all_gather_last",
           "all_reduce", "broadcast_float", "pool_specs",
           "serve_param_specs", "shard_tree"]
