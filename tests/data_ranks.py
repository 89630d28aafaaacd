"""Rank entry points for ``tests/test_torch_data.py``: each rank is a
spawned process that imports this module afresh, so it imports numpy,
torch and the port only (never JAX)."""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from kubegpu_tpu_torch.workloads.data import (
    Shard,
    ShardedBatcher,
    global_batches,
)


def global_rows(arrays: dict, batch_size: int, epochs: int):
    """Every rank's ``global_batches`` rows over its shard of ``arrays``
    (as numpy, gathered to every rank), then each rank's error where
    rank r feeds 2 + r rows."""
    rank, world = dist.get_rank(), dist.get_world_size()
    batcher = ShardedBatcher(arrays, batch_size, shard=Shard(rank, world))
    mine = [{k: v.numpy() for k, v in b.items()} for e in range(epochs)
            for b in global_batches(batcher.batches(e), device="cpu")]
    rows = [None] * world
    dist.all_gather_object(rows, mine)
    try:
        list(global_batches([{"x": np.zeros((2 + rank, 3))}], device="cpu"))
        err = None
    except ValueError as exc:
        err = str(exc)
    errors = [None] * world
    dist.all_gather_object(errors, err)
    return rows, errors
