"""Input pipeline for the workload layer (counterpart of
``kubegpu_tpu/workloads/data.py``).

The reference scheduled jobs and left data loading to the workload
(SURVEY.md §3: no first-party loader); the workloads need three input-
pipeline pieces, here over ``torch`` and its devices:

1. :class:`ShardedBatcher` — deterministic, seeded epoch iteration
   where each worker of the gang reads a DISJOINT shard: one global
   permutation per epoch (same on every worker, derived from
   (seed, epoch) only), sliced per worker.  Numpy only: for equal
   arguments it gives the reference's indices and arrays exactly, as do
   the synthetic sources below.
2. :func:`prefetch_to_device` — double-buffered host→device transfer:
   batch N+1's copy (pinned host memory, a side CUDA stream) overlaps
   batch N's compute, as ``jax.device_put``'s async transfers do for the
   reference.
3. :func:`global_batches` — the data-parallel batch of a
   ``torch.distributed`` group: each rank's local rows on its device,
   checked to be the share a ``P("dp")`` layout gives that rank.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from kubegpu_tpu_torch.tree import tree_leaves


@dataclass(frozen=True)
class Shard:
    """This worker's slice of the gang: ``index`` of ``count``."""
    index: int = 0
    count: int = 1

    def __post_init__(self) -> None:
        if not 0 <= self.index < self.count:
            raise ValueError(f"shard {self.index} not in [0,{self.count})")

    @classmethod
    def from_worker_env(cls, env=None) -> "Shard":
        """From the injected gang env, parsed by the ONE owner of that
        contract (``workloads.programs.distributed.read_env``).  Pass an
        existing ``WorkerEnv`` to avoid re-reading os.environ."""
        if env is None:
            from kubegpu_tpu_torch.workloads.programs.distributed import (
                read_env,
            )
            env = read_env()
        return cls(index=env.worker_id, count=env.num_workers)


class ShardedBatcher:
    """Deterministic sharded epoch iteration over array-shaped data.

    ``arrays`` is a dict of equal-leading-dim numpy arrays (features,
    labels, ...).  Per epoch: one global permutation seeded by
    ``(seed, epoch)`` — identical on every worker — is cut into
    per-worker contiguous slices; each worker batches its slice.
    ``drop_remainder`` keeps batch shapes static (the tail examples of
    an epoch are dropped, different ones each epoch thanks to the
    reshuffle)."""

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int,
                 shard: Shard | None = None, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True):
        if not arrays:
            raise ValueError("arrays must be non-empty")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"leading dims differ: {sizes}")
        self.arrays = dict(arrays)
        self.n = next(iter(sizes.values()))
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = batch_size
        self.shard = shard or Shard()
        if self.n < self.shard.count:
            raise ValueError(
                f"{self.n} examples cannot shard {self.shard.count} ways")
        per = self.n // self.shard.count
        if drop_remainder and per < batch_size:
            # would silently yield ZERO batches every epoch — fail loud
            # at construction with the numbers the operator needs
            raise ValueError(
                f"per-worker shard of {per} examples (n={self.n} / "
                f"{self.shard.count} workers) cannot fill one batch of "
                f"{batch_size} with drop_remainder; shrink the batch or "
                f"the gang")
        self.seed = seed
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This worker's example indices for ``epoch`` (disjoint across
        workers; the union over workers is all n, minus the per-epoch
        tail that doesn't split evenly across the gang)."""
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(self.n)
        else:
            perm = np.arange(self.n)
        per = self.n // self.shard.count
        lo = self.shard.index * per
        return perm[lo:lo + per]

    def batches(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch)
        n_full = len(idx) // self.batch_size
        end = n_full * self.batch_size if self.drop_remainder else len(idx)
        for lo in range(0, end, self.batch_size):
            sel = idx[lo:lo + self.batch_size]
            yield {k: v[sel] for k, v in self.arrays.items()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        """Endless stream: epoch 0, 1, 2, ... reshuffled each time."""
        epoch = 0
        while True:
            yield from self.batches(epoch)
            epoch += 1


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def prefetch_to_device(it: Iterable, size: int = 2,
                       device="cuda") -> Iterator:
    """Keep ``size`` batches in flight on ``device``.  Each element's
    arrays (a dict, list or tuple tree of numpy arrays or tensors) go into
    pinned host tensors and are copied with ``non_blocking=True`` on a
    side CUDA stream as soon as a slot frees, so the copy of batch N+1
    overlaps the compute consuming batch N; before a batch is yielded the
    consumer's stream waits on its copy's event (without that wait the
    consumer could read a tensor the copy has not written yet).  On an
    explicit CPU device each array is copied into a tensor, no more."""
    import torch

    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        if not cuda:
            return _tree_map(lambda x: torch.as_tensor(np.array(x)), batch)
        host = _tree_map(
            lambda x: torch.as_tensor(np.asarray(x)).pin_memory(), batch)
        with torch.cuda.stream(side):
            out = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(side)
        # the pinned sources live until the copy is consumed
        return out, done, host

    def ready(entry):
        if not cuda:
            return entry
        out, done, _ = entry
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        # made on the side stream, used on this one
        for t in tree_leaves(out):
            t.record_stream(consumer)
        return out

    queue: collections.deque = collections.deque()
    it = iter(it)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == size:
            break
    while queue:
        out = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        yield ready(out)


def global_batches(it: Iterable, device="cuda", group=None) -> Iterator:
    """The data-parallel global batch of a ``torch.distributed`` group,
    as each rank holds it.

    The reference assembles a global ``jax.Array`` laid out by
    ``NamedSharding(mesh, P("dp"))`` from each process's rows
    (``jax.make_array_from_process_local_data``): the global batch is the
    processes' rows in process order, and ``P("dp")`` gives device r of
    the dp axis rows ``[r * B / dp, (r + 1) * B / dp)``.  Under
    ``torch.distributed`` no rank holds the global array: this yields each
    rank's LOCAL rows (a dict/list/tuple tree of arrays) as tensors on
    ``device``, and checks that they are the share ``P("dp")`` gives that
    rank — every leaf with the same leading dim, equal on every rank of
    ``group`` (the default group; one process without one), so that the
    ranks' rows in rank order split evenly over the dp axis.  Raises
    ``ValueError`` otherwise."""
    import torch
    import torch.distributed as dist

    device = torch.device(device)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    for batch in it:
        out = _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device),
                        batch)
        rows = {t.shape[0] for t in tree_leaves(out)}
        if len(rows) != 1:
            raise ValueError(f"a batch's leaves have leading dims {rows}")
        if world > 1:
            every = [None] * world
            dist.all_gather_object(every, rows.pop(), group=group)
            if len(set(every)) != 1:
                raise ValueError(
                    f"ranks hold {every} rows: P('dp') gives every rank an "
                    "equal share of the global batch")
        yield out


def synthetic_tokens(n: int, seq_len: int, vocab_size: int,
                     seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic synthetic causal-LM dataset ({'tokens': [n, T]}).

    All-T loss contract: the train step forwards the full [B, T] and
    computes next-token loss on T-1 positions internally — examples are
    exactly ``seq_len`` long so kernel block alignment survives."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(
        0, vocab_size, (n, seq_len), dtype=np.int32)}


def synthetic_images(n: int, size: int, n_classes: int,
                     seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic synthetic image-classification dataset."""
    rng = np.random.default_rng(seed)
    return {
        "images": rng.standard_normal((n, size, size, 3),
                                      dtype=np.float32),
        "labels": rng.integers(0, n_classes, (n,), dtype=np.int32),
    }


def synthetic_features(n: int, dim: int, n_classes: int,
                       seed: int = 0) -> dict[str, np.ndarray]:
    """Deterministic flat-feature classification dataset
    ({'x': [n, dim] f32, 'y': [n] i32}) — the MLP workloads' source."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, dim), dtype=np.float32),
            "y": rng.integers(0, n_classes, (n,), dtype=np.int32)}
