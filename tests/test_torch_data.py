"""The port's input pipeline (``kubegpu_tpu_torch/workloads/data.py``)
against the reference's (``kubegpu_tpu/workloads/data.py``) on the CPU.

``Shard``, ``ShardedBatcher`` and the synthetic sources are numpy in both:
equal indices and arrays, exactly, and the same refusals.
``prefetch_to_device`` on the CPU yields the reference's
``jax.device_put`` arrays, at every depth.  ``global_batches`` on two gloo
ranks yields each rank the rows that rank's device holds of the
reference's global array on a 2-device CPU mesh (``P("dp")``), and refuses
ranks that feed unequal rows."""

import re

import numpy as np
import pytest
import torch

import data_ranks
from kubegpu_tpu.workloads import data as rdata
from kubegpu_tpu_torch.parallel import launch
from kubegpu_tpu_torch.workloads import data as pdata

ARRAYS = {"x": np.arange(37 * 3, dtype=np.float32).reshape(37, 3),
          "y": np.arange(37, dtype=np.int32)}


@pytest.mark.parametrize("count,batch,seed,shuffle,drop", [
    (1, 8, 0, True, True), (2, 5, 3, True, True), (3, 4, 1, False, True),
    (4, 3, 9, True, False), (2, 7, 0, False, False)])
def test_sharded_batcher(count, batch, seed, shuffle, drop):
    for index in range(count):
        kw = dict(batch_size=batch, seed=seed, shuffle=shuffle,
                  drop_remainder=drop)
        ours = pdata.ShardedBatcher(ARRAYS, shard=pdata.Shard(index, count),
                                    **kw)
        ref = rdata.ShardedBatcher(ARRAYS, shard=rdata.Shard(index, count),
                                   **kw)
        for epoch in range(3):
            assert np.array_equal(ours.epoch_indices(epoch),
                                  ref.epoch_indices(epoch))
            got, want = list(ours.batches(epoch)), list(ref.batches(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                assert all(np.array_equal(g[k], w[k]) and
                           g[k].dtype == w[k].dtype for k in g)
        stream, rstream = iter(ours), iter(ref)
        for _ in range(3 * len(got) + 1):   # the endless stream reshuffles
            g, w = next(stream), next(rstream)
            assert all(np.array_equal(g[k], w[k]) for k in g)


@pytest.mark.parametrize("make", [
    lambda m: m.Shard(2, 2), lambda m: m.ShardedBatcher({}, 4),
    lambda m: m.ShardedBatcher({"a": np.zeros(3), "b": np.zeros(4)}, 1),
    lambda m: m.ShardedBatcher(ARRAYS, 0),
    lambda m: m.ShardedBatcher(ARRAYS, 4, shard=m.Shard(0, 38)),
    lambda m: m.ShardedBatcher(ARRAYS, 10, shard=m.Shard(1, 4))])
def test_refusals(make):
    with pytest.raises(ValueError) as ref:
        make(rdata)
    with pytest.raises(ValueError, match=f"^{re.escape(str(ref.value))}$"):
        make(pdata)


def test_shard_from_worker_env(monkeypatch):
    from kubegpu_tpu.workloads.programs.distributed import read_env

    monkeypatch.setenv("TPU_WORKER_ID", "2")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    assert pdata.Shard.from_worker_env() == pdata.Shard(2, 3)
    assert rdata.Shard.from_worker_env(read_env()) == rdata.Shard(2, 3)


@pytest.mark.parametrize("fn,args", [
    ("synthetic_tokens", (6, 16, 100)), ("synthetic_images", (5, 8, 10)),
    ("synthetic_features", (7, 12, 10))])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_sources(fn, args, seed):
    got = getattr(pdata, fn)(*args, seed=seed)
    want = getattr(rdata, fn)(*args, seed=seed)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_prefetch_to_device_on_the_cpu(size):
    """The same batches in the same order as the reference's
    ``jax.device_put`` double buffer, as tensors on the CPU, each a copy
    of its host array; fewer batches than the depth included."""
    batcher = pdata.ShardedBatcher(ARRAYS, batch_size=8, seed=4)
    for n in (2, 4):
        host = list(batcher.batches(0))[:n]
        got = list(pdata.prefetch_to_device(iter(host), size=size,
                                            device="cpu"))
        want = list(rdata.prefetch_to_device(iter(host), size=size))
        assert len(got) == len(want) == n
        for g, w, h in zip(got, want, host):
            for k in h:
                assert isinstance(g[k], torch.Tensor) and g[k].device.type \
                    == "cpu"
                assert np.array_equal(g[k].numpy(), np.asarray(w[k]))
                assert g[k].numpy().dtype == np.asarray(w[k]).dtype
                assert not np.shares_memory(g[k].numpy(), h[k])
    with pytest.raises(ValueError, match="prefetch size must be >= 1"):
        next(pdata.prefetch_to_device(iter(host), size=0, device="cpu"))


def test_prefetch_keeps_trees():
    batch = {"a": np.ones((2, 2), np.float32),
             "b": [np.zeros(3, np.int32), (np.arange(4),)]}
    (out,) = pdata.prefetch_to_device([batch], device="cpu")
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    assert torch.equal(out["b"][1][0], torch.arange(4))


def test_global_batches_two_ranks():
    """Each of two gloo ranks feeds its shard; its rows are the shard the
    reference's global array (the two shards' rows in rank order, laid
    out by ``NamedSharding(mesh, P("dp"))`` over 2 CPU devices) holds on
    that rank's device.  A rank feeding more rows than the other fails on
    both ranks."""
    import jax
    from jax.sharding import Mesh, PartitionSpec

    arrays = pdata.synthetic_features(64, 5, 10, seed=2)
    rows, errors = launch(data_ranks.global_rows, 2, arrays, 8, 2,
                          backend="gloo", device="cpu")
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    shards = [rdata.ShardedBatcher(arrays, 8, shard=rdata.Shard(r, 2))
              for r in range(2)]
    local = [[b for e in range(2) for b in s.batches(e)] for s in shards]
    assert [len(r) for r in rows] == [len(x) for x in local] == [8, 8]
    for i, (b0, b1) in enumerate(zip(*local)):
        whole = {k: np.concatenate([b0[k], b1[k]]) for k in b0}
        (glob,) = rdata.global_batches([whole], mesh, PartitionSpec("dp"))
        for k in whole:
            assert glob[k].shape == (16,) + whole[k].shape[1:]
            by_device = {s.device: np.asarray(s.data)
                         for s in glob[k].addressable_shards}
            for r in range(2):
                assert np.array_equal(rows[r][i][k],
                                      by_device[mesh.devices[r]])
    assert all("P('dp') gives every rank an equal share" in e
               for e in errors), errors
