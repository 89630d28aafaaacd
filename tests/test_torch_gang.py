"""The gang bootstrap: ``init_from_env`` joins a pod's workers into one
``torch.distributed`` group from the env the crishim injects (gloo on the
CPU here; the backend rule picks NCCL only for distinct cards), a worker
whose peers never come raises within the stated timeout, ``allreduce_bench``
prints the reference program's line, a ``SimCluster`` runs a two-pod gang of
it as real processes, and ``llama_pjit``'s dp axis across two workers gives
one worker's losses at the same global batch and the reference's
``make_train_step`` under a dp = 2 mesh.

Workers are subprocesses (``python -c``, one torch thread each) on a
coordinator port bound free for the test: the rotating per-process port of
``pick_coordinator_port`` would collide across the tier-1 run's workers."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from kubegpu_tpu.models import LlamaConfig as JLlamaConfig
from kubegpu_tpu.models import llama_param_specs
from kubegpu_tpu.models.llama import make_train_step as j_make_train_step
from kubegpu_tpu.parallel import make_mesh, named_sharding_tree
from kubegpu_tpu.parallel.sharding import fit_spec
from kubegpu_tpu.workloads.programs import allreduce_bench as j_allreduce
from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
from kubegpu_tpu_torch.config import KubeTpuConfig
from kubegpu_tpu_torch.kubemeta import GangSpec, PodPhase, pod_allocation
from kubegpu_tpu_torch.models import LlamaConfig
from kubegpu_tpu_torch.tpuplugin import ChipAdvertisement
from kubegpu_tpu_torch.tpuplugin.mock import build_gpu_env, mock_uuid
from kubegpu_tpu_torch.workloads.programs import distributed, llama_pjit

ROOT = Path(__file__).resolve().parent.parent
LOSS_ATOL = 1e-5      # tests/test_torch_train.py's

CLEARED = ("LLAMA_", "KUBETPU_", "TPU_", "JAX_NUM_PROCESSES",
           "JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID", "CUDA_",
           "NVIDIA_VISIBLE_DEVICES")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(CLEARED):
            monkeypatch.delenv(k)
    return monkeypatch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang_env(rank: int, n: int, port: int) -> dict:
    """What the crishim injects into worker ``rank`` of an ``n``-pod gang
    of one card a pod on an ``h100-sxm-n`` node."""
    chip = ChipAdvertisement(coord=(rank, 0, 0), local_index=rank,
                             uuid=mock_uuid("s", 0, rank))
    return build_gpu_env((n, 1, 1), [chip], rank, n, f"127.0.0.1:{port}",
                         ["node"] * n)


def run_workers(code: str, n: int = 2, extra=None, timeout=120):
    """``python -c code`` as each of ``n`` workers of one gang; their
    (rc, stdout, stderr), rank order."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith(CLEARED)}
    base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], env={**base, **gang_env(r, n, port)},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


GROUP = """
import json, torch, torch.distributed as dist
from kubegpu_tpu_torch.workloads.programs import distributed as d
env = d.init_from_env("cpu")
x = torch.full((3,), float(env.worker_id + 1))
dist.all_reduce(x)
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "backend": dist.get_backend(), "worker": env.worker_id,
                  "sum": x.tolist()}))
d.leave_gang()
"""


def test_two_workers_form_one_gloo_group():
    runs = run_workers(GROUP)
    assert all(rc == 0 for rc, _, _ in runs), [e[-2000:] for _, _, e in runs]
    got = [json.loads(out.strip().splitlines()[-1]) for _, out, _ in runs]
    assert [g["rank"] for g in got] == [g["worker"] for g in got] == [0, 1]
    assert all(g["world"] == 2 and g["backend"] == "gloo"
               and g["sum"] == [3.0] * 3 for g in got)


def test_the_backend_rule_is_the_gangs():
    assert distributed.gang_backend(["GPU-a", "GPU-b"]) == "nccl"
    assert distributed.gang_backend(["GPU-a", "GPU-a"]) == "gloo"
    assert distributed.gang_backend(["cpu", "cpu"]) == "gloo"
    assert distributed.gang_backend(["GPU-a", "cpu"]) == "gloo"


@pytest.mark.parametrize("rank", [0, 1])
def test_a_worker_whose_peers_never_come_raises_in_time(rank, clean_env):
    """Worker 1 waits for a coordinator that never comes up; worker 0
    serves the rendezvous and waits for a peer that never joins.  Both
    raise, in about the stated timeout (2 s here), and no group is
    left."""
    port = free_port()
    for k, v in gang_env(rank, 2, port).items():
        clean_env.setenv(k, v)
    clean_env.setattr(distributed, "RENDEZVOUS_TIMEOUT_S", 2.0)
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        distributed.init_from_env("cpu")
    assert 1.9 < time.monotonic() - t0 < 6.0
    assert not torch.distributed.is_initialized()


def test_a_worker_with_two_cards_raises_naming_item_9(clean_env,
                                                      monkeypatch):
    for k, v in gang_env(1, 2, free_port()).items():
        clean_env.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="sees 2 cards.*item 9"):
        distributed.init_from_env("cuda")


BENCH = """
from kubegpu_tpu_torch.workloads.programs import allreduce_bench
raise SystemExit(allreduce_bench.main(device="cpu"))
"""


def bench_line(out: str) -> dict:
    lines = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"metric": "allreduce_algo_bandwidth"')]
    assert len(lines) == 1, out
    return lines[0]


def test_allreduce_bench_prints_the_reference_line(clean_env, capsys):
    assert j_allreduce.main() == 0            # in process, 8 CPU devices
    want = bench_line(capsys.readouterr().out)
    runs = run_workers(BENCH)
    assert [rc for rc, _, _ in runs] == [0, 0], [e[-2000:]
                                                 for _, _, e in runs]
    got = bench_line(runs[0][1])
    assert list(got) == list(want)
    for k in ("metric", "unit", "payload_gib"):
        assert got[k] == want[k], k
    assert got["devices"] == 2 and got["value"] > 0 and got["step_ms"] > 0
    assert "allreduce_algo_bandwidth" not in runs[1][1]   # worker 0 only


def test_simcluster_runs_a_two_pod_allreduce_gang():
    cfg = KubeTpuConfig()
    cfg.scheduler.coordinator_port = free_port()
    cl = SimCluster(["h100-sxm-2"], real_processes=True, config=cfg,
                    extra_env={"OMP_NUM_THREADS": "1"})
    try:
        cl.submit(*[tpu_pod(f"ar-{i}", chips=1,
                            gang=GangSpec(name="ar", size=2, index=i),
                            mesh_axes={"dp": 2},
                            command=[sys.executable, "-c", BENCH])
                    for i in range(2)])
        codes = cl.run_to_completion(timeout_s=120)
        handles = {h.pod_name: h for h in cl.runtime.containers()}
        assert codes == {"ar-0": 0, "ar-1": 0}, {
            k: h.stderr[-2000:] for k, h in handles.items()}
        assert all(cl.pod_phase(f"ar-{i}") == PodPhase.SUCCEEDED
                   for i in range(2))
        envs = [handles[f"ar-{i}"].env for i in range(2)]
        assert len({e["JAX_COORDINATOR_ADDRESS"] for e in envs}) == 1
        assert envs[0]["JAX_COORDINATOR_ADDRESS"].endswith(
            f":{cfg.scheduler.coordinator_port}")
        assert {e["TPU_WORKER_ID"] for e in envs} == {"0", "1"}
        assert {pod_allocation(cl.api.get("Pod", f"ar-{i}")).worker_id
                for i in range(2)} == {0, 1}
        assert len({e["CUDA_VISIBLE_DEVICES"] for e in envs}) == 2
        zero = next(h for h in handles.values()
                    if h.env["TPU_WORKER_ID"] == "0")
        assert bench_line(zero.stdout)["devices"] == 2
        # the node agent harvested the line as a workload metric
        assert cl.metrics.snapshot()["gauges"][
            "workload_allreduce_algo_bandwidth"] > 0
    finally:
        cl.close()


# -- llama_pjit's dp axis across workers --------------------------------------

# the worker's main(), its unrounded losses taken from train() on the way
LLAMA = """
import json
from kubegpu_tpu_torch.workloads.programs import llama_pjit
train, record = llama_pjit.train, {}
def recorded(*args, **kwargs):
    record["losses"] = train(*args, **kwargs)
    return record["losses"]
llama_pjit.train = recorded
rc = llama_pjit.main(device="cpu")
print("RECORD " + json.dumps({"rc": rc, "losses": record["losses"]}))
"""
STEPS = 3


def reference_losses(params_t, cfg_j) -> list:
    """The reference's ``make_train_step`` under a dp = 2 mesh over two
    virtual CPU devices, jitted with the program's shardings, on the
    port's initial parameters and the program's batches."""
    mesh = make_mesh({"dp": 2}, jax.devices()[:2])
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()),
                          params_t)
    params = jax.device_put(params, named_sharding_tree(
        mesh, llama_param_specs(cfg_j)))
    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    step = jax.jit(j_make_train_step(cfg_j, opt, mesh))
    sharding = NamedSharding(mesh, fit_spec(mesh, P(("dp", "fsdp"), None)))
    losses = []
    for i in range(STEPS):
        tokens = llama_pjit.step_tokens(i, 2, 32, cfg_j.vocab_size, "cpu")
        tokens = jax.device_put(jnp.asarray(tokens.numpy(), jnp.int32),
                                sharding)
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses


def test_llama_dp2_equals_one_worker_and_the_reference(capsys):
    runs = run_workers(LLAMA, extra={"LLAMA_STEPS": str(STEPS),
                                     "LLAMA_MESH": "dp:2"})
    assert [rc for rc, _, _ in runs] == [0, 0], [e[-2000:]
                                                 for _, _, e in runs]
    recs = [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("RECORD "))[7:])
            for _, out, _ in runs]
    # every worker reports the global mean; worker 0 prints the line
    assert recs[0]["losses"] == recs[1]["losses"]
    assert "mesh={'dp': 2} workers=2 devices=2" in runs[0][1]
    assert "llama_pjit:" not in runs[1][1]
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=4, dtype="float32")
    one = llama_pjit.train(cfg, torch.device("cpu"), STEPS, batch=2)
    np.testing.assert_allclose(recs[0]["losses"], one, rtol=1e-5)
    from kubegpu_tpu_torch.models import llama_init
    ref = reference_losses(
        llama_init(cfg, seed=0, device="cpu"),
        JLlamaConfig.tiny(n_heads=4, n_kv_heads=4, dtype="float32"))
    np.testing.assert_allclose(recs[0]["losses"], ref, atol=LOSS_ATOL)


@pytest.mark.parametrize("mesh", ["fsdp:2", "tp:2", "dp:1,tp:2"])
def test_llama_fsdp_or_tp_raise_naming_item_9(mesh, clean_env):
    """Refused from the env, before the rendezvous (no coordinator runs)."""
    for k, v in gang_env(0, 2, free_port()).items():
        clean_env.setenv(k, v)
    clean_env.setenv("LLAMA_MESH", mesh)
    t0 = time.monotonic()
    with pytest.raises(NotImplementedError, match="item 9"):
        llama_pjit.main(device="cpu")
    assert time.monotonic() - t0 < 1.0
