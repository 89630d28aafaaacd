"""The port's workload program (``kubegpu_tpu_torch.workloads.programs.
llama_serve``) against the JAX package's, both run in-process on the CPU
(the JAX side's Pallas kernels in interpret mode).

``main()`` under the same env must exit 0 on both sides and print the same
metric names in the same order (the weights differ: each package draws its
own; ``tests/test_torch_llama_serve_engine.py`` holds the lines' values on
shared weights), with the dp pool at tp 1 and at tp 2.  The strict-mode
fences, the tp/dp degradation, the worker env and ``python -m`` without a
card are checked on their own.  Sizes are
tiny (one slot, 3 requests): under the tier-1 run's parallel workers each
JAX engine's compile takes several times its time alone."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubegpu_tpu.ops import strict as jstrict
from kubegpu_tpu.workloads.programs import distributed as jdist
from kubegpu_tpu.workloads.programs import llama_serve as jls
from kubegpu_tpu_torch.obs import spans as tspans
from kubegpu_tpu_torch.ops import strict as tstrict
from kubegpu_tpu_torch.workloads.programs import distributed as tdist
from kubegpu_tpu_torch.workloads.programs import llama_serve as tls

ROOT = Path(__file__).resolve().parent.parent
CONT = {"SERVE_MODE": "continuous", "SERVE_BATCH": "1", "SERVE_REQS": "3",
        "SERVE_STEPS": "16"}
MAIN_CASES = {
    "static": {"SERVE_BATCH": "1", "SERVE_PROMPT": "32", "SERVE_STEPS": "8"},
    "continuous": CONT,
    "dense": {**CONT, "SERVE_PROMPT": "24"},
    "spec": {**CONT, "SERVE_SPEC_GAMMA": "2"},
    "fused": {**CONT, "SERVE_FUSED_K": "4"},
    "kv4": {**CONT, "SERVE_KV_BITS": "4"},
    "evict": {**CONT, "SERVE_EVICT_POLICY": "window"},
    "prefix-chunked": {**CONT, "SERVE_PREFIX_CACHE": "1",
                       "SERVE_CHUNKED_PREFILL": "1"},
    "trace": {**CONT, "SERVE_TRACE": "1"},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores, and torch's default of a thread a core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("SERVE_", "KUBETPU_", "TPU_", "JAX_NUM_",
                            "JAX_COORD")):
            monkeypatch.delenv(name)
    return monkeypatch


def metrics(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def run_both(capsys, port_call, ref_call):
    assert ref_call() == 0
    ref = metrics(capsys.readouterr().out)
    assert port_call() == 0
    ours = metrics(capsys.readouterr().out)
    return ours, ref


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_prints_the_reference_metrics(clean_env, capsys, tmp_path,
                                           case):
    env = dict(MAIN_CASES[case])
    if case == "trace":
        env["SERVE_TRACE_OUT"] = str(tmp_path / "trace.json")
    for k, v in env.items():
        clean_env.setenv(k, v)
    ours, ref = run_both(capsys, lambda: tls.main(device="cpu"), jls.main)
    assert [m["metric"] for m in ours] == [m["metric"] for m in ref]
    assert [sorted(m) for m in ours] == [sorted(m) for m in ref]
    assert len(ours) == (9 if case == "static" else 43 + (case == "trace"))
    if case == "trace":
        events = tspans.validate_chrome_trace(
            (tmp_path / "trace.json").read_text())
        assert sum(e["name"] == "request" for e in events) == 3


def test_chip_smoke_holds_the_reference_names(clean_env, capsys):
    """``chip_smoke.py`` phase 9 checks the pod's output against its own
    lists of the reference program's metric names: they must be the
    reference's, in order."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    clean_env.setenv("SERVE_STEPS", "4")
    assert jls.main() == 0
    static = [m["metric"] for m in metrics(capsys.readouterr().out)]
    for k, v in {**CONT, "SERVE_REQS": "2"}.items():
        clean_env.setenv(k, v)
    assert jls.main() == 0
    cont = [m["metric"] for m in metrics(capsys.readouterr().out)]
    assert chip_smoke.STATIC_METRICS == tuple(static)
    assert chip_smoke.CONTINUOUS_METRICS == tuple(cont)


def test_unaligned_prompt_raises_under_strict_mode(clean_env):
    for k, v in {**CONT, "SERVE_PROMPT": "100",
                 tstrict.ENV_VAR: "1"}.items():
        clean_env.setenv(k, v)
    with pytest.raises(tstrict.StrictFallbackError,
                       match="llama_serve.continuous"):
        tls.main(device="cpu")
    with pytest.raises(jstrict.StrictFallbackError,
                       match="llama_serve.continuous"):
        jls.main()


def test_tp_ask_degrades_on_one_device(clean_env, capsys):
    for k, v in {**CONT, "SERVE_TP": "2"}.items():
        clean_env.setenv(k, v)
    assert tls.main(device="cpu") == 0
    got = {m["metric"]: m["value"] for m in metrics(capsys.readouterr().out)}
    assert (got["serve_engine_cfg_tp"], got["serve_engine_cfg_dp"],
            got["serve_engine_cfg_mesh_devices"]) == (1, 1, 1)
    clean_env.setenv(tstrict.ENV_VAR, "1")
    with pytest.raises(tstrict.StrictFallbackError, match="llama_serve.tp"):
        tls.main(device="cpu")


def test_llama_serve_tp_dp_equals_reference(clean_env, capsys):
    """``SERVE_TP=2 SERVE_DP=2`` on four devices: both programs serve
    through their ``DataParallelServePool(dp=2, tp=2)`` (the port's two
    replicas each a gang of two gloo ranks on the CPU, the reference's on
    4 of its 8 virtual devices) and print the same metric lines, the tp,
    dp, mesh-device and replica echo equal."""
    for k, v in {**CONT, "SERVE_TP": "2", "SERVE_DP": "2"}.items():
        clean_env.setenv(k, v)
    clean_env.setattr(tls, "_device_count", lambda device: 4)
    ours, ref = run_both(capsys, lambda: tls.main(device="cpu"), jls.main)
    assert [m["metric"] for m in ours] == [m["metric"] for m in ref]
    assert [sorted(m) for m in ours] == [sorted(m) for m in ref]
    got = {m["metric"]: m["value"] for m in ours}
    want = {m["metric"]: m["value"] for m in ref}
    for name in ("serve_engine_cfg_dp", "serve_engine_cfg_tp",
                 "serve_engine_cfg_mesh_devices", "serve_replicas_active",
                 "serve_failover_total", "serve_kv_bits"):
        assert got[name] == want[name], name
    assert (got["serve_engine_cfg_tp"], got["serve_engine_cfg_dp"],
            got["serve_engine_cfg_mesh_devices"],
            got["serve_replicas_active"]) == (2, 2, 4, 2)
    assert ours[0]["requests"] == 3


def test_dp_ask_serves_through_the_pool(clean_env, capsys):
    """``SERVE_DP=2`` on two devices: both programs serve through their
    ``DataParallelServePool`` (the port's two replicas on the CPU, the
    reference's on 2 of its 8 virtual devices) and print the same metric
    lines, the dp, mesh-device and replica echo equal."""
    for k, v in {**CONT, "SERVE_DP": "2"}.items():
        clean_env.setenv(k, v)
    clean_env.setattr(tls, "_device_count", lambda device: 2)
    ours, ref = run_both(capsys, lambda: tls.main(device="cpu"), jls.main)
    assert [m["metric"] for m in ours] == [m["metric"] for m in ref]
    assert [sorted(m) for m in ours] == [sorted(m) for m in ref]
    got = {m["metric"]: m["value"] for m in ours}
    want = {m["metric"]: m["value"] for m in ref}
    for name in ("serve_engine_cfg_dp", "serve_engine_cfg_tp",
                 "serve_engine_cfg_mesh_devices", "serve_replicas_active",
                 "serve_failover_total", "serve_kv_bits"):
        assert got[name] == want[name], name
    assert (got["serve_engine_cfg_dp"], got["serve_replicas_active"]) == (2, 2)
    assert ours[0]["requests"] == 3


def test_more_than_one_worker_raises(clean_env):
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(NotImplementedError, match="multi-device"):
        tls.main(device="cpu")


def test_worker_env_matches_reference(clean_env):
    for k, v in {"TPU_WORKER_ID": "3", "JAX_NUM_PROCESSES": "4",
                 "JAX_COORDINATOR_ADDRESS": "h0:8476",
                 "TPU_VISIBLE_CHIPS": "0,2", "TPU_WORKER_HOSTNAMES": "h0,h1",
                 "KUBETPU_MILLITPU": "500", "KUBETPU_HBM_GIB": "80",
                 "KUBETPU_SLICE_ID": "s1"}.items():
        clean_env.setenv(k, v)
    assert vars(tdist.read_env()) == vars(jdist.read_env())
    for k in ("JAX_NUM_PROCESSES", "TPU_VISIBLE_CHIPS", "KUBETPU_HBM_GIB"):
        clean_env.delenv(k)
    assert vars(tdist.read_env()) == vars(jdist.read_env())
    assert tdist.init_from_env().num_workers == 1


def test_bench_config_matches_reference():
    from kubegpu_tpu.benchmark import llama_bench_config
    ref, ours = llama_bench_config(), tls.llama_bench_config()
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq_len", "dtype", "remat", "rope_theta",
              "norm_eps"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.head_dim == 128


def test_auto_config_is_tiny_off_the_card(clean_env, capsys):
    clean_env.setenv("KUBETPU_HBM_GIB", "80")
    clean_env.setenv("SERVE_STEPS", "4")
    assert tls.main(device="cpu") == 0
    assert metrics(capsys.readouterr().out)[0]["config"] == "tiny"


def test_module_run_needs_the_card():
    """``python -m`` targets the card: without one it fails and prints no
    metric (it does not fall back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVE_")}
    r = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.workloads.programs."
         "llama_serve"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert '"metric"' not in r.stdout
    assert "no CUDA device" in r.stderr
