"""Package boundaries of the PyTorch port: ``kubegpu_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of ``kubegpu_tpu``, and
the entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kubegpu_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubegpu_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_walk_covers_the_control_plane_subpackages():
    """The AST walk reaches the port's ``scheduler`` and ``kubemeta``
    copies (the autoscaler and the gang codec the pools read)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("scheduler/__init__.py", "scheduler/serve.py",
                "kubemeta/__init__.py", "kubemeta/codec.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_walk_covers_the_native_core_and_the_workloads():
    """The AST walk reaches the allocator core's bindings, the input
    pipeline, the workload specs and the MNIST programs."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("allocator/_native.py", "workloads/data.py",
                "workloads/specs.py", "workloads/programs/mnist_mlp.py",
                "workloads/programs/mnist_torch.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_walk_covers_the_load_and_fleet_modules():
    """The AST walk reaches the load harness, the fleet and the flight
    recorder (their reference copies import only numpy and the reference
    package; the port's import neither)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("loadgen.py", "fleet.py", "obs/tsdb.py", "obs/alerts.py",
                "obs/chaos.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_walk_covers_the_moe_module():
    """The AST walk reaches the MoE family (its reference imports JAX and
    the reference's Llama module; the port's imports neither)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "kubegpu_tpu_torch/models/moe.py" in names


def test_walk_covers_the_training_families():
    """The AST walk reaches ViT, LoRA, ResNet and the four training
    programs (their references import JAX, flax or optax; the port's
    import none)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("models/vit.py", "models/lora.py", "models/resnet.py",
                "workloads/programs/llama_pjit.py",
                "workloads/programs/vit_train.py",
                "workloads/programs/t5_train.py",
                "workloads/programs/resnet_single.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_walk_covers_the_cluster_layer():
    """The AST walk reaches the cluster layer (topology, the advertisers,
    kubemeta, the allocator, the extender, the crishim, the cluster, the
    config and the CLI); their references import no JAX either, but the
    port keeps its own copies."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("__main__.py", "cli.py", "cluster.py", "config.py",
                "topology/__init__.py", "topology/mesh.py",
                "topology/slices.py", "topology/locality.py",
                "tpuplugin/__init__.py", "tpuplugin/backend.py",
                "tpuplugin/mock.py", "tpuplugin/nvml.py",
                "kubemeta/objects.py", "kubemeta/controlplane.py",
                "obs/trace.py", "obs/logging.py",
                "allocator/__init__.py", "allocator/gang.py",
                "allocator/ordering.py", "scheduler/extender.py",
                "crishim/__init__.py", "crishim/runtime.py",
                "crishim/shim.py", "crishim/agent.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_walk_covers_the_daemons():
    """The AST walk reaches the daemons and their wire modules (their
    references import no JAX; the port keeps its own copies)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("kubemeta/serialize.py", "kubemeta/apiserver_http.py",
                "kubemeta/apiserver_serve.py", "kubemeta/cache.py",
                "crishim/criserver.py", "crishim/protowire.py",
                "crishim/grpcserver.py", "crishim/serve.py",
                "scheduler/daemon.py", "scheduler/webhook.py",
                "obs/metrics.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


DAEMONS = ("kubegpu_tpu_torch.kubemeta.apiserver_serve",
           "kubegpu_tpu_torch.scheduler.daemon",
           "kubegpu_tpu_torch.crishim.serve",
           "kubegpu_tpu_torch.scheduler.webhook",
           "kubegpu_tpu_torch.crishim.grpcserver")


def test_daemon_imports_leave_torch_and_grpc_unloaded():
    """The daemons import no torch (a process that pays torch's import
    starts seconds later) and no grpcio until a gRPC server starts."""
    code = (f"import sys, importlib; [importlib.import_module(m) for m in "
            f"{DAEMONS!r}]; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('torch', 'grpc', 'jax', 'kubegpu_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_leaves_jax_unloaded():
    code = ("import sys, kubegpu_tpu_torch.models, kubegpu_tpu_torch.ops, "
            "kubegpu_tpu_torch.convert, kubegpu_tpu_torch.kernels, "
            "kubegpu_tpu_torch.optim, kubegpu_tpu_torch.obs, "
            "kubegpu_tpu_torch.models.moe, "
            "kubegpu_tpu_torch.ops.strict, kubegpu_tpu_torch.scheduler, "
            "kubegpu_tpu_torch.scheduler.serve, kubegpu_tpu_torch.kubemeta, "
            "kubegpu_tpu_torch.kubemeta.codec, kubegpu_tpu_torch.loadgen, "
            "kubegpu_tpu_torch.fleet, kubegpu_tpu_torch.obs.tsdb, "
            "kubegpu_tpu_torch.obs.alerts, "
            "kubegpu_tpu_torch.workloads.programs.llama_serve, "
            "kubegpu_tpu_torch.models.vit, kubegpu_tpu_torch.models.lora, "
            "kubegpu_tpu_torch.models.resnet, "
            "kubegpu_tpu_torch.workloads.programs.llama_pjit, "
            "kubegpu_tpu_torch.workloads.programs.vit_train, "
            "kubegpu_tpu_torch.workloads.programs.t5_train, "
            "kubegpu_tpu_torch.workloads.programs.resnet_single, "
            "kubegpu_tpu_torch.cli, kubegpu_tpu_torch.cluster, "
            "kubegpu_tpu_torch.tpuplugin.nvml, kubegpu_tpu_torch.crishim, "
            "kubegpu_tpu_torch.allocator, kubegpu_tpu_torch.topology; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card():
    """Without ``device`` every entry point targets CUDA: on a host with
    no card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    from kubegpu_tpu_torch.convert import (
        convert_llama_params,
        convert_lora_adapters,
        convert_moe_params,
        convert_resnet_variables,
        convert_t5_params,
        convert_vit_params,
    )
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        DataParallelServePool,
        DisaggServePool,
        LlamaConfig,
        MoEConfig,
        LoRAConfig,
        T5Config,
        ViTConfig,
        greedy_generate,
        lora_init,
        llama_init,
        moe_greedy_generate,
        moe_init,
        resnet50,
        resnet_tiny,
        t5_greedy_generate,
        t5_greedy_generate_paged,
        t5_init,
        vit_init,
    )
    from kubegpu_tpu_torch.models.decode import init_kv_cache
    from kubegpu_tpu_torch.workloads.programs import (
        llama_pjit,
        resnet_single,
        t5_train,
        vit_train,
    )

    cfg = LlamaConfig.tiny()
    params = llama_init(cfg, device="cpu")
    t5_cfg = T5Config.tiny()
    t5_params = t5_init(t5_cfg, device="cpu")
    moe_cfg = MoEConfig.tiny()
    moe_params = moe_init(moe_cfg, device="cpu")
    errors = (RuntimeError, AssertionError, ValueError)
    calls = [
        lambda: llama_init(cfg),
        lambda: convert_llama_params({"w": np.zeros(2, np.float32)}),
        lambda: init_kv_cache(cfg, 1),
        lambda: greedy_generate(params, [[1, 2]], 2, cfg),
        lambda: ContinuousBatcher(params, cfg, paged=True, page_size=8,
                                  stride=4, prompt_buckets=(8,)),
        # the pools default to the first dp CUDA devices: none here
        lambda: DataParallelServePool(params, cfg, dp=1, page_size=8,
                                      stride=4, prompt_buckets=(8,)),
        lambda: DisaggServePool(params, cfg, page_size=8, stride=4,
                                prompt_buckets=(8,)),
        lambda: moe_init(moe_cfg),
        lambda: convert_moe_params({"w": np.zeros(2, np.float32)}),
        lambda: moe_greedy_generate(moe_params, [[1, 2]], 2, moe_cfg),
        lambda: ContinuousBatcher(moe_params, moe_cfg, paged=True,
                                  page_size=8, stride=4,
                                  prompt_buckets=(8,)),
        lambda: t5_init(t5_cfg),
        lambda: convert_t5_params({"w": np.zeros(2, np.float32)}),
        lambda: t5_greedy_generate(t5_params, [[1, 2]], 2, t5_cfg),
        lambda: t5_greedy_generate_paged(t5_params, [[1, 2]], 2, t5_cfg,
                                         page_size=4),
        lambda: lora_init(params, LoRAConfig()),
        lambda: convert_lora_adapters({"wq": {"a": np.zeros(2, np.float32)}}),
        lambda: vit_init(ViTConfig.tiny()),
        lambda: convert_vit_params({"w": np.zeros(2, np.float32)}),
        lambda: resnet50(),
        lambda: resnet_tiny(),
        lambda: convert_resnet_variables(
            {"params": {"Dense_0": {"bias": np.zeros(2, np.float32)}}}),
        llama_pjit.main, vit_train.main, t5_train.main, resnet_single.main,
    ]
    for call in calls:
        with pytest.raises(errors):
            call()


def test_kernels_build_lazily():
    """Importing the port compiles nothing; the build directory and the
    sources are where the binder looks."""
    from kubegpu_tpu_torch import kernels
    for name in kernels.SIGNATURES:
        assert (kernels.CSRC / f"{name}.cu").exists()
        assert kernels._so_path(name).parent == kernels.BUILD_DIR
    routes = {f"{k}/{r}" for k, rs in kernels.ROUTES.items() for r in rs}
    assert set(kernels.ROUTES) <= set(kernels.SIGNATURES)
    assert set(kernels.launches) == set(kernels.SIGNATURES) | routes


def test_walk_covers_the_parallel_package():
    """The AST walk reaches the tensor-parallel package (its reference,
    ``kubegpu_tpu/parallel``, imports JAX; the port's imports torch and
    the port only)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("__init__.py", "sharding.py", "collectives.py",
                "launch.py"):
        assert f"kubegpu_tpu_torch/parallel/{sub}" in names, sub


def test_rank_bodies_import_no_jax():
    """A spawned tensor-parallel rank imports its bodies afresh: the
    port's gang bodies live in ``models/serve.py`` and ``parallel/
    launch.py`` (the walk above), the tests' in ``tests/tp_ranks.py``,
    which imports neither JAX nor anything of ``kubegpu_tpu``."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "kubegpu_tpu_torch/parallel/launch.py" in names
    src = (ROOT / "kubegpu_tpu_torch/parallel/launch.py").read_text()
    assert "class Gang" in src
    assert "class _GangReplica" in (
        ROOT / "kubegpu_tpu_torch/models/serve.py").read_text()
    ranks = ROOT / "tests" / "tp_ranks.py"
    assert not _imported_roots(ranks) & set(FORBIDDEN)
