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


def test_walk_covers_the_load_and_fleet_modules():
    """The AST walk reaches the load harness, the fleet and the flight
    recorder (their reference copies import only numpy and the reference
    package; the port's import neither)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for sub in ("loadgen.py", "fleet.py", "obs/tsdb.py", "obs/alerts.py",
                "obs/chaos.py"):
        assert f"kubegpu_tpu_torch/{sub}" in names, sub


def test_import_leaves_jax_unloaded():
    code = ("import sys, kubegpu_tpu_torch.models, kubegpu_tpu_torch.ops, "
            "kubegpu_tpu_torch.convert, kubegpu_tpu_torch.kernels, "
            "kubegpu_tpu_torch.optim, kubegpu_tpu_torch.obs, "
            "kubegpu_tpu_torch.ops.strict, kubegpu_tpu_torch.scheduler, "
            "kubegpu_tpu_torch.scheduler.serve, kubegpu_tpu_torch.kubemeta, "
            "kubegpu_tpu_torch.kubemeta.codec, kubegpu_tpu_torch.loadgen, "
            "kubegpu_tpu_torch.fleet, kubegpu_tpu_torch.obs.tsdb, "
            "kubegpu_tpu_torch.obs.alerts, "
            "kubegpu_tpu_torch.workloads.programs.llama_serve; "
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
        convert_t5_params,
    )
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        DataParallelServePool,
        DisaggServePool,
        LlamaConfig,
        T5Config,
        greedy_generate,
        llama_init,
        t5_greedy_generate,
        t5_greedy_generate_paged,
        t5_init,
    )
    from kubegpu_tpu_torch.models.decode import init_kv_cache

    cfg = LlamaConfig.tiny()
    params = llama_init(cfg, device="cpu")
    t5_cfg = T5Config.tiny()
    t5_params = t5_init(t5_cfg, device="cpu")
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
        lambda: t5_init(t5_cfg),
        lambda: convert_t5_params({"w": np.zeros(2, np.float32)}),
        lambda: t5_greedy_generate(t5_params, [[1, 2]], 2, t5_cfg),
        lambda: t5_greedy_generate_paged(t5_params, [[1, 2]], 2, t5_cfg,
                                         page_size=4),
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
