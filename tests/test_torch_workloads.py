"""The port's workload surface against the reference's, on the CPU:
``workloads/specs.py``'s ``ALL_CONFIGS`` (the reference's nine names,
pods, requests and env, scheduled onto H100 nodes with the grant sizes the
reference's get on TPU slices), the CLI's ``configs``, ``demo`` (dry, and
``config1 --real``) and ``metrics`` (as the reference's
``tests/test_config_cli.py`` checks them), and the MNIST programs:
``mnist_mlp``'s per-epoch losses from the reference's initial parameters,
``mnist_torch``'s losses, and their refusals."""

import json

import numpy as np
import pytest
import torch

import kubegpu_tpu.cli as rcli
import kubegpu_tpu_torch.cli as pcli
from kubegpu_tpu.cluster import SimCluster as RefCluster
from kubegpu_tpu.kubemeta.codec import pod_allocation as ref_allocation
from kubegpu_tpu.workloads import data as rdata
from kubegpu_tpu.workloads.specs import ALL_CONFIGS as REF_CONFIGS
from kubegpu_tpu_torch.cluster import SimCluster
from kubegpu_tpu_torch.kubemeta import PodPhase
from kubegpu_tpu_torch.kubemeta.codec import pod_allocation
from kubegpu_tpu_torch.workloads import data as pdata
from kubegpu_tpu_torch.workloads.programs import mnist_mlp, mnist_torch
from kubegpu_tpu_torch.workloads.specs import ALL_CONFIGS

# mnist_mlp: 40 Adam steps in f32; the per-epoch mean losses of the two
# frameworks part by float rounding in the products and the moments
# (1.1e-7 relative at most on the CPU)
MLP_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_device_env(monkeypatch):
    for k in mnist_torch.DEVICE_ENV + ("KUBETPU_EXPECT_CHIPS",):
        monkeypatch.delenv(k, raising=False)


def pod_view(pod) -> dict:
    """What a pod asks: requests, env, program, gang and mesh axes."""
    c = pod.spec.containers[0]
    ann = {k: v for k, v in pod.metadata.annotations.items()
           if "multislice" not in k}
    return {"requests": (c.resources.tpu_chips, c.resources.millitpu,
                         c.resources.hbm_gib),
            "env": c.env, "program": c.command[-1].rsplit(".", 1)[-1],
            "annotations": ann}


def grants(cl, alloc_of) -> dict:
    out = {}
    for pod in cl.api.list("Pod"):
        a = alloc_of(pod)
        out[pod.name] = sorted(c.millichips for c in a.chips) if a else []
    return out


def test_all_configs_are_the_references():
    assert list(ALL_CONFIGS) == list(REF_CONFIGS)
    for name, fn in ALL_CONFIGS.items():
        assert fn.__doc__.strip().splitlines()[0] == \
            REF_CONFIGS[name].__doc__.strip().splitlines()[0], name


@pytest.mark.parametrize("name", list(REF_CONFIGS))
def test_config_schedules_as_the_references(name):
    """Same pods asking the same, each config scheduled in one pass on the
    port's mock H100 nodes and the reference's on its TPU slices: every
    pod placed, with grants of the same sizes."""
    pods, slices = ALL_CONFIGS[name]()
    rpods, rslices = REF_CONFIGS[name]()
    assert [p.name for p in pods] == [p.name for p in rpods]
    for p, r in zip(pods, rpods):
        assert pod_view(p) == pod_view(r), p.name
        assert p.spec.containers[0].command[-1].startswith(
            "kubegpu_tpu_torch.workloads.programs.")
    assert all(s.startswith("h100-sxm-") for s in slices)
    ours, ref = SimCluster(slices), RefCluster(rslices)
    try:
        ours.submit(*pods)
        ref.submit(*rpods)
        ours.step()
        ref.step()
        assert all(p.status.phase != PodPhase.PENDING
                   for p in ours.api.list("Pod")), name
        assert grants(ours, pod_allocation) == grants(ref, ref_allocation)
    finally:
        ours.close()
        ref.close()


def run(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_configs_verb(capsys):
    assert run(pcli.main, ["configs"], capsys) == \
        run(rcli.main, ["configs"], capsys)


@pytest.mark.parametrize("name", ["config4", "config5"])
def test_demo_dry(name, capsys):
    rc, out = run(pcli.main, ["demo", name], capsys)
    assert rc == 0
    pods, _ = ALL_CONFIGS[name]()
    assert all(p.name in out for p in pods) and "fill" in out
    assert " Pending " not in out
    rc, out = run(pcli.main, ["demo", "nope"], capsys)
    assert rc == 2


def test_demo_config1_real(capsys):
    """The 0-card pod runs ``mnist_torch`` as a process, on the CPU, to
    Succeeded."""
    rc, out = run(pcli.main, ["demo", "config1", "--real", "--timeout",
                              "120"], capsys)
    assert rc == 0, out
    assert "mnist-cpu" in out and "Succeeded" in out


def test_metrics_verb(tmp_path, capsys):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "cluster": {"slices": ["h100-sxm-4"]},
        "pods": [{"name": "p", "chips": 1, "command": ["noop"]}]}))
    rc, out = run(pcli.main, ["metrics", "-f", str(spec), "--schedule-only"],
                  capsys)
    assert rc == 0
    assert json.loads(out)["histograms"]["schedule_latency_ms"]["count"] >= 1
    rc, out = run(pcli.main, ["metrics", "-f", str(spec), "--schedule-only",
                              "--format", "prometheus"], capsys)
    assert rc == 0
    assert "# TYPE kubetpu_schedule_latency_ms histogram" in out


def reference_mnist_mlp():
    """The reference program's training loop (``mnist_mlp.main``), line for
    line, keeping every epoch's mean loss (the program prints the first
    and last) and its initial parameters as numpy."""
    import jax
    import jax.numpy as jnp
    import optax

    k3 = jax.random.split(jax.random.PRNGKey(0), 3)[2]
    k_a, k_b = jax.random.split(k3)
    params = {"w1": jax.random.normal(k_a, (784, 128)) * 0.05,
              "b1": jnp.zeros((128,)),
              "w2": jax.random.normal(k_b, (128, 10)) * 0.05,
              "b2": jnp.zeros((10,))}
    init = {k: np.asarray(v) for k, v in params.items()}

    def loss_fn(params, xb, yb):
        h = jax.nn.relu(xb @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()

    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, xb, yb):
        loss, grads = jax.value_and_grad(loss_fn)(params, xb, yb)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    batcher = rdata.ShardedBatcher(rdata.synthetic_features(256, 784, 10),
                                   batch_size=64)
    means = []
    for epoch in range(10):
        losses = []
        for batch in rdata.prefetch_to_device(batcher.batches(epoch), size=2):
            params, opt_state, loss = step(params, opt_state, batch["x"],
                                           batch["y"])
            losses.append(float(loss))
        means.append(sum(losses) / len(losses))
    return init, means


def test_mnist_mlp_losses_equal_the_references():
    init, want = reference_mnist_mlp()
    batcher = pdata.ShardedBatcher(pdata.synthetic_features(256, 784, 10),
                                   batch_size=64)
    got = mnist_mlp.train({k: torch.tensor(v) for k, v in init.items()},
                          batcher, "cpu")
    np.testing.assert_allclose(got, want, rtol=MLP_RTOL)
    assert got[-1] < got[0]


def test_mnist_mlp_main(monkeypatch, capsys):
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0")
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    monkeypatch.setenv("KUBETPU_EXPECT_CHIPS", "1")
    rc, out = run(lambda _: mnist_mlp.main(device="cpu"), None, capsys)
    assert rc == 0
    assert out.startswith("mnist_mlp: first_loss=")
    assert out.strip().endswith("devices=1 worker_id=0")
    monkeypatch.setenv("KUBETPU_EXPECT_CHIPS", "2")
    assert mnist_mlp.main(device="cpu") == 2


def test_mnist_torch_equals_the_reference(capsys):
    from kubegpu_tpu.workloads.programs import mnist_torch as ref

    assert ref.main() == 0
    want = capsys.readouterr().out.strip()
    rc, out = run(lambda _: mnist_torch.main(), None, capsys)
    assert rc == 0
    assert out.strip() == want + " cards=0"


@pytest.mark.parametrize("var", mnist_torch.DEVICE_ENV)
def test_mnist_torch_refuses_a_device(var, monkeypatch):
    monkeypatch.setenv(var, "0")
    assert mnist_torch.main() == 2
