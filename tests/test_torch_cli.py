"""``python -m kubegpu_tpu_torch``: ``apply --schedule-only`` and ``top`` print
the reference CLI's output for every example spec; the port's JSON specs
schedule onto H100 nodes; ``apply --real`` launches a probe pod on the CPU
with the grant's env; ``slices`` lists the switched nodes; ``bench``, the
reference's one command still unported, raises naming its ROADMAP item."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kubegpu_tpu.cli as rcli
import kubegpu_tpu_torch.cli as pcli
from kubegpu_tpu_torch.config import load_structured_file

ROOT = Path(__file__).resolve().parent.parent
SPECS = sorted((ROOT / "examples").glob("*.yaml"))
PORT_SPECS = sorted((ROOT / "kubegpu_tpu_torch" / "examples").glob("*.json"))
PIN = ["--set", "scheduler.coordinator_port=9476"]


@pytest.fixture(scope="module", autouse=True)
def one_thread_python_paths():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield
    torch.set_num_threads(threads)


def run(main, argv, capsys) -> tuple[int, str]:
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("path", SPECS, ids=[p.stem for p in SPECS])
def test_apply_schedule_only_prints_the_reference_table(path, capsys):
    for verb in (["apply", "-f", str(path), "--schedule-only", "--top"],
                 ["top", "-f", str(path)]):
        want = run(rcli.main, verb + PIN, capsys)
        got = run(pcli.main, verb + PIN, capsys)
        assert got == want
        assert "POD" in got[1] and got[0] == 0


@pytest.mark.parametrize("path", PORT_SPECS, ids=[p.stem for p in PORT_SPECS])
def test_the_port_specs_schedule_on_h100_nodes(path, capsys, tmp_path):
    spec = load_structured_file(str(path))
    trace = tmp_path / "trace.json"
    rc, out = run(pcli.main, ["apply", "-f", str(path), "--schedule-only",
                              "--trace-out", str(trace)] + PIN, capsys)
    assert rc == 0
    assert all(s.startswith("h100-sxm-") for s in spec["cluster"]["slices"])
    running = [r for r in out.splitlines()[1:] if " Running " in r]
    assert len(running) == len(pcli.pods_from_spec(spec)[0])
    assert all("-host-0" in r for r in running)
    events = json.loads(trace.read_text())
    assert [e["kind"] for e in events].count("schedule") == len(
        spec["pods"])


def test_apply_real_launches_a_probe_pod_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "env.json"
    probe = ("import json, os, sys; json.dump(dict(os.environ), "
             "open(sys.argv[1], 'w'))")
    spec = tmp_path / "probe.json"
    spec.write_text(json.dumps({
        "cluster": {"slices": ["h100-sxm-2"]},
        "pods": [{"name": "probe", "chips": 1,
                  "command": [sys.executable, "-c", probe, str(out)],
                  "env": {"KUBETPU_EXPECT_CHIPS": "1"}}]}))
    rc, table = run(pcli.main, ["apply", "-f", str(spec), "--real",
                                "--timeout", "60"], capsys)
    assert rc == 0 and " Succeeded " in table
    env = json.loads(out.read_text())
    assert env["CUDA_VISIBLE_DEVICES"].startswith("GPU-")
    assert env["NVIDIA_VISIBLE_DEVICES"] == env["CUDA_VISIBLE_DEVICES"]
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    assert env["TPU_VISIBLE_CHIPS"] == "0"
    assert "JAX_PLATFORMS" not in env


def test_slices_lists_the_switched_nodes(capsys):
    rc, out = run(pcli.main, ["slices"], capsys)
    assert rc == 0
    rows = {line.split()[0]: line.split() for line in out.splitlines()[1:]}
    for n in (1, 2, 4, 8):
        row = rows[f"h100-sxm-{n}"]
        assert row[1:7] == [f"{n}x1x1", str(n), "1", "fff", "80G", "switch"]
    assert rows["v5e-256"][-1] == "torus"
    want = run(rcli.main, ["slices"], capsys)[1].splitlines()
    assert [r.split()[:6] for r in want[1:]] == \
        [rows[r.split()[0]][:6] for r in want[1:]]


@pytest.mark.parametrize("verb", ["demo", "bench", "metrics", "configs"])
def test_unported_commands_raise_naming_their_item(verb, capsys):
    """``bench`` (the reference's benchmark harness) raises naming ROADMAP
    item 11a; the other three, ported with ``workloads/specs.py`` (item
    10f), now run: dry ``demo config1``, ``metrics`` of a port spec
    scheduled only, ``configs``."""
    if verb == "bench":
        with pytest.raises(NotImplementedError, match="ROADMAP item 11a"):
            pcli.main([verb])
        return
    argv = {"demo": ["demo", "config1"],
            "metrics": ["metrics", "-f", str(PORT_SPECS[0]),
                        "--schedule-only", *PIN],
            "configs": ["configs"]}[verb]
    assert run(pcli.main, argv, capsys)[0] == 0


def test_yaml_without_pyyaml_raises_the_reference_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="reading YAML requires pyyaml"):
        load_structured_file(str(SPECS[0]))


def test_python_dash_m_entry_point():
    path = PORT_SPECS[0]
    r = subprocess.run([sys.executable, "-m", "kubegpu_tpu_torch", "apply",
                        "-f", str(path), "--schedule-only"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0].split() == ["POD", "PHASE", "NODE",
                                                "CHIPS", "WORKER", "EXIT"]
