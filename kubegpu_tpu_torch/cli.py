"""``kubetpu`` CLI — the user surface (copied from ``kubegpu_tpu/cli.py``).

Reference parity: the reference's users drove everything with ``kubectl
apply -f job.yaml`` plus deploy scripts (SURVEY.md §3 "Example workloads").
Here the control plane is the in-process SimCluster, so the CLI collapses
kubectl + cluster into one binary:

  python -m kubegpu_tpu_torch apply -f spec.json   # submit pods, run them
  python -m kubegpu_tpu_torch demo config4         # a named BASELINE config
  python -m kubegpu_tpu_torch top -f spec.json     # schedule only; occupancy
  python -m kubegpu_tpu_torch metrics -f spec.json # run; dump the metrics
  python -m kubegpu_tpu_torch slices               # known slice types
  python -m kubegpu_tpu_torch configs              # named example workloads

``apply --real`` launches each pod as a process on the cards its grant
names (``CUDA_VISIBLE_DEVICES``); the port's programs need a card.  On a
card host add ``--set backend.type=nvml``: the cluster is then this node as
NVML finds it (the spec's slices are ignored), and a grant names real cards
(the mock backend's UUIDs are made up, so CUDA sees no card in its pods)::

  python -m kubegpu_tpu_torch apply -f spec.json --real --set backend.type=nvml

``demo <name>`` submits one of ``workloads/specs.py``'s ``ALL_CONFIGS``
(``configs`` lists them) and schedules it, or with ``--real`` runs it the
same way.  The reference's ``bench`` raises ``NotImplementedError``: it runs
the reference's benchmark harness, which the port's benchmark brings
(ROADMAP item 11a).

Spec file format (JSON; YAML with PyYAML installed), as the reference's::

    {"cluster": {"slices": ["h100-sxm-8", "h100-sxm-8"]},
     "pods": [{"name": "llama",        # gang pods expand to llama-0..N-1
               "gang": 2,              # gang size (or {name: ..., size: N})
               "chips": 8,             # whole cards a pod, on one node
               "mesh_axes": {"dp": 2, "tp": 8},
               "multislice": true,     # may span nodes (the outer axis)
               "command": ["python", "-m",
                           "kubegpu_tpu_torch.workloads.programs.llama_pjit"],
               "env": {"LLAMA_STEPS": "2"}}]}

The port's own specs are under ``kubegpu_tpu_torch/examples/``.
"""

from __future__ import annotations

import argparse
import json
import string
import sys

from kubegpu_tpu_torch.cluster import SimCluster, tpu_pod
from kubegpu_tpu_torch.config import KubeTpuConfig
from kubegpu_tpu_torch.kubemeta import GangSpec, PodPhase
from kubegpu_tpu_torch.kubemeta.codec import pod_allocation


# ---------------------------------------------------------------------------
# Spec parsing
# ---------------------------------------------------------------------------

def load_spec_file(path: str) -> dict:
    from kubegpu_tpu_torch.config import load_structured_file
    return load_structured_file(path)


def quotas_from_spec(spec: dict) -> dict[str, dict]:
    """namespace → {chips, millitpu} from the spec's ``quotas`` section."""
    out = {}
    for ns, q in (spec.get("quotas") or {}).items():
        out[str(ns)] = {
            "chips": int(q["chips"]) if "chips" in q else None,
            "millitpu": int(q["millitpu"]) if "millitpu" in q else None,
        }
    return out


def pods_from_spec(spec: dict) -> tuple[list, list[str]]:
    """(pods, slice_types) from a parsed spec file."""
    slices = list((spec.get("cluster") or {}).get("slices", ["v4-8"]))
    pods = []
    for entry in spec.get("pods", []):
        name = entry["name"]
        namespace = str(entry.get("namespace", "default"))
        gang = entry.get("gang")
        chips = int(entry.get("chips", 0))
        millitpu = int(entry.get("millitpu", 0))
        hbm_gib = float(entry.get("hbm_gib", 0.0))
        axes = entry.get("mesh_axes")
        if axes is not None:
            axes = {str(k): int(v) for k, v in axes.items()}
        command = [str(c) for c in entry.get("command", [])]
        env = {str(k): str(v) for k, v in (entry.get("env") or {}).items()}
        priority = int(entry.get("priority", 0))
        multislice = bool(entry.get("multislice", False))
        migratable = bool(entry.get("migratable", False))
        if gang is None:
            pods.append(tpu_pod(name, chips=chips, millitpu=millitpu,
                                mesh_axes=axes, command=command, env=env,
                                priority=priority, multislice=multislice,
                                namespace=namespace, migratable=migratable,
                                hbm_gib=hbm_gib))
            continue
        if isinstance(gang, int):
            gang = {"size": gang}
        size = int(gang["size"])
        gname = str(gang.get("name", name))
        for i in range(size):
            pods.append(tpu_pod(
                f"{name}-{i}", chips=chips, millitpu=millitpu,
                gang=GangSpec(name=gname, size=size, index=i),
                mesh_axes=axes, command=command, env=env,
                priority=priority, multislice=multislice,
                namespace=namespace, migratable=migratable,
                hbm_gib=hbm_gib))
    return pods, slices


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render_pod_table(cl: SimCluster, out=None) -> None:
    out = out or sys.stdout
    rows = [("POD", "PHASE", "NODE", "CHIPS", "WORKER", "EXIT")]
    for pod in sorted(cl.api.list("Pod"), key=lambda p: p.name):
        alloc = pod_allocation(pod)
        chips = ",".join(str(c.coord) for c in alloc.chips) if alloc else "-"
        worker = str(alloc.worker_id) if alloc else "-"
        code = ("" if pod.status.exit_code is None
                else str(pod.status.exit_code))
        rows.append((pod.name, pod.status.phase.value,
                     pod.spec.node_name or "-", chips, worker, code))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)), file=out)


def render_top(cl: SimCluster, out=None) -> None:
    """Slice occupancy map: one grid per slice, a letter per gang,
    ``.`` free, ``x`` unhealthy, ``!`` partially used (fractional)."""
    out = out or sys.stdout
    # stable letter per gang
    letters = {}
    order = string.ascii_lowercase + string.ascii_uppercase

    def letter_for(gang: str) -> str:
        if gang not in letters:
            letters[gang] = order[len(letters) % len(order)]
        return letters[gang]

    coord_gang: dict[tuple[str, tuple], str] = {}
    for pod in cl.api.list("Pod"):
        if pod.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED):
            continue
        alloc = pod_allocation(pod)
        if alloc is None:
            continue
        gang = alloc.gang_name or pod.name
        for ch in alloc.chips:
            coord_gang[(alloc.slice_id, ch.coord)] = gang

    for sid in sorted(cl.scheduler.slices):
        st = cl.scheduler.slices[sid]
        sx, sy, sz = st.spec.mesh_shape
        print(f"{sid}  ({st.spec.name}, {sx}x{sy}x{sz}, "
              f"fill {st.fill_fraction():.0%})", file=out)
        for z in range(sz):
            for y in range(sy - 1, -1, -1):  # y up, like a map
                row = []
                for x in range(sx):
                    c = (x, y, z)
                    if c in st.unhealthy or c not in st.available:
                        row.append("x")
                    elif (sid, c) in coord_gang:
                        row.append(letter_for(coord_gang[(sid, c)]))
                    elif st.used_millichips.get(c, 0) > 0:
                        row.append("!")
                    else:
                        row.append(".")
                print("  " + " ".join(row), file=out)
            if sz > 1 and z < sz - 1:
                print("  --- z ---", file=out)
    if letters:
        legend = "  ".join(f"{v}={k}" for k, v in sorted(
            letters.items(), key=lambda kv: kv[1]))
        print(f"gangs: {legend}", file=out)


# ---------------------------------------------------------------------------
# Verbs
# ---------------------------------------------------------------------------

def _build_cluster(args, slices: list[str]) -> SimCluster:
    cfg = KubeTpuConfig.load(getattr(args, "config", None),
                             getattr(args, "set", None) or [])
    cfg.backend.slice_types = slices
    if getattr(args, "real", False):
        # no platform override: a pod runs on the cards of its grant
        cfg.runtime.real_processes = True
    if getattr(args, "log_json", False):
        cfg.obs.json_logs = True   # from_config consumes the obs section
    return SimCluster.from_config(cfg)


def _run_spec(args):
    """Shared spec pipeline for apply/top/metrics: load, build, quota,
    submit, schedule (or run).  Returns the live SimCluster, or an int
    exit code on spec errors — caller must close() the cluster."""
    spec = load_spec_file(args.file)
    pods, slices = pods_from_spec(spec)
    if not pods:
        print("no pods in spec", file=sys.stderr)
        return 2
    cl = _build_cluster(args, args.slices or slices)
    for ns, q in quotas_from_spec(spec).items():
        cl.set_quota(ns, chips=q["chips"], millitpu=q["millitpu"])
    cl.submit(*pods)
    if args.schedule_only:
        cl.step()
    else:
        cl.run_to_completion(timeout_s=args.timeout)
    return cl


def cmd_apply(args) -> int:
    cl = _run_spec(args)
    if isinstance(cl, int):
        return cl
    render_pod_table(cl)
    if args.top:
        print()
        render_top(cl)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(cl.trace.to_json())
        print(f"trace written to {args.trace_out}")
    bad = [p for p in cl.api.list("Pod")
           if p.status.phase == PodPhase.FAILED]
    cl.close()
    return 1 if bad else 0


def cmd_top(args) -> int:
    args.schedule_only = True
    args.top = True
    args.trace_out = None
    return cmd_apply(args)


def cmd_demo(args) -> int:
    from kubegpu_tpu_torch.workloads.specs import ALL_CONFIGS
    if args.name not in ALL_CONFIGS:
        print(f"unknown workload {args.name!r}; try: "
              f"{', '.join(sorted(ALL_CONFIGS))}", file=sys.stderr)
        return 2
    pods, slices = ALL_CONFIGS[args.name]()
    cl = _build_cluster(args, args.slices or slices)
    cl.submit(*pods)
    if args.real:
        cl.run_to_completion(timeout_s=args.timeout)
    else:
        cl.step()
    render_pod_table(cl)
    print()
    render_top(cl)
    bad = [p for p in cl.api.list("Pod")
           if p.status.phase == PodPhase.FAILED]
    cl.close()
    return 1 if bad else 0


def cmd_bench(args) -> int:
    raise NotImplementedError(
        "bench is not ported yet: it runs the reference's benchmark "
        "harness (kubegpu_tpu/benchmark.py), which the port's benchmark "
        "brings (ROADMAP item 11a)")


def cmd_metrics(args) -> int:
    """Run a spec and dump the cluster metrics registry — the same
    content GET /metrics serves on the extender webhook, from the CLI."""
    cl = _run_spec(args)
    if isinstance(cl, int):
        return cl
    if args.format == "prometheus":
        print(cl.metrics.to_prometheus(), end="")
    else:
        print(json.dumps(cl.metrics.snapshot(), indent=2, sort_keys=True))
    bad = [p for p in cl.api.list("Pod")
           if p.status.phase == PodPhase.FAILED]   # match apply's gate
    cl.close()
    return 1 if bad else 0


def cmd_configs(args) -> int:
    from kubegpu_tpu_torch.workloads.specs import ALL_CONFIGS
    for name, fn in sorted(ALL_CONFIGS.items()):
        doc = ((fn.__doc__ or "").strip().splitlines() or [""])[0]
        print(f"{name}: {doc}")
    return 0


def cmd_slices(args) -> int:
    from kubegpu_tpu_torch.topology.mesh import TOPOLOGY_REGISTRY
    rows = [("TYPE", "MESH", "CHIPS", "HOSTS", "WRAP", "HBM/CHIP",
             "LINKS")]
    for name in sorted(TOPOLOGY_REGISTRY):
        s = TOPOLOGY_REGISTRY[name]
        sx, sy, sz = s.mesh_shape
        rows.append((name, f"{sx}x{sy}x{sz}", str(s.num_chips),
                     str(s.num_hosts),
                     "".join("T" if w else "f" for w in s.wrap),
                     f"{s.hbm_gib_per_chip:g}G",
                     "switch" if s.switched else "torus"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return 0


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubetpu", description="gang scheduler (simulated control "
        "plane) — see kubegpu_tpu_torch/cli.py for the spec format")
    sub = ap.add_subparsers(dest="verb", required=True)

    def common(p, with_file=False):
        p.add_argument("--config", help="config file (JSON/YAML)")
        p.add_argument("--set", action="append", metavar="K.EY=VAL",
                       help="dotted config override, repeatable")
        p.add_argument("--slices", nargs="+",
                       help="override cluster slice types")
        p.add_argument("--real", action="store_true",
                       help="launch real workload subprocesses, each on "
                       "the cards its grant names; on a card host with "
                       "--set backend.type=nvml (the mock's cards have "
                       "made-up UUIDs)")
        p.add_argument("--timeout", type=float, default=300.0)
        p.add_argument("--log-json", action="store_true",
                       help="structured JSON log lines on stderr")
        if with_file:
            p.add_argument("-f", "--file", required=True,
                           help="workload spec file (JSON/YAML)")

    p = sub.add_parser("apply", help="submit a spec file and run it")
    common(p, with_file=True)
    p.add_argument("--schedule-only", action="store_true",
                   help="schedule but do not execute workloads")
    p.add_argument("--top", action="store_true",
                   help="also render the slice occupancy map")
    p.add_argument("--trace-out", help="write schedule trace JSON here")
    p.set_defaults(fn=cmd_apply)

    p = sub.add_parser("top", help="schedule a spec, render occupancy only")
    common(p, with_file=True)
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("demo", help="run a named example workload")
    p.add_argument("name", help="e.g. config4 (see `configs`)")
    common(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("bench", help="not ported yet (ROADMAP item 11a)")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("metrics",
                       help="run a spec and dump the metrics registry")
    common(p, with_file=True)
    p.add_argument("--schedule-only", action="store_true",
                   help="schedule but do not execute workloads")
    p.add_argument("--format", choices=["json", "prometheus"],
                   default="json")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("slices", help="list known slice types")
    p.set_defaults(fn=cmd_slices)

    p = sub.add_parser("configs", help="list named example workloads")
    p.set_defaults(fn=cmd_configs)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
