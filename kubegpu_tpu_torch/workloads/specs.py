"""The five BASELINE.json acceptance configs as submittable pod sets —
the user surface (counterpart of ``kubegpu_tpu/workloads/specs.py``;
reference: ``example/`` YAML applied with kubectl, SURVEY.md §3 "Example
workloads").

Each builder returns (pods, expected_cluster) so tests/CLI can submit the
workload to a ``SimCluster`` of the right node types and watch it run
end-to-end through schedule → inject → execute.  The pods ask what the
reference's ask and run the port's programs.  A reference slice type maps
to the H100 nodes with the same cards a host: ``v4-8`` (one host of 4
chips) to one ``h100-sxm-4`` node, ``v5e-16`` (four such hosts) to four.
A gang of more cards than a node holds therefore spans nodes: configs 4
and 5 ask for that (``multislice``) where the reference's one v5e-16 slice
needed no such leave.  Their program, ``llama_pjit``, refuses a worker
over several cards (the tp axis: ROADMAP item 9), so they schedule, and
with ``demo --real`` their pods fail saying so.
"""

from __future__ import annotations

import sys

from kubegpu_tpu_torch.cluster import tpu_pod
from kubegpu_tpu_torch.kubemeta import GangSpec, Pod

PY = sys.executable or "python"
# the reference's slice types, as the H100 nodes with as many cards a host
V4_8 = ["h100-sxm-4"]
V5E_16 = ["h100-sxm-4"] * 4


def _prog(module: str) -> list[str]:
    return [PY, "-m", f"kubegpu_tpu_torch.workloads.programs.{module}"]


def config1_cpu_mnist() -> tuple[list[Pod], list[str]]:
    """Single-pod torch-MNIST, 0-device request (CPU fallback path)."""
    return [tpu_pod("mnist-cpu", chips=0, command=_prog("mnist_torch"))], \
        list(V4_8)


def config2_resnet_1chip() -> tuple[list[Pod], list[str]]:
    """Single-pod JAX ResNet requesting 1 TPU chip.

    Here a torch ResNet on the one card of its grant."""
    return [tpu_pod("resnet-1chip", chips=1,
                    command=_prog("resnet_single"),
                    env={"KUBETPU_EXPECT_CHIPS": "1"})], list(V4_8)


def config3_dp_gang(steps: int = 2) -> tuple[list[Pod], list[str]]:
    """4-pod data-parallel gang on one v4-8 host (intra-host ICI).

    Here four workers of one ``torch.distributed`` group on one node's
    NVSwitch."""
    pods = [
        tpu_pod(f"dp-{i}", chips=1,
                gang=GangSpec(name="dp-mnist", size=4, index=i),
                mesh_axes={"dp": 4},
                command=_prog("llama_pjit"),
                env={"LLAMA_STEPS": str(steps)})
        for i in range(4)
    ]
    return pods, list(V4_8)


def config4_llama_v5e16(steps: int = 2) -> tuple[list[Pod], list[str]]:
    """Multi-host JAX pjit Llama on v5e-16 (4 hosts × 4 chips, dp×tp).

    Here four nodes of 4 cards, a pod a node (multislice); each worker's
    tp axis over its 4 cards waits for ROADMAP item 9."""
    pods = [
        tpu_pod(f"llama-{i}", chips=4,
                gang=GangSpec(name="llama-8b", size=4, index=i),
                mesh_axes={"dp": 4, "tp": 4},
                # Llama-3-8B sharded 4-way tp: ~4 GiB weights + optimizer
                # + activations per chip; declared so HBM-aware admission
                # is exercised end-to-end
                hbm_gib=8.0, multislice=True,
                command=_prog("llama_pjit"),
                env={"LLAMA_STEPS": str(steps)})
        for i in range(4)
    ]
    return pods, list(V5E_16)


def config5_multitenant() -> tuple[list[Pod], list[str]]:
    """Two co-tenant jobs: fractional-chip pods + a slice gang
    (bin-packing).

    Here the fractional pods share one card; the gang's two pods take a
    node each (multislice)."""
    pods = [
        tpu_pod("tenant-a-frac", millitpu=400,
                command=_prog("resnet_single")),
        tpu_pod("tenant-a-frac2", millitpu=500,
                command=_prog("resnet_single")),
    ]
    pods += [
        tpu_pod(f"tenant-b-{i}", chips=4,
                gang=GangSpec(name="tenant-b", size=2, index=i),
                mesh_axes={"dp": 2, "tp": 4}, multislice=True,
                command=_prog("llama_pjit"),
                env={"LLAMA_STEPS": "2"})
        for i in range(2)
    ]
    return pods, list(V5E_16)


def allreduce_gang(n_pods: int = 4,
                   slice_type: str = "h100-sxm-4"
                   ) -> tuple[list[Pod], list[str]]:
    """The ICI-allreduce microbenchmark gang (north-star metric #2)."""
    pods = [
        tpu_pod(f"allreduce-{i}", chips=1,
                gang=GangSpec(name="allreduce", size=n_pods, index=i),
                mesh_axes={"dp": n_pods},
                command=_prog("allreduce_bench"))
        for i in range(n_pods)
    ]
    return pods, [slice_type]


def t5_seq2seq(slice_type: str = "h100-sxm-4"
               ) -> tuple[list[Pod], list[str]]:
    """Encoder-decoder family on one chip (the seq2seq counterpart of
    config2's single-chip training)."""
    pods = [tpu_pod("t5", chips=1, command=_prog("t5_train"),
                    env={"T5_STEPS": "3"})]
    return pods, [slice_type]


def llama_serving(slice_type: str = "h100-sxm-4"
                  ) -> tuple[list[Pod], list[str]]:
    """Serving as a schedulable workload: a 1-chip pod runs KV-cache
    decode and reports its tokens/s as a harvestable metric line."""
    pods = [tpu_pod("llama-serve", chips=1, command=_prog("llama_serve"),
                    env={"SERVE_STEPS": "16"},
                    workload="serving")]
    return pods, [slice_type]


def tp_serving(tp: int = 4, dp: int = 1, slice_type: str = "h100-sxm-4",
               nodes: int = 4) -> tuple[list[Pod], list[str]]:
    """MULTI-CHIP serving: one pod asks for a dp x tp chip block and
    runs the mesh-sharded continuous-batching engine (page pool split
    over KV heads across the tp ring, dp independent replicas behind
    one queue).  The gang request carries the tp degree in its mesh
    axes AND the serving workload kind, so topology scoring sees a
    serving slice.  The reference's v5e-16 is ``nodes`` nodes here; the
    pod's block sits on one of them."""
    pods = [tpu_pod(
        "tp-serve", chips=dp * tp,
        mesh_axes={"dp": dp, "tp": tp},
        workload="serving",
        command=_prog("llama_serve"),
        env={"SERVE_MODE": "continuous", "SERVE_TP": str(tp),
             "SERVE_DP": str(dp), "SERVE_STEPS": "16"})]
    return pods, [slice_type] * nodes


ALL_CONFIGS = {
    "config1": config1_cpu_mnist,
    "config2": config2_resnet_1chip,
    "config3": config3_dp_gang,
    "config4": config4_llama_v5e16,
    "config5": config5_multitenant,
    "allreduce": allreduce_gang,
    "t5": t5_seq2seq,
    "serve": llama_serving,
    "tp_serve": tp_serving,
}
