"""Worker bootstrap for workload programs: consume the injected env
(counterpart of ``kubegpu_tpu/workloads/programs/distributed.py``).

The crishim sets ``TPU_WORKER_ID`` / ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` and the allocation's ``TPU_VISIBLE_CHIPS``,
``KUBETPU_MILLITPU``, ``KUBETPU_HBM_GIB`` and ``KUBETPU_SLICE_ID``; the names
stay the crishim's.  The port's crishim also names the granted cards by UUID
in ``CUDA_VISIBLE_DEVICES``, which the CUDA runtime reads itself.

:func:`init_from_env` turns them into one ``torch.distributed`` process
group where the pod is one worker of several, as the reference's starts
``jax.distributed``: the rendezvous is a ``TCPStore`` at the coordinator
address (worker 0 serves it), rank ``TPU_WORKER_ID`` of
``JAX_NUM_PROCESSES``, and it gives up after :data:`RENDEZVOUS_TIMEOUT_S`
(a worker whose peers never come raises).  Each worker holds one card, the
one of its grant, as ``cuda:0``; the workers tell each other their cards'
UUIDs through the store and pick the backend as
:class:`~kubegpu_tpu_torch.parallel.launch.Gang` does: NCCL when every
worker's card is distinct, gloo when two share a card (NCCL refuses that)
or on the CPU.  A worker granted several cards raises: an in-process mesh
over them is ROADMAP item 9's.  A single-worker pod needs nothing more
than the env.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass

# a gang's rendezvous gives up after this long: its workers start in one
# control-plane tick, so a peer this late is not coming
RENDEZVOUS_TIMEOUT_S = 120.0
CARD_KEY = "kubetpu/card"     # a worker's card UUID in the rendezvous store


@dataclass
class WorkerEnv:
    worker_id: int
    num_workers: int
    coordinator: str
    visible_chips: list[int]
    hostnames: list[str]
    millitpu: int | None
    hbm_gib: float | None = None   # allocated device memory (crishim-injected)
    slice_id: str = ""             # interconnect domain this worker sits in


def read_env() -> WorkerEnv:
    chips = os.environ.get("TPU_VISIBLE_CHIPS", "")
    milli = os.environ.get("KUBETPU_MILLITPU")
    hbm = os.environ.get("KUBETPU_HBM_GIB")
    return WorkerEnv(
        worker_id=int(os.environ.get("TPU_WORKER_ID", "0")),
        num_workers=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        coordinator=os.environ.get("JAX_COORDINATOR_ADDRESS", ""),
        visible_chips=[int(c) for c in chips.split(",") if c != ""],
        hostnames=[h for h in os.environ.get(
            "TPU_WORKER_HOSTNAMES", "").split(",") if h],
        millitpu=int(milli) if milli else None,
        hbm_gib=float(hbm) if hbm else None,
        slice_id=os.environ.get("KUBETPU_SLICE_ID", ""),
    )


def init_from_env(device="cuda") -> WorkerEnv:
    """The injected env of this worker; where it is one of several, join
    the gang's process group first (see the module docstring).
    ``device`` is the program's (``"cuda"`` or ``"cpu"``)."""
    env = read_env()
    if env.num_workers > 1:
        join_gang(env, device, RENDEZVOUS_TIMEOUT_S)
    return env


def single_worker_env(program: str) -> WorkerEnv:
    """The injected env of a program that runs one worker only: a pod of
    more than one raises ``NotImplementedError`` before any rendezvous."""
    env = read_env()
    if env.num_workers > 1:
        raise NotImplementedError(
            f"{program}: a pod of {env.num_workers} workers waits for "
            "multi-device support (ROADMAP.md queue 1, item 9)")
    return env


def gang_backend(cards: list[str]) -> str:
    """NCCL when every worker holds a card of its own (``cards``: each
    worker's card UUID, or ``"cpu"``), else gloo: NCCL refuses two ranks
    on one card, and runs on cards only."""
    own = "cpu" not in cards and len(set(cards)) == len(cards)
    return "nccl" if own else "gloo"


def join_gang(env: WorkerEnv, device, timeout_s: float) -> str:
    """Join the ``env.num_workers`` workers into one process group and
    return its backend (``"nccl"`` or ``"gloo"``)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("join_gang: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        if n > 1:
            raise NotImplementedError(
                f"a worker of a {env.num_workers}-worker gang sees {n} "
                "cards; one worker over several cards waits for "
                "multi-device support (ROADMAP.md queue 1, item 9)")
        torch.cuda.set_device(0)
        card = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    else:
        card = "cpu"
    host, port = env.coordinator.rsplit(":", 1)
    timeout = timedelta(seconds=timeout_s)
    if env.worker_id:
        _wait_for_coordinator(host, int(port), time.monotonic() + timeout_s)
    store = dist.TCPStore(host, int(port), env.num_workers,
                          is_master=env.worker_id == 0, timeout=timeout)
    store.set(f"{CARD_KEY}/{env.worker_id}", card)
    backend = gang_backend([store.get(f"{CARD_KEY}/{r}").decode()
                            for r in range(env.num_workers)])
    dist.init_process_group(backend, store=store, rank=env.worker_id,
                            world_size=env.num_workers, timeout=timeout)
    return backend


def _wait_for_coordinator(host: str, port: int, deadline: float) -> None:
    """Return once ``host:port`` accepts a connection; raise
    ``TimeoutError`` at ``deadline``."""
    while True:
        try:
            socket.create_connection((host, port), timeout=1.0).close()
            return
        except OSError:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"the gang's coordinator {host}:{port} did not come "
                    "up in time") from None
            time.sleep(0.1)


def leave_gang() -> None:
    """Destroy the process group :func:`init_from_env` made, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def program_device(device, program: str):
    """``device`` as a ``torch.device``; a CUDA device on a host with no
    card raises (a program runs on the card unless its caller asks for
    the CPU).  On the card the program prints one line naming what it
    sees, ``{"pod_device": {"uuid": "GPU-...", "name": ..., "count": n}}``
    (the card it runs on and the number of cards visible), so whoever
    launched it can hold that to the grant."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{program}: no CUDA device (pass "
                               "device='cpu' to run on the CPU)")
        props = torch.cuda.get_device_properties(device)
        print(json.dumps({"pod_device": {
            "uuid": f"GPU-{props.uuid}", "name": props.name,
            "count": torch.cuda.device_count()}}), flush=True)
    return device


def run_program(main) -> int:
    """``main()``'s exit code, for a program's ``python -m``.  Where the
    pod's env has ``KUBETPU_REPORT_LAUNCHES=1`` it then prints one metric
    line a kernel of the port, ``{"metric": "launches_<kernel>", "value":
    n}``, ``n`` the times this process launched it (``kernels.launches``):
    the node agent harvests them as ``workload_launches_<kernel>``, so
    whoever ran the pod can tell which hand-written kernels it ran."""
    rc = main()
    if os.environ.get("KUBETPU_REPORT_LAUNCHES") == "1":
        from kubegpu_tpu_torch import kernels
        for name in kernels.SIGNATURES:
            print(json.dumps({"metric": f"launches_{name}",
                              "value": kernels.launches[name]}), flush=True)
    return rc
