"""Worker bootstrap for workload programs: consume the injected env
(counterpart of ``kubegpu_tpu/workloads/programs/distributed.py``).

The crishim sets ``TPU_WORKER_ID`` / ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` and the allocation's ``TPU_VISIBLE_CHIPS``,
``KUBETPU_MILLITPU``, ``KUBETPU_HBM_GIB`` and ``KUBETPU_SLICE_ID``; the names
stay the crishim's.  :func:`init_from_env` reads them; a single-worker pod
needs nothing more.  A pod of more than one worker raises: the port has no
multi-device runtime yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


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


def init_from_env() -> WorkerEnv:
    """The injected env of this worker (nothing to start for a
    single-worker pod).  More than one worker raises
    ``NotImplementedError``: the reference starts ``jax.distributed``
    there, and the port's multi-device runtime is not written yet."""
    env = read_env()
    if env.num_workers > 1:
        raise NotImplementedError(
            f"a pod of {env.num_workers} workers is not ported yet "
            "(ROADMAP.md queue 1: multi-device)")
    return env


def program_device(device, program: str):
    """``device`` as a ``torch.device``; a CUDA device on a host with no
    card raises (a program runs on the card unless its caller asks for
    the CPU)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{program}: no CUDA device (pass device='cpu' "
                           "to run on the CPU)")
    return device
