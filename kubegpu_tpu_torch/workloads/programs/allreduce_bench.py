"""All-reduce microbenchmark (counterpart of
``kubegpu_tpu/workloads/programs/allreduce_bench.py``; BASELINE.md's
"allreduce GB/s on allocated slice").

Gang-scheduled onto a node, each worker all-reduces a buffer across the
gang's process group (:func:`~kubegpu_tpu_torch.workloads.programs.
distributed.init_from_env`: NCCL on distinct cards, gloo on a shared card
or the CPU) and measures the bandwidth achieved.  On an H100 node NCCL
rides NVLink where the placement gave the gang cards of one switch; on the
CPU it checks the wiring (injection → process group → collective).

Each worker holds 4 MiB of f32 filled with ``worker_id + 1``; after one
warm-up reduce every element must equal ``n(n+1)/2``; 10 timed reduces
follow, the clock read after a synchronize.  Worker 0 prints the
reference's line (bus bandwidth ``2(n-1)/n · S / dt``)::

    {"metric": "allreduce_algo_bandwidth", "value": ..., "unit": "GiB/s",
     "devices": n, "payload_gib": ..., "step_ms": ...}

    python -m kubegpu_tpu_torch.workloads.programs.allreduce_bench

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.  Exit codes: 0, or 3 for a wrong sum.  A
worker that sees more than one card raises (ROADMAP item 9).
"""

from __future__ import annotations

import json
import sys
import time

MIB = 4.0       # a worker's buffer, MiB
ITERS = 10


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        init_from_env,
        leave_gang,
        program_device,
    )

    device = program_device(device, "allreduce_bench")
    env = init_from_env(device)
    try:
        import torch
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        n = env.num_workers
        shard_elems = int(MIB * (1 << 20) // 4)
        x = torch.full((shard_elems,), float(env.worker_id + 1),
                       dtype=torch.float32, device=device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def allreduce():
            if n > 1:
                dist.all_reduce(x)

        allreduce()     # warm-up: the communicator's first use
        if not bool((x == n * (n + 1) / 2).all()):
            print(f"FAIL: all-reduce sum {x[0].item()} != {n * (n + 1) / 2}",
                  file=sys.stderr)
            return 3
        sync()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            allreduce()
        sync()
        dt = (time.perf_counter() - t0) / ITERS
        # the standard busBW convention: S = the reduced buffer each rank
        # ends with; a ring moves 2(n-1)/n * S per link
        payload_gib = shard_elems * 4 / (1 << 30)
        algo_gbs = (2 * (n - 1) / max(n, 1)) * payload_gib / dt
        if env.worker_id == 0:
            print(json.dumps({
                "metric": "allreduce_algo_bandwidth",
                "value": round(algo_gbs, 3),
                "unit": "GiB/s",
                "devices": n,
                "payload_gib": round(payload_gib, 4),
                "step_ms": round(dt * 1e3, 3),
            }), flush=True)
        return 0
    finally:
        leave_gang()


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
