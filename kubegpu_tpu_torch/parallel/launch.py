"""Start tensor-parallel ranks: one process a rank, one process group.

:func:`launch` spawns ``tp`` processes (the ``spawn`` start method: CUDA
cannot be used in a forked child once the parent has touched it), joins
them into one ``torch.distributed`` group through a ``file://``
rendezvous in a fresh directory (no TCP port for concurrent launches to
share), runs ``fn(*args)`` in each and returns rank 0's result.  Each rank
runs one torch thread and owns a device: over NCCL rank r takes card r;
over gloo the ranks share the cards round robin, so on one card every rank
is on ``cuda:0`` (NCCL refuses two ranks on one card, gloo moves CUDA
tensors through the host).  ``device="cpu"`` keeps every rank on the CPU
over gloo.

``fn`` must be importable by name from a module that imports only torch
and this package: each spawned rank imports it afresh.  Rank 0's result
comes back pickled by value (tensors included).  The launcher fixes
``PYTHONHASHSEED`` for the ranks, so a hash of a ``str`` or ``bytes``
agrees across them.  A rank that raises ends the launch: the others are
terminated and the traceback is raised here.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback

import torch

BACKENDS = ("gloo", "nccl")


def _rank_main(rank: int, tp: int, backend: str, device: str,
               rendezvous: str, fn, args: tuple, results) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if device != "cpu":
            n = torch.cuda.device_count()
            torch.cuda.set_device(rank if backend == "nccl" else rank % n)
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                rank=rank, world_size=tp)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # pickled by value here: the queue's own pickler would share a
        # tensor's storage through a descriptor that dies with this rank
        results.put((rank, "ok", pickle.dumps(out) if rank == 0 else None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def launch(fn, tp: int, *args, backend: str = "gloo", device: str = "cuda",
           timeout_s: float = 1800.0):
    """Run ``fn(*args)`` on ``tp`` ranks (see the module docstring) and
    return rank 0's result.  ``backend`` is ``"gloo"`` or ``"nccl"``
    (CUDA only); ``device`` is ``"cuda"`` or ``"cpu"``.  A rank that
    raises, dies or outlives ``timeout_s`` raises ``RuntimeError`` after
    every rank has been stopped."""
    import torch.multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} not in ('cuda', 'cpu')")
    if backend == "nccl" and device == "cpu":
        raise ValueError("NCCL runs on CUDA devices only")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    procs = []
    with tempfile.TemporaryDirectory(prefix="tp-rdzv-") as tmp:
        try:
            for rank in range(tp):
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    rank, tp, backend, device, os.path.join(tmp, "rdzv"),
                    fn, args, results))
                p.start()
                procs.append(p)
        finally:
            if saved is None:
                os.environ.pop("PYTHONHASHSEED", None)
            else:
                os.environ["PYTHONHASHSEED"] = saved
        try:
            return _collect(procs, results, tp, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, tp: int, timeout_s: float):
    """Rank 0's result once every rank has reported; the first error, a
    rank that died without reporting, or the deadline raises."""
    deadline = time.monotonic() + timeout_s
    out, seen = None, set()
    while len(seen) < tp:
        try:
            rank, status, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if not p.is_alive() and i not in seen]
            if dead:
                # a rank may exit right after its report: drain once more
                try:
                    rank, status, value = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"tp rank(s) {dead} exited without a result "
                        f"(exit codes {[procs[i].exitcode for i in dead]})"
                    ) from None
            elif time.monotonic() > deadline:
                raise RuntimeError(f"tp launch passed {timeout_s} s")
            else:
                continue
        if status == "error":
            raise RuntimeError(f"tp rank {rank} failed:\n{value}")
        seen.add(rank)
        if rank == 0:
            out = pickle.loads(value)
    return out
