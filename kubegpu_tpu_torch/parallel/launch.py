"""Start tensor-parallel ranks: one process a rank, one process group.

:class:`Gang` spawns ``tp`` processes (the ``spawn`` start method: CUDA
cannot be used in a forked child once the parent has touched it), rank r
on ``devices[r]``, and joins them into one ``torch.distributed`` group
through a ``file://`` rendezvous in a fresh directory (no TCP port for
concurrent gangs to share).  Each rank runs one torch thread and then
command after command (:meth:`Gang.call`: ``fn(state, *args)`` on every
rank, ``state`` a dict of the rank's own) until :meth:`Gang.close`, so
host state replicated across the ranks stays replicated.  Two gangs are
two worlds with two rendezvous: no collective of one ever waits on the
other.

:func:`launch` is a gang that runs ``fn(*args)`` once and ends: over
NCCL rank r takes card r; over gloo the ranks share the cards round
robin, so on one card every rank is on ``cuda:0`` (NCCL refuses two ranks
on one card, gloo moves CUDA tensors through the host); ``device="cpu"``
keeps every rank on the CPU over gloo.  It returns rank 0's result.

A command's ``fn`` must be importable by name from a module that imports
only torch and this package: each spawned rank imports it afresh.  The
results come back pickled by value (tensors included).  The ranks run
under ``PYTHONHASHSEED=0``, so a hash of a ``str`` or ``bytes`` agrees
across them.  A rank that raises or dies ends its gang: the others are
terminated and the traceback is raised in the caller as ``RuntimeError``.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
import weakref

import torch

BACKENDS = ("gloo", "nccl")


def _apply(state: dict, fn, args: tuple):
    """A :func:`launch` rank's one command: ``fn(*args)``, rank 0's result
    kept."""
    out = fn(*args)
    return out if state["rank"] == 0 else None


def launch(fn, tp: int, *args, backend: str = "gloo", device: str = "cuda",
           timeout_s: float = 1800.0):
    """Run ``fn(*args)`` on ``tp`` ranks (see the module docstring) and
    return rank 0's result.  ``backend`` is ``"gloo"`` or ``"nccl"``
    (CUDA only); ``device`` is ``"cuda"`` or ``"cpu"``.  A rank that
    raises, dies or outlives ``timeout_s`` raises ``RuntimeError`` after
    every rank has been stopped."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} not in ('cuda', 'cpu')")
    if backend == "nccl" and device == "cpu":
        raise ValueError("NCCL runs on CUDA devices only")
    if device == "cpu":
        devices = ["cpu"] * tp
    else:
        n = torch.cuda.device_count()
        devices = [f"cuda:{r if backend == 'nccl' else r % max(n, 1)}"
                   for r in range(tp)]
    gang = Gang(devices, backend=backend, timeout_s=timeout_s)
    try:
        return gang.call(_apply, fn, args)[0]
    finally:
        gang.close()


def _spawn(ctx, procs: list, tp: int, target_of) -> None:
    """Start ``tp`` daemon processes (``target_of(rank)`` gives each its
    target and args) under ``PYTHONHASHSEED=0``, appending each to
    ``procs`` as it starts."""
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        for rank in range(tp):
            target, args = target_of(rank)
            p = ctx.Process(target=target, daemon=True, args=args)
            p.start()
            procs.append(p)
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved


def _stop(procs, inboxes, rendezvous: str) -> None:
    """End ``procs``: a ``None`` command to each inbox first (a rank in
    its command loop leaves its group and exits), then, after a few
    seconds, terminate and at last kill what is still alive; remove the
    rendezvous directory."""
    for q in inboxes:
        try:
            q.put(None)
        except (OSError, ValueError):
            pass
        # a rank that is gone reads nothing: do not wait at exit to flush
        q.cancel_join_thread()
    # every result is in: a rank that is slow to exit (a card's ranks
    # have taken 30 s) is terminated
    deadline = time.monotonic() + 5.0
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join()
    shutil.rmtree(rendezvous, ignore_errors=True)


def _collect(procs, results, tp: int, timeout_s: float) -> list:
    """Every rank's unpickled result, in rank order, once every rank has
    reported; the first error, a rank that died without reporting, or the
    deadline raises."""
    deadline = time.monotonic() + timeout_s
    out, seen = [None] * tp, set()
    while len(seen) < tp:
        try:
            rank, status, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if not p.is_alive() and i not in seen]
            if dead:
                # a rank may exit right after its report (flushed before
                # it exits): drain once more
                try:
                    rank, status, value = results.get(timeout=1.0)
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
        if value is not None:
            out[rank] = pickle.loads(value)
    return out


def _gang_main(rank: int, tp: int, backend: str, device: str,
               rendezvous: str, inbox, results) -> None:
    """A gang rank: one torch thread, its device, the gang's group, then
    ``(fn, args)`` commands from ``inbox`` until ``None``, each run as
    ``fn(state, *args)`` and answered pickled by value."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if device != "cpu":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                rank=rank, world_size=tp)
        results.put((rank, "ok", None))
        state = {"rank": rank, "tp": tp, "device": device,
                 "backend": backend}
        while True:
            cmd = inbox.get()
            if cmd is None:
                break
            fn, args = cmd
            # pickled by value here: the queue's own pickler would share a
            # tensor's storage through a descriptor that dies with this rank
            out = pickle.dumps(fn(state, *args))
            del cmd, args       # drop this rank's handles on shared storage
            results.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


class Gang:
    """``len(devices)`` persistent tensor-parallel ranks (see the module
    docstring): rank r runs on ``devices[r]`` (``"cpu"`` or a card),
    joined over ``backend``: by default NCCL when the devices are distinct
    cards and gloo otherwise (ranks sharing a card, or the CPU).  :meth:`call` runs one
    function on every rank and returns every rank's result; a rank that
    raises or dies, or a call past ``timeout_s``, stops the whole gang and
    raises ``RuntimeError`` with the rank's traceback.  The arguments of a
    call reach the ranks through ``torch.multiprocessing``: a host tensor
    in shared memory, a card's tensor as a CUDA IPC handle, neither copied
    a rank.  The constructor only starts the ranks; the first call waits
    for their group, so several gangs reach their devices at once."""

    def __init__(self, devices, backend: str | None = None,
                 timeout_s: float = 1800.0):
        devs = [str(torch.device(d)) for d in devices]
        cards = [d for d in devs if d != "cpu"]
        if cards and len(cards) != len(devs):
            raise ValueError(f"a gang's devices are all CPU or all cards, "
                             f"got {devs}")
        distinct = bool(cards) and len(set(cards)) == len(cards)
        if backend is None:
            backend = "nccl" if distinct else "gloo"
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if backend == "nccl" and not distinct:
            raise ValueError(f"NCCL takes one rank a card, got {devs}")
        self.devices = devs
        self.tp = len(devs)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in devs]
        self._procs: list = []
        rdzv = tempfile.mkdtemp(prefix="tp-gang-")
        # ends the ranks if the gang is dropped without close()
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._inboxes, rdzv)
        self._ready = False
        try:
            _spawn(ctx, self._procs, self.tp, lambda rank: (
                _gang_main, (rank, self.tp, self.backend, devs[rank],
                             os.path.join(rdzv, "rdzv"), self._inboxes[rank],
                             self._results)))
        except BaseException:
            self.close()
            raise

    @property
    def alive(self) -> bool:
        return self._finalizer.alive

    def call(self, fn, *args) -> list:
        """``fn(state, *args)`` on every rank (``state`` a dict of the
        rank's own, holding ``rank``, ``tp``, ``device`` and ``backend``
        at the start); every rank's result, in rank order.  ``fn`` must be
        importable by name from a module that imports only torch and this
        package."""
        if not self.alive:
            raise RuntimeError("the gang is closed")
        try:
            if not self._ready:
                _collect(self._procs, self._results, self.tp, self.timeout_s)
                self._ready = True
            for q in self._inboxes:
                q.put((fn, args))
            return _collect(self._procs, self._results, self.tp,
                            self.timeout_s)
        except BaseException:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
            self.close()
            raise

    def close(self) -> None:
        """End every rank (idempotent)."""
        self._finalizer()
