"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C entry point, loaded with :mod:`ctypes`.  The
library lands in ``build/kernels/`` at the repository root, named by a hash
of its sources, at first use: nothing is compiled when a module is imported,
and a machine without ``nvcc`` fails loudly the first time a kernel is asked
for (there is no fallback on a CUDA tensor).

``launches`` counts kernel launches per kernel, a plain integer each; the
wrappers in :mod:`kubegpu_tpu_torch.ops` add one where they launch and
nowhere else, so a caller can show that a path went through the kernels.
A kernel with two instances (``ROUTES``) also counts each under
``"<name>/<route>"``: ``flash_fwd/tc`` and ``flash_fwd/simt``, say.

A launch made while a :class:`Graph` captures runs only when the graph is
replayed, so it is counted in ``captured`` (once per capture) and in the
graph's tally, which every :meth:`Graph.replay` adds to ``launches``:
``launches`` counts kernel executions whichever way they were issued.

The sources share ``csrc/common.cuh``; the tensor-core instances and the
paged walks also ``csrc/sm90.cuh`` (TMA, bulk copies, mbarriers, wgmma as
inline PTX); the paged ones ``csrc/paged_decode.cuh``.  A change to any
``*.cuh`` rebuilds every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream are c_void_p, ints are c_int.
# Kernels 4-6 share the split walk's (with its counters and split count),
# kernel 7 has its own (the split walk with the bias table); the four paged
# sources share csrc/paged_decode.cuh.
_PAGED_SPLIT = [_P] * 16 + [_I] * 11 + [_P]
# Kernels 1, 2 and 3 take a route (tensor cores or CUDA cores) as their
# last int.
SIGNATURES = {
    "flash_fwd": ("kubetpu_flash_fwd", [_P] * 5 + [_I] * 9 + [_P]),
    "flash_bwd_dq": ("kubetpu_flash_bwd_dq", [_P] * 7 + [_I] * 9 + [_P]),
    "flash_bwd_dkv": ("kubetpu_flash_bwd_dkv", [_P] * 8 + [_I] * 9 + [_P]),
    "paged_decode": ("kubetpu_paged_decode", _PAGED_SPLIT),
    "paged_decode_q8": ("kubetpu_paged_decode_q8", _PAGED_SPLIT),
    "paged_decode_q4": ("kubetpu_paged_decode_q4", _PAGED_SPLIT),
    "paged_decode_bias": ("kubetpu_paged_decode_bias",
                          [_P] * 15 + [_I] * 11 + [_P]),
}

# The instances of a kernel with two, by the int its C entry takes for each
ROUTES = {"flash_fwd": {"simt": 0, "tc": 1},
          "flash_bwd_dq": {"simt": 0, "tc": 1},
          "flash_bwd_dkv": {"simt": 0, "tc": 1}}

launches = {name: 0 for name in SIGNATURES}
launches.update({f"{name}/{r}": 0 for name, rs in ROUTES.items() for r in rs})
captured = dict.fromkeys(launches, 0)
_libs: dict[str, ctypes.CDLL] = {}
# the Graph being captured, if any (one capture at a time)
_capturing: Graph | None = None


def reset_launches() -> None:
    for counts in (launches, captured):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    so = _so_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), so


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together.  Returns each built kernel's compiler output
    (``-Xptxas -v``: registers, shared memory, spills); an up-to-date
    library is not rebuilt and maps to ``""``.  Raises if any build fails."""
    names = list(names or SIGNATURES)
    jobs = {n: _start_build(n) for n in names}
    logs, failed = {}, []
    for n, job in jobs.items():
        if job is None:
            logs[n] = ""
            continue
        proc, tmp, so = job
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n}:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _libs:
        build([name])
        cdll = ctypes.CDLL(str(_so_path(name)))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(cdll, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = cdll
    return _libs[name]


def call(name: str, *args, route: str | None = None) -> None:
    """Launch kernel ``name`` on the current stream and count it; raises
    on a non-zero ``cudaError_t`` from the launch.  A kernel in ``ROUTES``
    takes ``route``, passed to its C entry as one more int and counted
    under ``"<name>/<route>"`` too."""
    import torch

    sym = SIGNATURES[name][0]
    if (name in ROUTES) != (route is not None) or (
            route is not None and route not in ROUTES[name]):
        raise ValueError(f"{name}: route {route!r} does not fit its entry")
    if route is not None:
        args = (*args, ROUTES[name][route])
    stream = torch.cuda.current_stream()
    if torch.cuda.is_current_stream_capturing():
        if _capturing is None:
            raise RuntimeError(f"{name} launched under a CUDA graph capture "
                               "that is not a kernels.Graph: its replays "
                               "would go uncounted")
        counts = (captured, _capturing.tally)
    else:
        counts = (launches,)
    err = getattr(lib(name), sym)(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}"
                           + (f" (route {route})" if route else ""))
    for c in counts:
        c[name] = c.get(name, 0) + 1
        if route is not None:
            c[f"{name}/{route}"] = c.get(f"{name}/{route}", 0) + 1


def capturing() -> bool:
    """Whether a :class:`Graph` is capturing on this thread's stream."""
    import torch
    return _capturing is not None and torch.cuda.is_current_stream_capturing()


def hold(*tensors) -> None:
    """Keep ``tensors`` alive as long as the graph being captured: a
    buffer that a kernel of the graph addresses (a wrapper's static
    scratch, say) must outlive every replay, even once its owner has
    replaced it."""
    if _capturing is None:
        raise RuntimeError("hold() outside a Graph capture")
    _capturing.held.extend(tensors)


class Graph:
    """``fn`` captured once into a CUDA graph, then replayed.

    :meth:`capture` records ``fn()`` on a side stream without running it
    (whatever ``fn`` reads or writes in place is bound by address); run
    ``fn`` eagerly once before, so that libraries are loaded and static
    scratch is sized, since nothing may synchronize the host or grow a
    shared buffer under capture.  :meth:`replay` launches the graph on
    the stream it was captured for, and adds the kernel launches captured
    in it (``tally``) to ``launches``.  ``capture_s`` (``fn`` under
    capture), ``instantiate_s`` (the end of the capture and the graph's
    instantiation) and ``pool_bytes`` (device memory the capture
    reserved) say what it cost.  A failure raises: nothing falls back to
    an eager run.  Python's collector runs before the capture and not
    during it: a dropped graph that it destroyed under a capture (an
    engine freed with a reference cycle) would invalidate the capture.
    ``capture_error_mode`` is CUDA's: "global" (the default) refuses an
    unsafe call from any thread during the capture; "thread_local" only
    from the capturing one, which a function with NCCL collectives needs
    (the process group's watchdog thread queries its events meanwhile)."""

    def __init__(self, fn, capture_error_mode: str = "global"):
        self.fn = fn
        self.capture_error_mode = capture_error_mode
        self.graph = None
        self.stream = None
        self.tally: dict[str, int] = {}
        self.held: list = []
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0

    def capture(self):
        """Capture ``fn()``; returns what it returned (tensors in the
        graph's memory, rewritten by every replay)."""
        global _capturing
        import gc
        import time

        import torch
        if _capturing is not None:
            raise RuntimeError("a kernels.Graph is already capturing")
        self.stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(self.stream)
        torch.cuda.synchronize()
        gc.collect()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        _capturing = self
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(
                    capture_error_mode=self.capture_error_mode)
                t0 = time.perf_counter()
                try:
                    out = self.fn()
                except BaseException:
                    # end the broken capture so the stream is usable, and
                    # raise what broke it
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                t1 = time.perf_counter()
                graph.capture_end()
                t2 = time.perf_counter()
        finally:
            _capturing = None
            if collecting:
                gc.enable()
        self.stream.wait_stream(side)
        self.graph = graph
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        return out

    def replay(self) -> None:
        import torch
        if self.graph is None:
            raise RuntimeError("replay() before capture()")
        if torch.cuda.current_stream() != self.stream:
            raise RuntimeError("a graph replays on the stream it was "
                               "captured for: its kernels share static "
                               "scratch with that stream's eager calls")
        self.graph.replay()
        for name, n in self.tally.items():
            launches[name] += n


def graph_state(cache: dict, key: tuple, params, make,
                size: int = 4) -> tuple[dict, dict]:
    """(static state, graphs by name) of ``key``'s call shape in ``cache``,
    made by ``make()`` on its first call.  The key also holds the addresses
    of ``params``' tensors, and the entry holds the tensors, so a graph
    never outlives what it reads.  The oldest of ``size`` entries goes
    first."""
    from kubegpu_tpu_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    key = key + (tuple(p.data_ptr() for p in leaves),)
    if key not in cache:
        if len(cache) >= size:
            del cache[next(iter(cache))]
        cache[key] = (leaves, make(), {})
    return cache[key][1:]


def run_graph(fn, times: int, graphs: dict | None, name: str) -> None:
    """``fn()`` ``times`` times: eagerly without ``graphs``, else through
    the :class:`Graph` ``graphs[name]``, which the first call makes from
    one eager run (it loads the libraries and sizes the kernels' scratch)
    and a capture.  A failed capture or replay raises."""
    if graphs is None or times < 1:
        for _ in range(times):
            fn()
        return
    if name not in graphs:
        fn()
        times -= 1
        graph = Graph(fn)
        graph.capture()
        graphs[name] = graph
    for _ in range(times):
        graphs[name].replay()
