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
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(name), sym)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}"
                           + (f" (route {route})" if route else ""))
    launches[name] += 1
    if route is not None:
        launches[f"{name}/{route}"] += 1
