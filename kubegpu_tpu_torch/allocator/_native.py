"""ctypes bindings for the port's C++ allocator core
(``csrc/allocator_core.cpp``; counterpart of
``kubegpu_tpu/allocator/_native.py``).

The core is host code: it compiles with the host's C++ compiler (``$CXX``,
default ``c++``; ``CXX_FLAGS``) into ``build/native/libktpu_alloc-<hash>.so``
at the repository root, the hash taken over the compiler, its flags and the
source, at first use, as :mod:`kubegpu_tpu_torch.kernels` builds the CUDA
sources: nothing is built when a module is imported, and nothing is written
into the source tree.

No fail-soft: where the reference's ``get_lib`` returns ``None`` on any
build or load error and every call site then quietly takes Python, a failed
build or load here raises ``RuntimeError`` with the compiler's output.  Two
routes to the Python paths stay, as the reference has them:

- ``KUBETPU_NO_NATIVE=1`` in the environment, read at every call: every
  entry returns ``None`` (the parity tests' switch);
- an entry the core refuses, which then returns ``None``: placements on a
  mesh of more than 512 cells (the dedup key's width), and a locality
  order with a coord off the mesh (a multislice pair).  Each such refusal
  adds one to ``fallbacks[<entry>]``.

The entries take and return what the reference's do; the core also knows
switched nodes (``TopologySpec.switched``): ``eval_order_native`` and
``connected_order_native`` pass the flag and the host block along.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import itertools
import os
import subprocess
import tempfile
from pathlib import Path

from kubegpu_tpu_torch.topology.mesh import Coord, TpuTopology

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "allocator_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")

# refusals of the core that sent a call to the Python path, by entry
fallbacks = {name: 0 for name in (
    "find_free_placements", "rank_free_placements", "eval_order",
    "orient_rings", "align_units", "connected_order")}

_lib: ctypes.CDLL | None = None


def enabled() -> bool:
    """False where ``KUBETPU_NO_NATIVE`` asks for the Python paths."""
    return not os.environ.get("KUBETPU_NO_NATIVE")


def cxx() -> str:
    return os.environ.get("CXX") or "c++"


def so_path() -> Path:
    h = hashlib.sha256(" ".join((cxx(), *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libktpu_alloc-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the core unless its library is up to date; returns the
    compiler's output (``""`` when nothing was built).  Raises
    ``RuntimeError`` with that output if the compiler fails or is
    missing."""
    so = so_path()
    if so.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build the allocator core: "
                           f"{' '.join(cmd)}: {exc}") from exc
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the allocator core failed to build "
                           f"({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, so)
    return res.stderr


def get_lib() -> ctypes.CDLL | None:
    """The loaded core, built on first use; ``None`` only under
    ``KUBETPU_NO_NATIVE``.  A failed build or load raises."""
    global _lib
    if not enabled():
        return None
    if _lib is not None:
        return _lib
    build()
    try:
        lib = ctypes.CDLL(str(so_path()))
    except OSError as exc:
        raise RuntimeError(f"cannot load the allocator core: {exc}") from exc
    i32, u8p, i32p = ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), \
        ctypes.POINTER(ctypes.c_int32)
    f64, f64p = ctypes.c_double, ctypes.POINTER(ctypes.c_double)
    mesh = [i32] * 6
    for fn, restype, argtypes in (
            ("ktpu_find_free_placements", i32,
             mesh + [u8p, i32, i32, i32, i32, i32, i32p, i32p]),
            ("ktpu_eval_order", f64,
             mesh + [i32] * 4 + [i32p, i32, i32p, f64p, i32]),
            ("ktpu_fragmentation_score", f64, mesh + [u8p, i32p, i32]),
            ("ktpu_orient_rings", i32, [i32p, i32p, i32p, i32, i32, i32p]),
            ("ktpu_align_units", i32, [i32p, i32p, i32, i32, i32p]),
            ("ktpu_connected_order", i32,
             mesh + [i32, u8p] + [i32] * 6 + [i32p]),
            ("ktpu_rank_free_placements", i32,
             mesh + [u8p, i32, i32, i32, i32, i32, i32p, i32p, f64p])):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    _lib = lib
    return _lib


def available() -> bool:
    """Build and load the core now (a daemon's preload, so the first
    decision does not pay for it); False under ``KUBETPU_NO_NATIVE``."""
    return get_lib() is not None


# -- marshalling helpers ----------------------------------------------------

def _mesh_args(topo: TpuTopology) -> tuple[int, ...]:
    (mx, my, mz), (wx, wy, wz) = topo.spec.mesh_shape, topo.spec.wrap
    return mx, my, mz, int(wx), int(wy), int(wz)


def _occupancy_mask(topo: TpuTopology, occupied: set[Coord]) -> ctypes.Array:
    mx, my, mz = topo.spec.mesh_shape
    buf = (ctypes.c_uint8 * (mx * my * mz))()
    for (x, y, z) in occupied:
        if 0 <= x < mx and 0 <= y < my and 0 <= z < mz:
            buf[(x * my + y) * mz + z] = 1
    return buf


def occupancy_mask(topo: TpuTopology, occupied: set[Coord]):
    """Prebuilt occupancy buffer for threading ONE O(chips) mask build
    through a whole per-slice search (shape enumeration + frag ranking
    + connected fallback all take it).  None under
    ``KUBETPU_NO_NATIVE``."""
    if get_lib() is None:
        return None
    return _occupancy_mask(topo, occupied)


def _coords_array(coords) -> ctypes.Array:
    """Coord iterable → int32 buffer, in one ``array`` construction over
    a C-level chain."""
    flat = array.array("i", itertools.chain.from_iterable(coords))
    return (ctypes.c_int32 * len(flat)).from_buffer(flat)


def _placements(shape: Coord, n: int, origins, coords) -> list:
    from kubegpu_tpu_torch.topology.slices import Placement
    vol = shape[0] * shape[1] * shape[2]
    out = []
    for i in range(n):
        base = i * vol * 3
        cs = tuple((coords[base + j * 3], coords[base + j * 3 + 1],
                    coords[base + j * 3 + 2]) for j in range(vol))
        out.append(Placement(origin=(origins[i * 3], origins[i * 3 + 1],
                                     origins[i * 3 + 2]),
                             shape=shape, coords=cs))
    return out


def _refused(entry: str) -> None:
    fallbacks[entry] += 1


# -- entry points (None = take the Python path) -----------------------------

def find_free_placements_native(
    topo: TpuTopology, occupied: set[Coord], shape: Coord,
    limit: int | None, mask=None):
    lib = get_lib()
    if lib is None:
        return None
    sx, sy, sz = shape
    vol = sx * sy * sz
    if vol == 0:
        return []
    # worst-case placements = product of per-axis origin counts
    max_out = 1
    for dim, size, wrap in zip(topo.spec.mesh_shape, shape, topo.spec.wrap):
        max_out *= dim if (wrap and dim > 2 and size < dim) else max(
            dim - size + 1, 0)
    if max_out == 0:
        return []
    occ = mask if mask is not None else _occupancy_mask(topo, occupied)
    origins = (ctypes.c_int32 * (max_out * 3))()
    coords = (ctypes.c_int32 * (max_out * vol * 3))()
    n = lib.ktpu_find_free_placements(
        *_mesh_args(topo), occ, sx, sy, sz,
        0 if limit is None else limit, max_out, origins, coords)
    if n < 0:   # the mesh is too large for the native key
        _refused("find_free_placements")
        return None
    return _placements(shape, n, origins, coords)


def rank_free_placements_native(
    topo: TpuTopology, occupied: set[Coord], shape: Coord,
    limit: int | None, k: int, mask=None):
    """Fused enumerate + frag-rank: returns the top-``k`` free
    placements of ``shape`` as ``[(frag, Placement), ...]`` sorted frag
    descending (ties in enumeration order, as the Python rank-then-
    truncate), or None for the Python path."""
    lib = get_lib()
    if lib is None or k <= 0:
        return None
    sx, sy, sz = shape
    vol = sx * sy * sz
    if vol == 0:
        return []
    occ = mask if mask is not None else _occupancy_mask(topo, occupied)
    origins = (ctypes.c_int32 * (k * 3))()
    coords = (ctypes.c_int32 * (k * vol * 3))()
    frags = (ctypes.c_double * k)()
    n = lib.ktpu_rank_free_placements(
        *_mesh_args(topo), occ, sx, sy, sz,
        0 if limit is None else limit, k, origins, coords, frags)
    if n < 0:
        _refused("rank_free_placements")
        return None
    return list(zip(frags[:n], _placements(shape, n, origins, coords)))


def eval_order_native(
    topo: TpuTopology, order: list[Coord], axes: dict[str, int],
    axis_weights: dict[str, float] | None):
    lib = get_lib()
    if lib is None:
        return None
    # cross-mesh coords (DCN pairs) only arise in multi-slice scoring,
    # which stays on the python path
    if not all(topo.has_coord(c) for c in order):
        _refused("eval_order")
        return None
    names = list(axes.keys())
    sizes = (ctypes.c_int32 * len(names))(*[axes[k] for k in names])
    w = axis_weights or {}
    weights = (ctypes.c_double * len(names))(
        *[float(w.get(k, 1.0)) for k in names])
    res = lib.ktpu_eval_order(
        *_mesh_args(topo), int(topo.spec.switched), *topo.spec.host_block,
        _coords_array(order), len(order), sizes, weights, len(names))
    if res < 0:
        raise ValueError(f"mesh axes {axes} ≠ {len(order)} chips")
    return res


def _flatten_options(options: list[list[list[Coord]]]) -> ctypes.Array:
    return _coords_array(itertools.chain.from_iterable(
        itertools.chain.from_iterable(options)))


def orient_rings_native(options: list[list[list[Coord]]],
                        close: bool) -> list[Coord] | None:
    """Native Viterbi over per-block orientation options (gang.py
    ``_orient_rings``).  ``options[b]`` is block b's orientation list."""
    lib = get_lib()
    if lib is None or not options:
        return None
    n_blocks = len(options)
    n_opts = (ctypes.c_int32 * n_blocks)(*[len(o) for o in options])
    opt_len = (ctypes.c_int32 * n_blocks)(*[len(o[0]) for o in options])
    choice = (ctypes.c_int32 * n_blocks)()
    if lib.ktpu_orient_rings(_flatten_options(options), n_opts, opt_len,
                             n_blocks, int(close), choice) != 0:
        _refused("orient_rings")
        return None
    out: list[Coord] = []
    for b in range(n_blocks):
        out.extend(options[b][choice[b]])
    return out


def align_units_native(options: list[list[list[Coord]]]
                       ) -> list[Coord] | None:
    """Native Viterbi ring alignment (gang.py ``_align_units``):
    ``options[u]`` is unit u's orientation-variant list (all variants the
    same length).  Returns the assembled coord sequence or None for the
    Python path."""
    lib = get_lib()
    if lib is None or len(options) < 2:
        return None
    n_units = len(options)
    n_opts = (ctypes.c_int32 * n_units)(*[len(o) for o in options])
    choice = (ctypes.c_int32 * n_units)()
    if lib.ktpu_align_units(_flatten_options(options), n_opts,
                            len(options[0][0]), n_units, choice) != 0:
        _refused("align_units")
        return None
    out: list[Coord] = []
    for u in range(n_units):
        out.extend(options[u][choice[u]])
    return out


def connected_order_native(
    topo: TpuTopology, blocked: set[Coord], total: int,
    chips_per_pod: int, num_pods: int, mask=None
) -> tuple[bool, list[Coord] | None] | None:
    """Native connected-region fallback search (gang.py
    ``_connected_candidate``): returns (True, order) with the chunked
    chip order, (False, None) when provably no start works, or None for
    the Python path."""
    lib = get_lib()
    if lib is None:
        return None
    occ = mask if mask is not None else _occupancy_mask(topo, blocked)
    out = (ctypes.c_int32 * (total * 3))()
    rc = lib.ktpu_connected_order(
        *_mesh_args(topo), int(topo.spec.switched), occ,
        *topo.spec.host_block, total, chips_per_pod, num_pods, out)
    if rc == 1:
        return False, None
    if rc != 0:
        _refused("connected_order")
        return None
    return True, [(out[i * 3], out[i * 3 + 1], out[i * 3 + 2])
                  for i in range(total)]


def fragmentation_score_native(
    topo: TpuTopology, occupied: set[Coord], coords: tuple[Coord, ...]):
    scorer = frag_scorer_native(topo, occupied)
    if scorer is None:
        return None
    return scorer(coords)


def frag_scorer_native(topo: TpuTopology, occupied: set[Coord],
                       mask=None):
    """Mask-reusing variant for scoring MANY placements against one
    occupancy set: the O(chips) occupancy-mask build happens once, not
    per placement."""
    lib = get_lib()
    if lib is None:
        return None
    args = _mesh_args(topo)
    occ = mask if mask is not None else _occupancy_mask(topo, occupied)

    def score(coords) -> float:
        return lib.ktpu_fragmentation_score(
            *args, occ, _coords_array(coords), len(coords))
    return score
