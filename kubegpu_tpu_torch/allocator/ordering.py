"""Logical-device ordering: map allocated chips to mesh positions (copied
from ``kubegpu_tpu/allocator/ordering.py``).

Placement alone doesn't determine collective bandwidth — the *order* in
which chips are assigned to logical mesh coordinates does (SURVEY.md §8
"Worker identity wiring": ordering must match mesh coords or pjit layouts
silently degrade).  This module picks, for a placement and a workload's
logical axes, the chip order that maximizes weighted ring locality; it is
KubeTPU's counterpart of ``jax.experimental.mesh_utils.create_device_mesh``
run at *schedule time*, so TPU_WORKER_ID assignment already reflects it.

Strategies tried (cheap, exact evaluation over each):
- grid: logical axes mapped straight onto physical axes (row-major)
- snake folds: fold one logical axis through two or more physical rows so
  its ring closes into a physical cycle even on unwrapped meshes
All candidates are scored with the same honest traffic model the scheduler
reports, and the argmax wins.
"""

from __future__ import annotations

import functools
import itertools

from kubegpu_tpu_torch.allocator import _native
from kubegpu_tpu_torch.topology.locality import (
    ici_locality,
    resolve_axis_weights,
    traffic_pairs_for_mesh_axes,
)
from kubegpu_tpu_torch.topology.mesh import Coord, TpuTopology
from kubegpu_tpu_torch.topology.slices import Placement


_eval_order_memo: dict = {}


def evaluate_order(
    topo: TpuTopology,
    order: list[Coord],
    axes: dict[str, int],
    axis_weights: dict[str, float] | None = None,
    bad_links: set[tuple[Coord, Coord]] | None = None,
) -> float:
    """Weighted ICI locality of a candidate logical order.

    ``bad_links`` (failed ICI links) force the slow Python path — faults
    are rare, and correctness of avoiding a dead link beats the native
    fast path's speed.  The fault-free path is pure geometry and
    memoized (same orders recur across slices and passes); the
    native-path flag keys the memo so parity tests compare real runs.
    """
    axis_weights = resolve_axis_weights(axes, axis_weights)
    if not bad_links:
        key = (topo.spec.name, topo.spec.mesh_shape, topo.spec.wrap,
               topo.spec.host_block, topo.spec.switched, tuple(order),
               tuple(axes.items()), tuple(sorted(axis_weights.items())),
               _native.enabled())
        hit = _eval_order_memo.get(key)
        if hit is not None:
            return hit
        score = _native.eval_order_native(topo, order, axes, axis_weights)
        if score is None:
            score = ici_locality(
                topo, traffic_pairs_for_mesh_axes(order, axes,
                                                  axis_weights))
        if len(_eval_order_memo) >= 16384:
            _eval_order_memo.clear()
        _eval_order_memo[key] = score
        return score
    tm = traffic_pairs_for_mesh_axes(order, axes, axis_weights)
    return ici_locality(topo, tm, bad_links)


def _grid_orders(placement: Placement) -> list[list[Coord]]:
    """Row-major orders over each permutation of the placement's axes."""
    sx, sy, sz = placement.shape
    ox, oy, oz = placement.origin
    coords = placement.coords  # row-major (z fastest) already
    orders = []
    dims = [sx, sy, sz]
    for perm in set(itertools.permutations((0, 1, 2))):
        order = []
        ranges = [range(dims[perm[0]]), range(dims[perm[1]]),
                  range(dims[perm[2]])]
        for i in ranges[0]:
            for j in ranges[1]:
                for k in ranges[2]:
                    off = [0, 0, 0]
                    off[perm[0]], off[perm[1]], off[perm[2]] = i, j, k
                    order.append(coords[
                        off[0] * sy * sz + off[1] * sz + off[2]])
        orders.append(order)
    return orders


def _snake_orders(placement: Placement) -> list[list[Coord]]:
    """Boustrophedon folds: reverse every other row along one axis so
    consecutive logical indices stay physically adjacent, and the full
    sequence forms a closed cycle when the folded axis has even length."""
    sx, sy, sz = placement.shape
    coords = placement.coords
    orders = []
    if sz == 1:  # 2D cases (v5e): snake over x with rows of y, and transpose
        grid = [[coords[x * sy * sz + y * sz] for y in range(sy)]
                for x in range(sx)]
        snake_xy = []
        for x in range(sx):
            row = grid[x] if x % 2 == 0 else list(reversed(grid[x]))
            snake_xy.extend(row)
        orders.append(snake_xy)
        snake_yx = []
        for y in range(sy):
            col = [grid[x][y] for x in range(sx)]
            if y % 2 == 1:
                col.reverse()
            snake_yx.extend(col)
        orders.append(snake_yx)
    return orders


def _closed_cycle_orders(placement: Placement) -> list[list[Coord]]:
    """Hamiltonian *cycles* over 2D placements (exists when either
    dimension is even): boustrophedon through columns 1..n-1 then return up
    column 0.  Closes the all-chips ring (pure-DP default) at 100% ICI
    locality even on unwrapped meshes — a snake alone leaves the wrap pair
    several hops apart."""
    sx, sy, sz = placement.shape
    if sz != 1:
        return []
    coords = placement.coords

    def at(x: int, y: int) -> Coord:
        return coords[x * sy + y]

    orders = []
    if sx >= 2 and sy >= 2 and sx % 2 == 0:
        # rows 0..sx-1 snake within columns 1..sy-1, return up column 0
        o = [at(0, y) for y in range(sy)]  # row 0: col 0..sy-1
        for x in range(1, sx):
            ys = range(sy - 1, 0, -1) if x % 2 == 1 else range(1, sy)
            o.extend(at(x, y) for y in ys)
        o.extend(at(x, 0) for x in range(sx - 1, 0, -1))
        orders.append(o)
    if sx >= 2 and sy >= 2 and sy % 2 == 0:  # transpose variant
        o = [at(x, 0) for x in range(sx)]
        for y in range(1, sy):
            xs = range(sx - 1, 0, -1) if y % 2 == 1 else range(1, sx)
            o.extend(at(x, y) for x in xs)
        o.extend(at(0, y) for y in range(sy - 1, 0, -1))
        orders.append(o)
    return orders


@functools.lru_cache(maxsize=4096)
def candidate_orders(placement: Placement) -> list[list[Coord]]:
    """Pure geometry of a (frozen, hashable) placement — memoized because
    the same placements recur across slices and scheduling passes.
    Callers must not mutate the returned orders."""
    seen: set[tuple] = set()
    out: list[list[Coord]] = []
    for o in (_grid_orders(placement) + _snake_orders(placement)
              + _closed_cycle_orders(placement)):
        key = tuple(o)
        if key not in seen:
            seen.add(key)
            out.append(o)
    return out


def best_logical_order(
    topo: TpuTopology,
    placement: Placement,
    axes: dict[str, int] | None,
    axis_weights: dict[str, float] | None = None,
) -> tuple[list[Coord], float]:
    """Best (order, locality) for the placement under the workload's axes.

    With no declared axes, models the default: one allreduce ring over all
    chips (pure DP), which snake orders close into a physical cycle.
    """
    if axes is None:
        axes = {"dp": placement.num_chips}
    best, best_score = None, -1.0
    for order in candidate_orders(placement):
        s = evaluate_order(topo, order, axes, axis_weights)
        if s > best_score:
            best, best_score = order, s
    assert best is not None
    return best, best_score
