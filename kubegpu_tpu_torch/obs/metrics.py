"""The serving engine's metric helpers (counterpart of three pieces of
``kubegpu_tpu/obs/metrics.py``): the bounded histogram, :func:`percentiles`
over a plain value list with the histogram's index math, and the engine's
:class:`LiveBytesTracker`.  The Prometheus registry is not ported: the
tracker takes no registry, and the engine's ``metrics=`` knob raises."""

from __future__ import annotations

import random
from bisect import bisect_left

# Cumulative-bucket upper bounds (ms-scale latencies), as the reference's:
# each bucket counts observations <= le, and +Inf is implicit (== count).
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# Reservoir size for percentile estimation: exact below this many
# observations, a uniform reservoir sample above (seeded, so a given
# observation sequence always yields the same percentiles).
_RESERVOIR = 1024


class _Histogram:
    """Bounded-memory histogram: cumulative buckets plus a seeded
    reservoir serving :meth:`percentile`.  ``observe`` is O(log buckets)
    and memory is capped at ``_RESERVOIR`` floats; percentiles are exact
    until the cap, then a uniform sample (deterministic for a fixed
    observation sequence)."""

    __slots__ = ("_bounds", "_bucket_counts", "_count", "_sum",
                 "_reservoir", "_rng", "_sorted_cache")

    def __init__(self, bounds: tuple = DEFAULT_BUCKETS) -> None:
        self._bounds = bounds
        self._bucket_counts = [0] * (len(bounds) + 1)   # last = +Inf
        self._count = 0
        self._sum = 0.0
        self._reservoir: list[float] = []
        self._rng = random.Random(0x5EED)
        self._sorted_cache: list[float] | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self._count += 1
        self._sum += v
        # bisect_left: v exactly on a bound belongs to THAT bucket
        self._bucket_counts[bisect_left(self._bounds, v)] += 1
        if len(self._reservoir) < _RESERVOIR:
            self._reservoir.append(v)
            self._sorted_cache = None
        else:
            j = self._rng.randrange(self._count)
            if j < _RESERVOIR:
                self._reservoir[j] = v
                self._sorted_cache = None

    def percentile(self, p: float) -> float:
        vals = self._sorted_cache
        if vals is None:
            vals = self._sorted_cache = sorted(self._reservoir)
        if not vals:
            return 0.0
        k = min(len(vals) - 1,
                max(0, int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[k]

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def sum(self) -> float:
        return self._sum


class LiveBytesTracker:
    """Live state-byte accounting for the serving engine.

    The engine calls :meth:`sample` at every dispatch boundary with the
    bytes of its state tensors (pool or cache leaves plus the slot
    mirrors).  ``live`` is the latest sample and ``peak`` the largest; the
    engine reports them as ``hbm_pool_bytes`` and ``hbm_peak_bytes``."""

    def __init__(self, registry=None) -> None:
        if registry is not None:
            raise NotImplementedError(
                "a metrics registry is not ported yet (ROADMAP.md queue 1: "
                "pools, fleet and llama_serve)")
        self.live = 0
        self.peak = 0
        self.samples = 0

    def sample(self, live_bytes: int) -> None:
        self.live = int(live_bytes)
        self.peak = max(self.peak, self.live)
        self.samples += 1


def percentiles(values, ps=(50, 90, 99)) -> dict:
    """Percentile summary of a plain value list without registering a
    histogram -- the same index math as :class:`_Histogram`.  The serving
    engine's per-tick decode stall list (``ContinuousBatcher.stall_ms``)
    is summarized through it."""
    h = _Histogram()
    for v in values:
        h.observe(float(v))
    out = {"count": h.count, "mean": h.mean}
    for p in ps:
        out[f"p{int(p)}"] = h.percentile(p)
    return out
