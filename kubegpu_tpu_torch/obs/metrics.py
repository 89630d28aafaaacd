"""Counter / gauge / histogram registry with JSON and Prometheus export
(counterpart of ``kubegpu_tpu/obs/metrics.py``, copied: the port imports
nothing of the reference package).  The serving engine and its pools feed
it when given a ``metrics=`` registry; its text format, its ``# HELP``
lines and its metric names are the reference's, name for name.  Also the
engine's bounded histogram, :func:`percentiles` and
:class:`LiveBytesTracker`, and :func:`parse_prometheus`,
:func:`documented_names` and :func:`serve_prometheus`; and
:data:`global_registry`, the process-wide registry the daemons publish
(the apiserver's ``/metrics`` reads it).

METRICS TABLE — every metric name the code observes.  tier-1
(``tests/test_obs_spans.py``) greps the source for literal
``observe/inc/set_gauge`` names and asserts each appears below, so a
new metric without a table row fails before review, not after.

Scheduler (DeviceScheduler / allocator):

==============================  =========  ============================
name                            kind       meaning
==============================  =========  ============================
``schedule_latency_ms``         histogram  one gang-schedule decision
                                           wall (p50 = north-star #1)
``allocation_locality``         gauge      locality score of the last
                                           placed gang
``last_allocation_locality``    gauge      alias kept for dashboards
``gangs_scheduled``             counter    gangs placed
``gangs_failed``                counter    gangs that found no placement
``gangs_preempted``             counter    victim gangs evicted by
                                           priority preemption
``gangs_migrated``              counter    gangs moved by defrag
``gangs_evicted``               counter    gangs evicted on device fault
``schedule_unschedulable``      counter    decisions ending unplaceable
``schedule_invalid``            counter    malformed/oversized asks
``schedule_quota_denied``       counter    namespace quota rejections
``bind_conflict_retries``       counter    bind-time rv conflicts
                                           retried
``bind_conflict_requeued``      counter    binds requeued after retry
                                           budget
``serving_spec_acceptance``     gauge      cluster-mean draft
                                           acceptance harvested from
                                           serve pods
``serving_goodput_tokens_per_s``  gauge    pod-harvested goodput under
                                           SLO, mirrored from
                                           ``serve_goodput_tokens_per_s``
``serving_slo_attainment``      gauge      pod-harvested SLO attainment
                                           mirror
``serving_requests_shed``       gauge      pod-harvested shed-count
                                           mirror
``serving_requests_preempted``  gauge      pod-harvested preemption
                                           mirror
``serving_deadline_miss``       gauge      pod-harvested deadline-miss
                                           mirror
``serving_kv_bits``             gauge      pod-harvested KV element
                                           width mirror, from
                                           ``serve_kv_bits``
``serving_pages_evicted_total``  gauge     pod-harvested context-
                                           eviction mirror
``serving_kv_quality_delta``    gauge      pod-harvested kv-compression
                                           quality-delta mirror
``serving_chip_ticks_total``    gauge      pod-harvested chip-tick
                                           spend mirror, from
                                           ``serve_chip_ticks_total``
==============================  =========  ============================

Serving engine (observed by ``ContinuousBatcher`` /
``DataParallelServePool`` when a registry is passed; the serve pod
echoes the same names so ``DeviceScheduler.serving_metrics()`` carries
them as scheduler-visible gauges):

==============================  =========  ============================
name                            kind       meaning
==============================  =========  ============================
``serve_decode_stall_ms``       histogram  per-tick admission work
                                           decode slots waited behind
``serve_spec_accept``           histogram  per-slot per-tick draft
                                           match fraction
``serve_spec_tokens_per_tick``  histogram  tokens banked per slot per
                                           verify tick
``serve_collect_overlap_ms``    histogram  host readout wall hidden
                                           behind the next tick
``serve_ttft_ms``               histogram  submit → first output token
                                           (queue wait + admission +
                                           prefill)
``serve_token_ms``              histogram  per-output-token decode
                                           latency after the first
                                           token
``serve_queue_wait_ms``         histogram  submit → admission onto a
                                           slot
``serve_failover_total``        counter    dp replicas declared dead
                                           and failed over
``serve_replay_ms``             histogram  wall of one failover's
                                           re-admission sweep
``serve_requests_retried``      counter    requests re-admitted via
                                           bit-exact replay
``serve_slots_quarantined``     counter    slots pulled on non-finite
                                           logits
``serve_requests_shed``         counter    admissions failed by
                                           backpressure; suffixed
                                           ``_pressure`` / ``_quota`` /
                                           ``_deadline`` per shed
                                           reason and ``_t<k>`` per
                                           tier
``serve_dispatch_failures``     counter    transient dispatch failures
                                           retried in place
``serve_tick_stalls``           counter    watchdog deadline trips
``serve_replica_deaths``        counter    engine deaths (any cause)
``serve_spec_degraded``         counter    engines that fell back to
                                           γ=0 on zero-acceptance
``serve_fused_block_ms``        histogram  host sync wall of one fused
                                           K-tick block
``serve_host_overhead_pct``     gauge      share of a step's wall spent
                                           OUTSIDE the device sync —
                                           the cost fused ticks
                                           amortize
``serve_hbm_pool_bytes``        gauge      live pool + slot-mirror
                                           bytes at the last dispatch
                                           boundary (~1× the pool with
                                           buffer donation on, ~2×
                                           with it off)
``serve_hbm_peak_bytes``        gauge      lifetime peak of the live
                                           pool bytes — the number
                                           capacity planning budgets
                                           ``max_pages``/``n_slots``
                                           against
``serve_migrated_pages_total``  counter    KV pages migrated from
                                           prefill-specialist to
                                           decode-specialist replicas
``serve_migration_ms``          histogram  wall of one page-chain
                                           import: digest check +
                                           scatter + slot activation
``serve_replica_queue_depth``   gauge      per-replica admission queue
                                           depth (suffixed ``_r<i>``
                                           per replica; the pool
                                           router's own signal)
``serve_queue_wait_ticks``      histogram  submit → admission in engine
                                           service rounds — the
                                           deterministic twin of
                                           ``serve_queue_wait_ms``
                                           (schedule-pure; the CPU
                                           smoke A/B gates on it);
                                           suffixed
                                           ``_t<k>`` per tier under
                                           tiered admission
``serve_ttft_ticks``            histogram  submit → first token in
                                           engine service rounds — the
                                           deterministic twin of
                                           ``serve_ttft_ms``
``serve_decode_stall_work``     histogram  admission + chunk work UNITS
                                           decode-phase slots waited
                                           behind in one tick — the
                                           structural twin of
                                           ``serve_decode_stall_ms``
``serve_goodput_tokens_per_s``  gauge      tokens/s from requests that
                                           met their tier's SLO — the
                                           hardware (weather) claim of
                                           goodput under overload
``serve_goodput_tokens_per_tick``  gauge   goodput in tokens per engine
                                           tick — the deterministic
                                           twin the SLO smoke gates on
``serve_slo_attainment``        gauge      fraction of offered requests
                                           that met their tier's SLO;
                                           suffixed ``_t<k>`` per tier
                                           — the degradation story is
                                           that ``_t0`` stays pinned
                                           while lower tiers absorb
                                           the overload
``serve_requests_preempted``    counter    low-priority decoding slots
                                           parked host-side (pages
                                           released) to serve a higher
                                           tier; suffixed ``_t<k>`` by
                                           the victim's tier
``serve_requests_resumed``      counter    parked requests re-admitted
                                           via the bit-exact greedy
                                           replay path — converges to
                                           the preempted counter at
                                           drain
``serve_deadline_miss``         counter    requests expired by wall or
                                           tick deadline (pre-prefill
                                           prunes AND resident
                                           cancels); suffixed
                                           ``_t<k>`` per tier
``serve_routing_affinity_hits``  counter   pool submits routed to a
                                           replica already holding ≥1
                                           page of the prompt's chain
                                           (prefix-affinity routing)
``serve_autoscale_events``      counter    replica-pool scale actions
                                           (up = gang spawn + fresh
                                           replica, down = graceful
                                           drain through the replay
                                           parking)
``serve_replicas_active``       gauge      live replicas in the pool
                                           after deaths, retires, and
                                           scale-ups
``serve_kv_bits``               gauge      KV-pool element width in
                                           bits (16 = bf16, 8 = per-
                                           token int8, 4 = grouped
                                           packed int4)
``serve_pages_evicted_total``   counter    resident KV pages dropped by
                                           the context-eviction policy
                                           (window or attention-mass)
``serve_kv_quality_delta``      gauge      measured greedy-token
                                           disagreement vs the bf16
                                           reference for the active
                                           kv format (set by the
                                           ``cb_kv_capacity`` bench /
                                           serve harness via
                                           ``note_kv_quality``)
``serve_fleet_replicas``        gauge      live simulated replicas in
                                           the discrete-event fleet
                                           harness
``serve_domain_kills_total``    counter    whole failure domains
                                           (slice/rack/zone) killed in
                                           one tick by the domain
                                           chaos injector
``serve_ctrl_recoveries_total``  counter   control-plane crashes
                                           recovered from the append-
                                           only journal with every
                                           in-flight request re-driven
                                           exactly-once
``serve_upgrade_waves_total``   counter    rolling-upgrade drain waves
                                           completed (one failure
                                           domain retired through
                                           replay parking and
                                           backfilled)
``serve_chip_ticks_total``      gauge      chip-ticks charged to
                                           resident work by the cost
                                           ledger (one chip busy one
                                           engine tick); suffixed
                                           ``_<tenant>_t<k>`` per
                                           (tenant, tier) key, exact
                                           integer conservation vs
                                           the engines' busy ticks
``serve_alerts_fired``          counter    burn-rate alerts fired by
                                           the flight recorder's
                                           multi-window rules
==============================  =========  ============================

Alert RULE names (``obs/alerts.py`` burn-rate rules over
flight-recorder series; the KTP004 census checks ``AlertRule`` name
and series literals against this registry): ``alert_failover_burn``
(failure-domain loss via the ``serve_failover_total`` delta series),
``alert_shed_burn`` (sustained admission-control shed pressure via
``serve_requests_shed`` deltas), ``alert_slo_burn`` (SLO
error-budget burn via the ``serve_slo_attainment`` series).
Histogram series sampled through ``obs/tsdb.SeriesStore`` appear as
``_p50``/``_p99``-suffixed tracks of their documented base name.

Trace spans (recorded by ``obs/spans.Tracer``, exported as
Chrome/Perfetto JSON, not scraped): ``sched.schedule``, ``sched.bind``,
``crishim.inject``, ``engine.start``, ``request`` (attrs:
``queue_wait_ms``, ``ttft_ms``, ``token_ms``, ``tokens``),
``request.admit``, ``request.prefill_chunk``, ``request.replay``,
``request.migrate`` (attrs: ``rid``, ``pages``, ``to_replica``,
``outcome``, ``ms`` — the prefill→decode page-chain hand-off),
``request.preempt`` / ``request.resume`` (attrs: ``rid``, ``slot``,
``tier``, ``preemptions`` — the park/replay handshake of low-priority
preemption),
``request.quarantine``, ``pool.failover``,
``request.route`` (attrs: ``rid``, ``replica``, ``affinity_pages``,
``load`` — the prefix-affinity routing decision),
``pool.scale`` (attrs: ``direction``, ``replica``,
``replicas_active``, ``drain_replays`` — one autoscale action), ``engine.tick``,
``engine.dispatch``, ``engine.verify``, ``engine.collect``,
``engine.admit``, ``alert.fired`` (attrs: ``rule``, ``series``,
``tick``, ``fast``, ``slow`` — one burn-rate alert landing on the
flame+counter timeline), plus ``sched.<kind>`` instants
forwarded from ScheduleTrace for linked gangs.  The serve pod echoes the span census
as the ``serve_trace_spans`` metric line.  The ``cb_trace_overhead``
bench row asserts tracing on/off is bit-exact with bounded overhead.
"""

from __future__ import annotations

import json
import random
import threading
from bisect import bisect_left

# Cumulative-bucket upper bounds (ms-scale latencies — the registry's
# histograms are all milliseconds or small ratios).  Matches the
# Prometheus convention: each bucket counts observations <= le, and
# +Inf is implicit (== _count).
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# Reservoir size for percentile estimation: exact below this many
# observations, uniform reservoir sample above (seeded — a given
# observation sequence always yields the same percentiles).
_RESERVOIR = 1024


class _Histogram:
    """Bounded-memory histogram: cumulative buckets (Prometheus
    exposition) + a seeded reservoir serving ``percentile()``.

    ``observe`` is O(log buckets) and memory is capped at ``_RESERVOIR``
    floats; percentiles stay EXACT until the cap, then degrade to a
    uniform sample (seeded, so deterministic for a fixed
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
        # (Prometheus buckets count observations <= le)
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

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative (le, count) pairs, +Inf last — the Prometheus
        histogram exposition shape."""
        out: list[tuple[float, int]] = []
        acc = 0
        for le, c in zip(self._bounds, self._bucket_counts):
            acc += c
            out.append((le, acc))
        out.append((float("inf"), self._count))
        return out

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}
        self._gauge_del_hooks: list = []

    def inc(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def add_gauge_delete_hook(self, fn) -> None:
        """Register an observer called (outside the lock) with each
        gauge name that :meth:`delete_gauge` actually removes — the
        seam ``obs/tsdb.SeriesStore`` uses to END a per-instance
        series at the same choke point that drops its gauge."""
        with self._lock:
            self._gauge_del_hooks.append(fn)

    def delete_gauge(self, name: str) -> None:
        """Drop a gauge from the scrape surface entirely (idempotent).
        Per-instance gauges (``serve_replica_queue_depth_r<i>``) use
        this when the instance goes away — a drained replica must
        vanish from ``/metrics``, not freeze at its last depth.
        Delete hooks fire only on an ACTUAL removal, so the pool's
        idempotent re-deletes at the harvest choke point stay
        no-ops."""
        with self._lock:
            existed = self._gauges.pop(name, None) is not None
            hooks = list(self._gauge_del_hooks) if existed else []
        for fn in hooks:
            fn(name)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, _Histogram()).observe(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def histogram(self, name: str) -> _Histogram:
        with self._lock:
            return self._hists.setdefault(name, _Histogram())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition 0.0.4 (the observability surface
        a k8s-era deployment scrapes; served at GET /metrics on the
        extender webhook, the scheduler daemon, and the kubemeta
        apiserver).  Histograms export as CUMULATIVE BUCKETS
        (``_bucket{le="..."}`` + ``_count`` + ``_sum``), so
        quantiles aggregate across scrape targets server-side
        (histogram_quantile), which summaries cannot.  A name
        registered as BOTH gauge and histogram
        (harvest_workload_metrics does this) exports the gauge as
        ``<name>_last`` — a duplicate metric family is a hard parse
        error that would fail the whole scrape.  Every family gets a
        ``# HELP`` line sourced from the METRICS TABLE docstring; undocumented names carry an explicit stub so the
        gap is visible in the scrape itself.  One locked pass."""
        docs = documented_names()["docs"]

        def sanitize(name: str) -> str:
            return "kubetpu_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in name)

        def help_line(m: str, name: str) -> str:
            text = docs.get(name) or (
                f"undocumented metric {name} (no METRICS TABLE row)")
            return f"# HELP {m} " + text.replace("\\", "\\\\")

        def fmt_le(le: float) -> str:
            if le == float("inf"):
                return "+Inf"
            return repr(le) if le != int(le) else str(int(le))

        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hist_names = set(self._hists)
            hist_rows = [(k, h.buckets(), h.count, h.sum)
                         for k, h in sorted(self._hists.items())]
        lines: list[str] = []
        for name, v in counters:
            m = sanitize(name)
            lines += [help_line(m, name), f"# TYPE {m} counter",
                      f"{m} {v}"]
        for name, v in gauges:
            m = sanitize(name + "_last" if name in hist_names else name)
            lines += [help_line(m, name), f"# TYPE {m} gauge",
                      f"{m} {v}"]
        for name, buckets, n, total in hist_rows:
            m = sanitize(name)
            lines += [help_line(m, name), f"# TYPE {m} histogram"]
            for le, c in buckets:
                lines.append(f'{m}_bucket{{le="{fmt_le(le)}"}} {c}')
            lines.append(f"{m}_count {n}")
            lines.append(f"{m}_sum {total}")
        return "\n".join(lines) + "\n"


class LiveBytesTracker:
    """Live state-byte accounting for the serving engine.

    The engine calls :meth:`sample` at every dispatch boundary with the
    bytes of its state tensors (pool or cache leaves plus the slot
    mirrors).  ``live`` is the latest sample and ``peak`` the largest; the
    engine reports them as ``hbm_pool_bytes`` and ``hbm_peak_bytes``, and
    with a ``registry`` sets the two gauges capacity planning budgets
    ``max_pages`` / ``n_slots`` against."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry
        self.live = 0
        self.peak = 0
        self.samples = 0

    def sample(self, live_bytes: int) -> None:
        self.live = int(live_bytes)
        self.peak = max(self.peak, self.live)
        self.samples += 1
        if self.registry is not None:
            self.registry.set_gauge("serve_hbm_pool_bytes", self.live)
            self.registry.set_gauge("serve_hbm_peak_bytes", self.peak)


def parse_prometheus(text: str) -> dict[str, dict]:
    """Minimal 0.0.4 parser for the trace-smoke gate: returns
    family → {"type", "help", "samples": {name+labels: value}} and
    raises ValueError on malformed lines, duplicate families, or
    non-monotonic histogram buckets.  ``# HELP`` text round-trips: the help recorded before a family's TYPE line rides
    on the family."""
    families: dict[str, dict] = {}
    help_pending: dict[str, str] = {}
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# HELP "):
            rest = ln[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            help_pending[name] = help_text.replace("\\\\", "\\")
            continue
        if ln.startswith("# TYPE "):
            _, _, rest = ln.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            if name in families:
                raise ValueError(f"duplicate family {name}")
            if kind not in ("counter", "gauge", "histogram", "summary"):
                raise ValueError(f"bad type {kind!r} for {name}")
            families[name] = {"type": kind,
                              "help": help_pending.get(name),
                              "samples": {}}
            continue
        if ln.startswith("#"):
            continue
        key, _, val = ln.rpartition(" ")
        if not key:
            raise ValueError(f"malformed sample line {ln!r}")
        float(val)   # must parse
        base = key.split("{", 1)[0]
        fam = base
        for suffix in ("_bucket", "_count", "_sum"):
            if base.endswith(suffix) and base[:-len(suffix)] in families:
                fam = base[:-len(suffix)]
                break
        if fam not in families:
            raise ValueError(f"sample {key!r} without TYPE line")
        families[fam]["samples"][key] = float(val)
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        pairs = []
        for key, v in fam["samples"].items():
            if key.startswith(name + "_bucket{le=\""):
                le = key.split('le="', 1)[1].rstrip('"}')
                pairs.append((float("inf") if le == "+Inf"
                              else float(le), v))
        pairs.sort()
        if any(b[1] < a[1] for a, b in zip(pairs, pairs[1:])):
            raise ValueError(f"non-monotonic buckets in {name}")
    return families


def percentiles(values, ps=(50, 90, 99)) -> dict:
    """Percentile summary of a plain value list without registering a
    histogram — same index math as :class:`_Histogram`.  Used by the
    serving engine's per-tick decode-stall list
    (``ContinuousBatcher.stall_ms``) and the bench's device-anchored
    stall distributions, so engine and bench quantiles can never
    disagree on method."""
    h = _Histogram()
    for v in values:
        h.observe(float(v))
    out = {"count": h.count, "mean": h.mean}
    for p in ps:
        out[f"p{int(p)}"] = h.percentile(p)
    return out


def documented_names() -> dict[str, frozenset]:
    """The documented-name REGISTRY: every metric and span name the
    METRICS TABLE above declares, parsed from this module's docstring
    (the table is the single source of truth).

    A *metric* row is any ````name```` literal of plain snake_case; a
    *span* name additionally contains a dot (``engine.tick``) or is
    the bare ``request`` root.  Returns
    ``{"metrics": frozenset, "spans": frozenset, "docs": dict}``;
    span names are also valid ``add_span`` targets so both sets
    include the dotted names.  ``docs`` maps each TABLE-ROW name to
    its one-line meaning (continuation lines folded in) — the source
    of :meth:`MetricsRegistry.to_prometheus`'s ``# HELP`` text."""
    import re
    doc = __doc__ or ""
    names = set(re.findall(r"``([a-z0-9_][a-z0-9_.]*)``", doc))
    spans = frozenset(n for n in names if "." in n) | {"request"}
    metrics = frozenset(n for n in names if "." not in n)
    # help text: a table ROW opens with ``name`` at column 0 plus a
    # kind and meaning; deeply-indented follow-up lines continue the
    # meaning, and anything else (borders, prose, blanks) closes it
    docs: dict[str, str] = {}
    cur: str | None = None
    for line in doc.splitlines():
        m = re.match(r"``([a-z0-9_][a-z0-9_.]*)``\s+(\S+)\s+(\S.*)",
                     line)
        if m:
            cur = m.group(1)
            docs[cur] = m.group(3).strip()
            continue
        if cur is not None and re.match(r"\s{8,}\S", line):
            docs[cur] = docs[cur] + " " + line.strip()
            continue
        cur = None
    return {"metrics": metrics, "spans": frozenset(spans),
            "docs": docs}


# the process-wide registry: the node and scheduler daemons publish into it
# and the apiserver's /metrics serves it
global_registry = MetricsRegistry()


def serve_prometheus(registry: MetricsRegistry, host: str = "127.0.0.1",
                     port: int = 0):
    """Standalone Prometheus scrape endpoint (GET /metrics) for daemon
    processes that have no other HTTP server — the extender webhook
    and the kubemeta apiserver integrate the same surface into their
    own dispatch; this is the scheduler daemon's.  ``host`` matters in
    a container netns (a loopback-only bind is unreachable from an
    off-host scraper).  Returns the started ThreadingHTTPServer; call
    ``shutdown()`` + ``server_close()`` to stop."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.split("?", 1)[0] != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = registry.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
