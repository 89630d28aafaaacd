"""Open-loop, seeded, trace-driven load harness (counterpart of
``kubegpu_tpu/loadgen.py``; the port keeps its own copy and imports
nothing of the reference package).

Serving benches that drive a fixed request matrix measure the engine's
fast paths; they cannot ask the overload question: *what does the stack
do when offered more traffic than it can serve?*  This module synthesizes
that traffic and scores the answer as GOODPUT UNDER SLO, not raw
throughput.

The generator is OPEN-LOOP: arrivals are scheduled by ENGINE TICK from
the seed alone, independent of how fast the engine drains them (a closed
loop, submit-on-completion, throttles itself and never overloads
anything).  Tick-denominated arrivals make a scenario a pure function of
the seed and the engine schedule, so two runs of one trace agree on every
tick-denominated number; the wall-clock tokens/s ride along as the
hardware's.

The traffic model, all from one ``numpy`` Generator (the reference's
draws in the reference's order, so one seed gives the same trace bit for
bit in either package):

- **Arrivals**: Poisson (exponential inter-arrival ticks), optionally
  Markov-modulated (a two-state calm/burst chain whose burst state
  multiplies the arrival rate; see ``burst``), a diurnal swing and
  flash-crowd windows (pure functions of the arrival tick: no draws).
- **Lengths**: log-normal prompt AND output lengths, clipped to the
  engine's bucket/budget range: the long tail is the point (one
  p99-length request parks a slot for the whole window).
- **Prefix sharing**: with probability ``prefix_share`` a prompt reuses
  one of ``n_shared_prefixes`` shared prefixes (the prefix-cache fast
  path under load).
- **Tenant + tier mix**: each request draws a tenant (quota bucket) and a
  priority tier from the configured shares.

:func:`run_load` drives the REAL engine (a ``ContinuousBatcher``,
``DataParallelServePool`` or ``DisaggServePool``, or the fleet's
simulated pools), one ``step()`` per tick, submitting every arrival
whose tick has come, and scores each surfaced request against its tier's
SLO::

    met SLO  :=  completed without error
                 AND ttft_ticks   <= tier.ttft_slo_ticks
                 AND ticks/token  <= tier.token_slo_ticks

    goodput  :=  tokens generated by SLO-met requests, per tick
                 (the deterministic twin) and per second (the wall)

``tiered=False`` replays the SAME trace with every request submitted at
tier 0 (the FIFO baseline) while still scoring each request against its
INTENDED tier, so the two legs compare request for request.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from kubegpu_tpu_torch.obs.cost import cost_key, safe_suffix

__all__ = ["TierSpec", "LoadSpec", "synth_trace", "run_load",
           "LoadReport", "score_run"]


@dataclass(frozen=True)
class TierSpec:
    """One priority tier's SLO contract.  ``ttft_slo_ticks`` bounds
    engine ticks from submit to first token; ``token_slo_ticks`` bounds
    decode ticks per output token; ``share`` is the tier's fraction of
    offered traffic (normalized across the tier list)."""
    name: str
    ttft_slo_ticks: int
    token_slo_ticks: float
    share: float = 1.0


@dataclass(frozen=True)
class LoadSpec:
    """Seeded description of one offered-load scenario.  Lengths are
    log-normal (``exp(N(mean, sigma))``, clipped): heavy-tailed by
    construction; arrival ticks accumulate exponential inter-arrival
    draws, scaled down by ``burst_rate_x`` while the modulating chain sits
    in its burst state."""
    seed: int = 0
    n_requests: int = 32
    mean_iat_ticks: float = 1.0
    burst: bool = False
    burst_rate_x: float = 4.0
    p_enter_burst: float = 0.15
    p_exit_burst: float = 0.3
    prompt_len_mean: float = 1.2     # log-space mean
    prompt_len_sigma: float = 0.6
    prompt_len_max: int = 8
    out_len_mean: float = 1.8
    out_len_sigma: float = 0.5
    out_len_min: int = 2
    out_len_max: int = 12
    prefix_share: float = 0.0
    n_shared_prefixes: int = 2
    prefix_len: int = 4
    vocab: int = 64
    tenants: tuple[str, ...] = ("t0",)
    tiers: tuple[TierSpec, ...] = (TierSpec("best-effort", 10 ** 6,
                                            10 ** 6.0),)
    # fleet-scale traffic shapes: both modulate the arrival RATE as pure
    # functions of the current arrival tick (no extra draws), so a trace
    # with both off is bit-identical to one made without them
    diurnal: bool = False            # sinusoidal day/night rate swing
    diurnal_period_ticks: float = 256.0
    diurnal_depth: float = 0.5       # rate in [1-depth, 1+depth]
    flash_at: tuple[float, ...] = ()  # flash-crowd window starts
    flash_rate_x: float = 8.0        # rate multiplier inside a window
    flash_len_ticks: float = 16.0    # window length


def synth_trace(spec: LoadSpec) -> list[dict]:
    """Synthesize the request trace: a list of ``{arrival_tick, prompt,
    max_new, tier, tenant}`` sorted by arrival tick, drawn entirely from
    ``spec.seed`` (same spec, same trace, bit for bit: the A/B legs replay
    one trace).  Prompts are int32 arrays."""
    rng = np.random.default_rng(spec.seed)
    shares = np.asarray([t.share for t in spec.tiers], np.float64)
    shares = shares / shares.sum()
    prefixes = [rng.integers(1, spec.vocab,
                             spec.prefix_len).astype(np.int32)
                for _ in range(spec.n_shared_prefixes)]
    trace: list[dict] = []
    tick = 0.0
    burst_state = False
    for _ in range(spec.n_requests):
        rate_x = spec.burst_rate_x if (spec.burst and burst_state) \
            else 1.0
        if spec.diurnal:
            rate_x *= 1.0 + spec.diurnal_depth * float(np.sin(
                2.0 * np.pi * tick / spec.diurnal_period_ticks))
        for f0 in spec.flash_at:
            if f0 <= tick < f0 + spec.flash_len_ticks:
                rate_x *= spec.flash_rate_x
                break
        tick += rng.exponential(spec.mean_iat_ticks / max(rate_x, 1e-9))
        if spec.burst:
            p_flip = spec.p_exit_burst if burst_state \
                else spec.p_enter_burst
            if rng.random() < p_flip:
                burst_state = not burst_state
        t = int(np.clip(round(np.exp(rng.normal(
            spec.prompt_len_mean, spec.prompt_len_sigma))),
            1, spec.prompt_len_max))
        if spec.prefix_share > 0 and rng.random() < spec.prefix_share \
                and t > spec.prefix_len:
            pre = prefixes[int(rng.integers(len(prefixes)))]
            suffix = rng.integers(1, spec.vocab,
                                  t - spec.prefix_len).astype(np.int32)
            prompt = np.concatenate([pre, suffix])
        else:
            prompt = rng.integers(1, spec.vocab, t).astype(np.int32)
        max_new = int(np.clip(round(np.exp(rng.normal(
            spec.out_len_mean, spec.out_len_sigma))),
            spec.out_len_min, spec.out_len_max))
        trace.append({
            "arrival_tick": int(tick),
            "prompt": prompt,
            "max_new": max_new,
            "tier": int(rng.choice(len(spec.tiers), p=shares)),
            "tenant": str(spec.tenants[
                int(rng.integers(len(spec.tenants)))]),
        })
    trace.sort(key=lambda e: e["arrival_tick"])
    return trace


@dataclass
class LoadReport:
    """Scored outcome of one trace run.  ``records`` keeps one entry per
    submitted request (tokens included), so a caller can check exactness
    and exactly-once against another run; ``per_tier`` aggregates the
    degradation story."""
    ticks: int = 0
    wall_s: float = 0.0
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    lost: int = 0
    duplicated: int = 0
    total_tokens: int = 0
    goodput_tokens: int = 0
    goodput_tokens_per_tick: float = 0.0
    goodput_tokens_per_s: float = 0.0
    slo_attainment: float = 0.0
    per_tier: dict = field(default_factory=dict)
    records: list = field(default_factory=list)
    # chip-tick cost attribution: the target's ledger at the end of the
    # run; ``cost_by_key`` maps ``"tenant:t<k>"`` to attributed
    # chip-ticks, and sum(cost_by_key.values()) == busy_chip_ticks exactly
    busy_chip_ticks: int = 0
    cost_by_key: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        """JSON-ready summary (records elided: they carry arrays)."""
        return {
            "ticks": self.ticks,
            "wall_s": round(self.wall_s, 4),
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "lost": self.lost,
            "duplicated": self.duplicated,
            "total_tokens": self.total_tokens,
            "goodput_tokens": self.goodput_tokens,
            "goodput_tokens_per_tick":
                round(self.goodput_tokens_per_tick, 4),
            "goodput_tokens_per_s":
                round(self.goodput_tokens_per_s, 2),
            "slo_attainment": round(self.slo_attainment, 4),
            "per_tier": self.per_tier,
            "busy_chip_ticks": self.busy_chip_ticks,
            "cost_by_key": dict(self.cost_by_key),
        }

    def cost_summary(self) -> dict:
        """The goodput-per-chip-tick table: one row per
        ``"tenant:t<k>"`` key joining the ledger's attributed chip-ticks
        with that key's scored goodput.  Keys that burned chips but
        produced no goodput (all-shed tenants) still get a row; the grand
        total carries the conservation operands."""
        per: dict[str, dict] = {}

        def row(key: str) -> dict:
            return per.setdefault(key, {
                "chip_ticks": 0, "total_tokens": 0,
                "goodput_tokens": 0, "goodput_per_chip_tick": 0.0})

        for rec in self.records:
            agg = row(cost_key(rec["tenant"], rec["tier"]))
            agg["total_tokens"] += len(rec["tokens"])
            if rec.get("slo_met"):
                agg["goodput_tokens"] += len(rec["tokens"])
        for key, ticks in self.cost_by_key.items():
            row(key)["chip_ticks"] = int(ticks)
        for agg in per.values():
            if agg["chip_ticks"]:
                agg["goodput_per_chip_tick"] = round(
                    agg["goodput_tokens"] / agg["chip_ticks"], 4)
        return {
            "busy_chip_ticks": self.busy_chip_ticks,
            "attributed_chip_ticks": sum(
                int(v) for v in self.cost_by_key.values()),
            "goodput_per_chip_tick": round(
                self.goodput_tokens / self.busy_chip_ticks, 4)
            if self.busy_chip_ticks else 0.0,
            "per_key": dict(sorted(per.items())),
        }

    def publish(self, metrics) -> None:
        """Export the goodput surface to a MetricsRegistry: the
        wall-clock gauge, the per-tick twin and per-tier attainment."""
        if metrics is None:
            return
        metrics.set_gauge("serve_goodput_tokens_per_s",
                          round(self.goodput_tokens_per_s, 2))
        metrics.set_gauge("serve_goodput_tokens_per_tick",
                          round(self.goodput_tokens_per_tick, 4))
        metrics.set_gauge("serve_slo_attainment",
                          round(self.slo_attainment, 4))
        for k, stats in self.per_tier.items():
            metrics.set_gauge("serve_slo_attainment"
                              + f"_t{stats['tier']}",
                              stats["attainment"])
        if self.busy_chip_ticks:
            metrics.set_gauge("serve_chip_ticks_total",
                              float(self.busy_chip_ticks))
            for key, ticks in sorted(self.cost_by_key.items()):
                metrics.set_gauge("serve_chip_ticks_total"
                                  + "_" + safe_suffix(key),
                                  float(ticks))


def _busy(target) -> bool:
    """In-flight work anywhere in the target (engine or pool): pool
    entries, pending migrations, or a live engine's queue, slots, chunked
    prefills or failed requests not yet returned.  Dead replicas are
    skipped: their residents were already replayed onto survivors
    (tracked by ``_entries``), so their frozen queues are history, not
    work."""
    if getattr(target, "_entries", None):
        return True
    if getattr(target, "_pending_migrations", None):
        return True
    for eng in getattr(target, "replicas", [target]):
        if getattr(eng, "dead", None) is not None:
            continue
        if (eng.queue or eng.slot_req
                or getattr(eng, "_prefilling", None)
                or eng._failed):
            return True
    return False


def _slo_met(r, tier: TierSpec) -> bool:
    """One finished request's SLO verdict on tick-denominated stamps: the
    predicate the end-of-run scorer applies, exposed so the running
    estimate a controller sees agrees with the final report."""
    sub = getattr(r, "submit_tick", -1)
    first = getattr(r, "first_tick", -1)
    fin = getattr(r, "finish_tick", -1)
    if sub < 0 or first < 0:
        return False
    ttft = first - sub
    per_tok = ((fin - first) / max(1, len(r.tokens) - 1)
               if fin >= first else float("inf"))
    return (ttft <= tier.ttft_slo_ticks
            and per_tok <= tier.token_slo_ticks)


def run_load(target, trace: list[dict], tiers: tuple[TierSpec, ...],
             tiered: bool = True, max_ticks: int = 5000,
             metrics=None, controller=None) -> LoadReport:
    """Drive ``target`` (engine or pool) through ``trace``, one ``step()``
    per tick, open-loop.  ``tiered=False`` submits every request at tier
    0 (the FIFO baseline) but still scores against the trace's intended
    tier.  Raises RuntimeError if the run does not go idle within
    ``max_ticks`` (stuck work is a bug, not a result).

    ``controller`` is called once per tick AFTER the target steps, as
    ``controller(tick, stats)`` with a RUNNING view of the run: submitted
    / finished / failed counts, in-flight depth, and ``attainment`` (SLO
    met over requests finished so far, 1.0 until the first finisher, by
    the predicate the final report applies).  An autoscaler or a flight
    recorder hangs off it."""
    meta: dict[int, dict] = {}
    seen: dict[int, int] = {}
    done: dict[int, object] = {}
    n_ok = n_fail = n_met = 0
    t0 = time.perf_counter()
    i = 0
    tick = 0
    while tick < max_ticks:
        while i < len(trace) and trace[i]["arrival_tick"] <= tick:
            item = trace[i]
            rid = target.submit(
                item["prompt"], item["max_new"],
                tier=item["tier"] if tiered else 0,
                tenant=item["tenant"])
            meta[rid] = item
            i += 1
        for r in target.step():
            seen[r.rid] = seen.get(r.rid, 0) + 1
            done[r.rid] = r
            item = meta.get(r.rid)
            if item is None or seen[r.rid] > 1:
                continue
            if r.error is not None:
                n_fail += 1
                continue
            n_ok += 1
            if _slo_met(r, tiers[item["tier"]]):
                n_met += 1
        if controller is not None:
            controller(tick, {
                "submitted": len(meta),
                "finished": n_ok,
                "failed": n_fail,
                "slo_met": n_met,
                "in_flight": len(meta) - len(done),
                "attainment": (n_met / n_ok) if n_ok else 1.0,
            })
        tick += 1
        if i >= len(trace) and not _busy(target):
            break
    wall = time.perf_counter() - t0
    if i < len(trace) or _busy(target):
        raise RuntimeError(
            f"load run did not go idle within {max_ticks} ticks "
            f"({len(trace) - i} arrivals unsubmitted)")
    rep = score_run(meta, seen, done, tiers, ticks=tick, wall_s=wall)
    ledger = getattr(target, "cost", None)
    if ledger is not None:
        rep.busy_chip_ticks = ledger.busy_chip_ticks
        rep.cost_by_key = ledger.as_dict()
    rep.publish(metrics)
    return rep


def score_run(meta: dict, seen: dict, done: dict,
              tiers: tuple[TierSpec, ...], ticks: int,
              wall_s: float = 0.0) -> LoadReport:
    """Score one completed run into a :class:`LoadReport` from the
    run loop's ledgers: ``meta`` (rid -> trace item), ``seen`` (rid ->
    surface count: duplicates are a bug being counted, not averaged away)
    and ``done`` (rid -> final request object).  Shared by
    :func:`run_load` and the fleet harness, which re-drives in-flight work
    across a control-plane recovery, so both score with one predicate."""
    rep = LoadReport(ticks=ticks, wall_s=wall_s, submitted=len(meta))
    rep.duplicated = sum(n - 1 for n in seen.values() if n > 1)
    rep.lost = sum(1 for rid in meta if rid not in done)
    per_tier = {
        k: {"tier": k, "name": tiers[k].name, "submitted": 0,
            "completed": 0, "failed": 0, "slo_met": 0,
            "goodput_tokens": 0, "attainment": 0.0}
        for k in range(len(tiers))}
    for rid, item in meta.items():
        k = item["tier"]
        tier, agg = tiers[k], per_tier[k]
        agg["submitted"] += 1
        r = done.get(rid)
        rec = {"rid": rid, "tier": k, "tenant": item["tenant"],
               "prompt": item["prompt"], "max_new": item["max_new"],
               "completed": False, "slo_met": False, "tokens": [],
               "error": None}
        rep.records.append(rec)
        if r is None:
            continue
        rec["error"] = r.error
        rec["tokens"] = list(r.tokens)
        if r.error is not None:
            agg["failed"] += 1
            rep.failed += 1
            continue
        agg["completed"] += 1
        rep.completed += 1
        rec["completed"] = True
        rep.total_tokens += len(r.tokens)
        sub, first, fin = (getattr(r, "submit_tick", -1),
                           getattr(r, "first_tick", -1),
                           getattr(r, "finish_tick", -1))
        if sub < 0 or first < 0:
            continue   # no TTFT stamp (a failover remnant): not met
        ttft = first - sub
        per_tok = ((fin - first) / max(1, len(r.tokens) - 1)
                   if fin >= first else float("inf"))
        rec["ttft_ticks"], rec["ticks_per_token"] = ttft, per_tok
        if ttft <= tier.ttft_slo_ticks \
                and per_tok <= tier.token_slo_ticks:
            rec["slo_met"] = True
            agg["slo_met"] += 1
            agg["goodput_tokens"] += len(r.tokens)
            rep.goodput_tokens += len(r.tokens)
    for agg in per_tier.values():
        agg["attainment"] = round(
            agg["slo_met"] / agg["submitted"], 4) \
            if agg["submitted"] else 1.0
    rep.per_tier = per_tier
    rep.slo_attainment = (
        sum(a["slo_met"] for a in per_tier.values())
        / rep.submitted if rep.submitted else 1.0)
    rep.goodput_tokens_per_tick = (rep.goodput_tokens / rep.ticks
                                   if rep.ticks else 0.0)
    rep.goodput_tokens_per_s = (rep.goodput_tokens / wall_s
                                if wall_s > 0 else 0.0)
    return rep
