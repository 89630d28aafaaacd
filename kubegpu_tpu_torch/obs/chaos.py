"""Deterministic fault injection for one serving engine (the port's own
copy of the engine half of ``kubegpu_tpu/obs/chaos.py``).

A :class:`ChaosInjector` is a seeded schedule of :class:`ChaosEvent`\\ s
that ``ContinuousBatcher`` consults at every dispatch:

- ``kill_replica`` -- the engine dies mid-tick and raises
  :class:`ReplicaDeadError`; its host-side request state survives for a
  pool's failover;
- ``fail_dispatch`` -- one dispatch fails transiently
  (:class:`DispatchFailure`) and is retried in place, before the dispatch
  touches any state; repeated failure escalates to replica death;
- ``nan_logits`` -- one slot's K/V history is poisoned with NaN, its
  logits go non-finite while its neighbours stay exact, and the engine
  quarantines the slot and replays its request;
- ``stall_tick`` -- the tick sleeps past the engine's watchdog deadline
  (``tick_deadline_s``), which declares the replica stalled
  (:class:`TickStallError`).

An injector is a pure function of its events (or of ``from_seed``'s
arguments), and every recovery replays greedy tokens bit-exactly, so a
chaos run emits the fault-free run's tokens.

The fleet half (:class:`DomainChaosInjector`, consumed by
:func:`kubegpu_tpu_torch.fleet.run_fleet`) schedules correlated faults
over failure domains and weather on the health-watch channel.  One table
(:data:`EVENT_TABLE`, kind -> scope) serves both injectors:

====================  =======  ==========================================
kind                  scope    effect
====================  =======  ==========================================
``kill_replica``      engine   whole engine dies mid-tick
``fail_dispatch``     engine   one dispatch fails transiently, retried
``nan_logits``        engine   one slot's logits poisoned, quarantined
``stall_tick``        engine   tick sleeps past the watchdog deadline
``kill_domain``       domain   every replica in one failure domain
                               (slice/rack/zone) dies in the SAME tick;
                               watch evictions for the gangs are also
                               emitted (late/dup deliveries must no-op)
``evict_domain``      domain   control-plane eviction of a domain's
                               gangs, visible ONLY via the health watch
                               -- a delayed delivery is a stale-read
                               window where routing still targets them
``watch_delay``       watch    deliveries issued in the window arrive
                               ``delay_ticks`` late
``watch_dup``         watch    each delivery in the window arrives
                               ``dup`` times
``watch_reorder``     watch    deliveries due the same tick flush in
                               reverse issue order
``watch_partition``   watch    the watch stream partitions: deliveries
                               buffer for ``duration_ticks`` (stale
                               reads), then flush on heal
====================  =======  ==========================================

Engine-scope events go to a per-replica :class:`ChaosInjector`; domain and
watch events to the fleet's :class:`DomainChaosInjector`.  Both share the
determinism contract: same seed, same schedule, same recovery sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ChaosError(RuntimeError):
    """Base class for injected serving faults."""


class ReplicaDeadError(ChaosError):
    """The engine is dead (killed, or declared dead by its watchdog);
    every subsequent ``step()`` re-raises.  Its host-side request state
    (``slot_req``, ``queue``, ``take_orphans()``) stays readable for a
    failover to replay elsewhere."""


class TickStallError(ReplicaDeadError):
    """Watchdog verdict: a tick exceeded ``tick_deadline_s``.  A
    subclass of :class:`ReplicaDeadError` because the recovery policy
    is identical — a replica that can stall once can wedge ``drain()``
    forever, so the pool fails over rather than waiting."""


class DispatchFailure(ChaosError):
    """A single dispatch failed transiently; the engine retries the
    same dispatch (safe: dispatches are functional) with a bounded
    budget before escalating to replica death."""


KILL = "kill_replica"
FAIL_DISPATCH = "fail_dispatch"
NAN_LOGITS = "nan_logits"
STALL = "stall_tick"
KINDS = (KILL, FAIL_DISPATCH, NAN_LOGITS, STALL)

# the failure-domain and watch-channel kinds (the fleet's)
DOMAIN_KILL = "kill_domain"
DOMAIN_EVICT = "evict_domain"
WATCH_DELAY = "watch_delay"
WATCH_DUP = "watch_dup"
WATCH_REORDER = "watch_reorder"
WATCH_PARTITION = "watch_partition"
DOMAIN_KINDS = (DOMAIN_KILL, DOMAIN_EVICT)
WATCH_KINDS = (WATCH_DELAY, WATCH_DUP, WATCH_REORDER, WATCH_PARTITION)

#: the event registry (kind -> scope) both injectors validate against
EVENT_TABLE = {
    KILL: "engine", FAIL_DISPATCH: "engine",
    NAN_LOGITS: "engine", STALL: "engine",
    DOMAIN_KILL: "domain", DOMAIN_EVICT: "domain",
    WATCH_DELAY: "watch", WATCH_DUP: "watch",
    WATCH_REORDER: "watch", WATCH_PARTITION: "watch",
}


@dataclass(frozen=True)
class ChaosEvent:
    tick: int            # engine tick (dispatch counter) to fire at
    kind: str            # one of KINDS
    stall_s: float = 0.0  # sleep injected for STALL events


@dataclass
class ChaosInjector:
    """Seeded, replayable fault schedule for ONE engine.

    ``take(tick)`` pops every event due at or before ``tick`` (events
    fire once); ``defer(ev, tick)`` re-queues an event the engine could
    not apply yet (e.g. a NaN injection with no eligible slot).  The
    ``fired`` log is the audit trail of what fired."""

    events: list = field(default_factory=list)
    fired: list = field(default_factory=list)

    def __post_init__(self) -> None:
        for ev in self.events:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown chaos kind {ev.kind!r}")
        self.events = sorted(self.events, key=lambda e: e.tick)

    @classmethod
    def from_seed(cls, seed: int, ticks: int,
                  kinds: tuple = KINDS,
                  n_events: int = 1,
                  stall_s: float = 0.0) -> "ChaosInjector":
        """Draw ``n_events`` events uniformly over ``[1, ticks]`` from a
        seeded generator — the scenario-matrix entry point (same seed ⇒
        same schedule ⇒ same recovery sequence)."""
        import numpy as np
        rng = np.random.default_rng(seed)
        evs = [ChaosEvent(tick=int(rng.integers(1, max(ticks, 2))),
                          kind=str(rng.choice(list(kinds))),
                          stall_s=stall_s)
               for _ in range(n_events)]
        return cls(events=evs)

    def take(self, tick: int) -> list:
        due = [e for e in self.events if e.tick <= tick]
        if due:
            self.events = [e for e in self.events if e.tick > tick]
            self.fired.extend(due)
        return due

    def defer(self, ev: ChaosEvent, tick: int) -> None:
        self.fired.remove(ev)
        self.events.append(ChaosEvent(tick=tick, kind=ev.kind,
                                      stall_s=ev.stall_s))
        self.events.sort(key=lambda e: e.tick)


@dataclass(frozen=True)
class DomainChaosEvent:
    """One correlated fault: a whole failure domain (slice/rack/zone) or
    the health-watch channel itself, at a fleet tick."""
    tick: int                 # fleet tick to fire at
    kind: str                 # one of DOMAIN_KINDS + WATCH_KINDS
    domain: str | None = None  # target domain (domain-scope kinds)
    delay_ticks: int = 0      # WATCH_DELAY: per-delivery lateness
    duration_ticks: int = 0   # window length for watch-scope kinds
    dup: int = 1              # WATCH_DUP: copies per delivery


@dataclass
class DomainChaosInjector:
    """Seeded, replayable CORRELATED-fault schedule for a fleet: the
    topology-aware sibling of :class:`ChaosInjector` (same event table,
    same determinism contract, domain/watch scope instead of engine
    scope).  ``take(tick)`` pops every event due at or before ``tick``;
    the fleet harness turns domain events into simultaneous replica
    deaths / gang evictions and watch events into delivery-channel
    weather (delay, duplication, reorder, partition)."""

    events: list = field(default_factory=list)
    fired: list = field(default_factory=list)

    def __post_init__(self) -> None:
        for ev in self.events:
            if ev.kind not in EVENT_TABLE:
                raise ValueError(f"unknown chaos kind {ev.kind!r}")
            if EVENT_TABLE[ev.kind] == "engine":
                raise ValueError(
                    f"{ev.kind!r} is engine-scope — schedule it on a "
                    f"per-replica ChaosInjector, not the domain one")
            if EVENT_TABLE[ev.kind] == "domain" and ev.domain is None:
                raise ValueError(f"{ev.kind!r} needs a target domain")
        self.events = sorted(self.events, key=lambda e: e.tick)

    @classmethod
    def from_seed(cls, seed: int, ticks: int, domains: tuple,
                  kinds: tuple = DOMAIN_KINDS + WATCH_KINDS,
                  n_events: int = 1,
                  delay_ticks: int = 2,
                  duration_ticks: int = 4,
                  dup: int = 2) -> "DomainChaosInjector":
        """Draw ``n_events`` correlated faults uniformly over
        ``[1, ticks]`` and uniformly over ``domains`` — a pure function
        of its arguments, exactly like :meth:`ChaosInjector.from_seed`."""
        import numpy as np
        rng = np.random.default_rng(seed)
        evs = []
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            dom = (str(rng.choice(list(domains)))
                   if EVENT_TABLE[kind] == "domain" else None)
            evs.append(DomainChaosEvent(
                tick=int(rng.integers(1, max(ticks, 2))), kind=kind,
                domain=dom, delay_ticks=delay_ticks,
                duration_ticks=duration_ticks, dup=dup))
        return cls(events=evs)

    def take(self, tick: int) -> list:
        due = [e for e in self.events if e.tick <= tick]
        if due:
            self.events = [e for e in self.events if e.tick > tick]
            self.fired.extend(due)
        return due
