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
chaos run emits the fault-free run's tokens.  The failure-domain and
watch-channel injector of the reference waits for the fleet.
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
