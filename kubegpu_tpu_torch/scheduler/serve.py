"""The serving control loop (counterpart of ``kubegpu_tpu/scheduler/
serve.py``, copied): the SLO-driven autoscaler that turns a replica pool's
serving signals into capacity decisions.

:class:`AutoscalePolicy` is the pure decision core: deterministic (a fixed
seed and signal sequence always yields the same action sequence),
denominated in engine ticks, and guarded by hysteresis (``hold_ticks``
pressure ticks in a row before growing, ``idle_ticks`` calm ticks before
shrinking) and a ``cooldown_ticks`` floor between any two actions.
Pressure is any of: the worst queued wait over the high watermark, SLO
attainment under the low watermark, or free-page headroom under the
floor.  :class:`ServingAutoscaler` binds the policy to a live pool (the
port's :class:`~kubegpu_tpu_torch.models.serve.DataParallelServePool` or
:class:`~kubegpu_tpu_torch.models.serve.DisaggServePool`) and, given a
scheduler, to the control plane: scale-up spawns a serving gang
(``scheduler.spawn_serving_gang``) before adding the replica, scale-down
retires the replica (the graceful drain through the replay parking) and
then evicts its gang without requeue.  ``scheduler`` and ``cluster`` are
duck-typed.

:func:`main` is the reference's standalone extender service: the
:mod:`.webhook` over ``SimCluster.from_config``; with ``--set
backend.type=nvml`` the cluster is this card node.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs of the deterministic autoscale policy — all thresholds in
    engine ticks or ratios of tick-pure signals."""
    min_replicas: int = 1
    max_replicas: int = 4
    queue_wait_high_ticks: float = 8.0   # max queued wait ⇒ pressure
    attainment_low: float = 0.9          # running SLO-met ⇒ pressure
    headroom_low_frac: float = 0.0       # free-page frac ⇒ pressure
    #   (0.0 disables the headroom trigger; enable for HBM-bound pools)
    hold_ticks: int = 3        # consecutive pressure ticks before +1
    idle_ticks: int = 8        # consecutive calm ticks before -1
    cooldown_ticks: int = 10   # min ticks between ANY two actions
    seed: int = 0              # jitters the cooldown deterministically
    cooldown_jitter_ticks: int = 0


class AutoscalePolicy:
    """Seeded, deterministic scale decision: feed it one signal tuple
    per tick, get back -1/0/+1.  Pure host arithmetic — no wall clock,
    no device state, no global RNG — so the same signal sequence
    yields the same action sequence bit-for-bit (the determinism the
    cb_autoscale bench and tier-1 tests gate)."""

    def __init__(self, cfg: AutoscaleConfig | None = None):
        self.cfg = cfg or AutoscaleConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        self._hot = 0      # consecutive pressure ticks
        self._calm = 0     # consecutive calm ticks
        self._next_ok = 0  # first tick the cooldown permits an action
        self.decisions: list[tuple[int, int]] = []  # (tick, action)

    def _cooldown(self) -> int:
        j = self.cfg.cooldown_jitter_ticks
        extra = int(self._rng.integers(0, j + 1)) if j > 0 else 0
        return self.cfg.cooldown_ticks + extra

    def decide(self, tick: int, n_active: int,
               queue_wait_ticks: float, attainment: float,
               headroom_frac: float = 1.0) -> int:
        """One control tick: +1 grow, -1 shrink, 0 hold."""
        c = self.cfg
        pressure = (queue_wait_ticks > c.queue_wait_high_ticks
                    or attainment < c.attainment_low
                    or headroom_frac < c.headroom_low_frac)
        if pressure:
            self._hot += 1
            self._calm = 0
        else:
            self._calm += 1
            self._hot = 0
        action = 0
        if tick >= self._next_ok:
            if (pressure and self._hot >= c.hold_ticks
                    and n_active < c.max_replicas):
                action = 1
            elif (not pressure and self._calm >= c.idle_ticks
                    and n_active > c.min_replicas):
                action = -1
        if action != 0:
            self._hot = self._calm = 0
            self._next_ok = tick + self._cooldown()
            self.decisions.append((tick, action))
        return action


class ServingAutoscaler:
    """Binds an :class:`AutoscalePolicy` to a live replica pool (and
    optionally the scheduler's gang path).  Callable with the
    ``run_load`` controller signature — ``autoscaler(tick, stats)`` —
    so the load harness drives the loop once per engine tick.

    Scale-up: ``scheduler.spawn_serving_gang`` (pod created, gang
    scheduled through the extender's normal pass) then
    ``pool.add_replica(gang=...)`` binds the fresh replica to that
    gang — from then on the health watch covers it like any original.
    Scale-down: pick the highest-index live replica (decode-role for a
    disaggregated pool), ``pool.retire_replica`` (graceful drain via
    bit-exact replay parking, processed at the pool's next step), then
    ``scheduler.evict_gang(..., requeue=False)`` tears the gang's pods
    down; the watch-delivered death is a no-op because the replica is
    already dead."""

    def __init__(self, pool, policy: AutoscalePolicy | None = None,
                 scheduler=None, cluster=None,
                 namespace: str = "default",
                 gang_prefix: str = "serve-asg",
                 chips_per_replica: int | None = None,
                 role: str = "decode"):
        self.pool = pool
        self.policy = policy or AutoscalePolicy()
        self.scheduler = scheduler
        self.cluster = cluster          # optional: tick the sim control
        self.namespace = namespace      # plane alongside the engine
        self.gang_prefix = gang_prefix
        self.chips = chips_per_replica or pool.tp
        self.role = role
        self.scale_ups = 0
        self.scale_downs = 0
        self.events: list[tuple[int, str, int]] = []  # (tick, dir, rep)

    # -- signal gathering (host-side reads, tick-pure) ------------------

    def _queue_wait_ticks(self) -> float:
        """Worst queued wait across live replicas, in that replica's
        own engine ticks — the head-of-line pressure signal."""
        worst = 0.0
        for j in self.pool._alive():
            eng = self.pool.replicas[j]
            for r, _ in eng.queue:
                worst = max(worst, float(eng._tick - r.submit_tick))
        return worst

    def _headroom_frac(self) -> float:
        """Min free-page fraction across live replicas (1.0 for
        unpaged engines) — the deterministic twin of HBM headroom
        (``serve_hbm_peak_bytes`` tracks the same pool, in bytes)."""
        worst = 1.0
        for j in self.pool._alive():
            eng = self.pool.replicas[j]
            if getattr(eng, "paged", False) and eng.total_pages:
                worst = min(worst,
                            eng._available_pages() / eng.total_pages)
        return worst

    # -- actuation ------------------------------------------------------

    def _gang_key(self, gang: str) -> str:
        return f"{self.namespace}/{gang}"

    def _scale_up(self, tick: int) -> None:
        gang = None
        if self.scheduler is not None:
            gang = f"{self.gang_prefix}{self.scale_ups}"
            self.scheduler.spawn_serving_gang(
                gang, chips=self.chips, namespace=self.namespace,
                role=self.role if hasattr(self.pool, "roles")
                else None)
        kw = {"role": self.role} if hasattr(self.pool, "roles") else {}
        i = self.pool.add_replica(gang=gang, **kw)
        self.scale_ups += 1
        self.events.append((tick, "up", i))

    def _scale_down(self, tick: int) -> None:
        alive = self.pool._alive()
        if hasattr(self.pool, "roles"):
            pool_roles = [j for j in alive
                          if self.pool.roles[j] == self.role]
            if len(pool_roles) < 2:
                return   # never retire a role's last replica
            victim = max(pool_roles)
        else:
            victim = max(alive)
        gang = next((g for g, j in self.pool._gang_replica.items()
                     if j == victim), None)
        self.pool.retire_replica(victim)
        if self.scheduler is not None and gang is not None:
            self.scheduler.evict_gang(self._gang_key(gang),
                                      "scale-down", requeue=False)
        self.scale_downs += 1
        self.events.append((tick, "down", victim))

    def __call__(self, tick: int, stats: dict) -> int:
        if self.cluster is not None:
            self.cluster.step()
        n_active = len(self.pool._alive())
        action = self.policy.decide(
            tick, n_active,
            queue_wait_ticks=self._queue_wait_ticks(),
            attainment=float(stats.get("attainment", 1.0)),
            headroom_frac=self._headroom_frac())
        if action > 0:
            self._scale_up(tick)
        elif action < 0:
            self._scale_down(tick)
        return action


def main(argv: list[str] | None = None) -> int:
    from kubegpu_tpu_torch.cluster import SimCluster
    from kubegpu_tpu_torch.config import KubeTpuConfig
    from kubegpu_tpu_torch.scheduler.webhook import (
        ExtenderHTTPServer,
        policy_config,
    )

    ap = argparse.ArgumentParser(
        prog="kubetpu-extender",
        description="HTTP scheduler-extender webhook (kube-scheduler "
        "filter/prioritize verbs)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8900)
    ap.add_argument("--advertise-url",
                    help="reachable URL for the printed policy stanza "
                    "(e.g. the Service DNS name); defaults to the bind "
                    "address, or the kube-system Service name when "
                    "binding 0.0.0.0")
    ap.add_argument("--config", help="config file (JSON/YAML)")
    ap.add_argument("--set", action="append", metavar="K.EY=VAL",
                    help="dotted config override, repeatable")
    ap.add_argument("--slices", nargs="+",
                    help="override cluster slice types")
    args = ap.parse_args(argv)

    cfg = KubeTpuConfig.load(args.config, args.set or [])
    if args.slices:
        cfg.backend.slice_types = args.slices
    cl = SimCluster.from_config(cfg)
    srv = ExtenderHTTPServer(cl.scheduler, host=args.host,
                             port=args.port).start()
    print(f"extender listening on {srv.address}", file=sys.stderr)
    # the stanza must carry an address kube-scheduler can REACH — the
    # bind address is wrong for 0.0.0.0 (that's kube-scheduler's own host)
    bound_port = srv.address.rsplit(":", 1)[1]   # actual port (ephemeral
    advertise = args.advertise_url or (          # binds resolve to real)
        f"http://kubetpu-extender.kube-system.svc:{bound_port}"
        if args.host == "0.0.0.0" else srv.address)
    print(json.dumps(policy_config(advertise), indent=2))
    try:
        import threading
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        cl.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
