"""Discrete-event FLEET harness: the real serving control plane over
simulated cost-model replicas (counterpart of ``kubegpu_tpu/fleet.py``;
the port keeps its own copy and imports nothing of the reference
package).

Exactly-once failover, preempt/drain replays and SLO-driven autoscaling
are proven on one to four real engines, too few for the failure modes
that dominate a fleet: correlated loss of a whole slice/rack/zone,
rolling upgrade waves, and the control plane itself dying mid-trace.
This module scales the PROOF without scaling the hardware:

- :class:`SimReplicaEngine` is a cost model with the ``ContinuousBatcher``
  surface the pool layer touches (admission queue, slot residency,
  paged-pool accounting, prefix registry, chaos consult, orphan stash,
  export/import for disaggregated migration).  It never touches a device.
  Its cost model (:class:`ReplicaCosts`) is given by the caller, e.g.
  from a measured engine tick and prefill; :meth:`ReplicaCosts.from_bench`
  parses bench rows of the reference's layout.  Tokens are a pure
  function of the full token sequence so far (a running ``zlib.crc32``
  over the int32 byte stream), so a failover replay submitted as
  ``prompt ++ accepted`` continues BIT-EXACTLY, the property every
  exactly-once gate leans on.
- :class:`FleetPool` / :class:`FleetDisaggPool` are the port's REAL
  :class:`~kubegpu_tpu_torch.models.serve.DataParallelServePool` /
  ``DisaggServePool`` with ONLY the engine factory (``_build_engine``)
  overridden and every replica on the ``meta`` device: every routing,
  admission, failover, drain and autoscale line above the engine runs
  unmodified over 100+ simulated replicas, on a host with no card.
- :func:`run_fleet` drives seeded diurnal/flash-crowd traces
  (:mod:`kubegpu_tpu_torch.loadgen`) through three robustness layers:
  correlated failure-domain chaos (``DomainChaosInjector``: whole-domain
  kills, watch-delivery delay/duplication/reorder/partition with stale
  reads), :class:`UpgradeWaveController` rolling upgrades (drain-wave
  retires through the standing replay parking, a surge budget holds a
  capacity floor), and :class:`ControlPlaneJournal` crash recovery (an
  append-only host-state log; a mid-trace control-plane kill rebuilds the
  pool and re-drives every in-flight request through the standing replay
  machinery in strict tier order: no lost, no duplicated, no tier
  inversion, outcomes identical to an uninterrupted twin).

Determinism: the trace, the chaos schedule and every token are pure
functions of seeds; the wall clock never orders anything.
"""
from __future__ import annotations

import glob
import json
import os
import time
import zlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from kubegpu_tpu_torch.loadgen import (LoadReport, TierSpec, _busy,
                                       _slo_met, score_run)
from kubegpu_tpu_torch.models.serve import (DataParallelServePool,
                                            DisaggServePool,
                                            _AdmissionQueue, _Request)
from kubegpu_tpu_torch.obs.chaos import (DOMAIN_EVICT, DOMAIN_KILL,
                                         FAIL_DISPATCH, KILL, NAN_LOGITS,
                                         STALL, WATCH_DELAY, WATCH_DUP,
                                         WATCH_PARTITION, WATCH_REORDER,
                                         ChaosEvent, ChaosInjector,
                                         ReplicaDeadError, TickStallError)
from kubegpu_tpu_torch.obs.cost import CostLedger

__all__ = ["ReplicaCosts", "FleetConfig", "SimReplicaEngine",
           "FleetPool", "FleetDisaggPool", "FleetTopology",
           "UpgradeWaveController", "ControlPlaneJournal",
           "FleetReport", "run_fleet", "compare_outcomes"]


# -- calibration --------------------------------------------------------

@dataclass(frozen=True)
class ReplicaCosts:
    """Per-replica cost model: one decode stride-block's wall time,
    prefill time a token, and the page-chain migration handoff.  These
    drive the simulated wall clock (``sim_ms``, reported beside the
    deterministic numbers, never ordering anything); the prefill tick
    count (what affinity routing saves) comes from ``FleetConfig``."""
    block_ms: float = 2.0
    prefill_ms_per_token: float = 0.01
    migration_ms: float = 0.5

    @classmethod
    def from_bench(cls, root: str = ".") -> "ReplicaCosts":
        """Parse ``BENCH_r0x.json`` files of the reference's bench layout
        under ``root`` (``parsed.details.model.serving``:
        ``decode_tokens_per_s`` at a ``batch``, ``prefill_tokens_per_s``);
        missing files or keys fall back to the defaults.  Calibration
        changes ``sim_ms``, never the deterministic schedule."""
        block_ms = cls.block_ms
        prefill = cls.prefill_ms_per_token
        for path in sorted(glob.glob(os.path.join(root,
                                                  "BENCH_r0*.json"))):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            sv = ((((doc.get("parsed") or {}).get("details") or {})
                   .get("model") or {}).get("serving") or {})
            tps = sv.get("decode_tokens_per_s")
            batch = sv.get("batch")
            if tps and batch:
                block_ms = 1000.0 * float(batch) / float(tps)
            ptps = sv.get("prefill_tokens_per_s")
            if ptps:
                prefill = 1000.0 / float(ptps)
        return cls(block_ms=block_ms, prefill_ms_per_token=prefill,
                   migration_ms=cls.migration_ms)


@dataclass(frozen=True)
class FleetConfig:
    """Simulated replica shape — the knobs the pool layer reads
    (``page_size``/``total_pages`` feed routing and autoscale
    headroom) plus the cost model."""
    vocab: int = 64
    n_slots: int = 4
    page_size: int = 4
    total_pages: int = 96
    max_len: int = 96
    registry_cap: int = 64
    page_bytes: int = 2048
    prefill_tokens_per_tick: int = 8
    costs: ReplicaCosts = ReplicaCosts()


def _next_token(crc: int, vocab: int) -> int:
    """The simulated model: next token = f(running crc32 of the full
    int32 byte stream so far).  ``crc32(b, crc32(a)) == crc32(a+b)``,
    so a replay submitted as ``prompt ++ accepted`` resumes the SAME
    running state a fault interrupted — greedy replay is bit-exact by
    construction, exactly like the real engine."""
    return crc % (vocab - 1) + 1


# -- the simulated replica ---------------------------------------------

class SimReplicaEngine:
    """Cost-model replica with the ``ContinuousBatcher`` surface the
    pool/autoscaler/loadgen layers touch.  Admission is strict-tier
    (FIFO within a tier via ``seq``) from a sorted
    ``_AdmissionQueue``; prefill costs ticks proportional to
    NON-CACHED prompt tokens (prefix-registry hits shorten it — the
    effect affinity routing exploits); decode emits one token per
    resident slot per tick.  The engine consults its per-replica
    :class:`~kubegpu_tpu_torch.obs.chaos.ChaosInjector` at every tick
    boundary with the real engine's contract: kills raise
    :class:`ReplicaDeadError` AFTER the tick's finishers moved to the
    orphan stash (exactly-once), NaN quarantine re-queues the victim
    as prompt + accepted, dispatch failures retry in place."""

    def __init__(self, cfg: FleetConfig, metrics=None, chaos=None):
        self.cfg = cfg
        self.paged = True
        self.prefix_cache_enabled = True
        self.page_size = cfg.page_size
        self.total_pages = cfg.total_pages
        self.n_slots = cfg.n_slots
        self.max_len = cfg.max_len
        self.spec_gamma = 0
        self.eos_id = None
        self.dead: str | None = None
        self.chaos = chaos
        self._metrics = metrics
        self._engine_anchor = None
        self.queue = _AdmissionQueue()
        self.slot_req: dict[int, object] = {}      # slot → _Request
        self._prefill_left: dict[int, int] = {}    # slot → ticks left
        self._slot_pages: dict[int, int] = {}
        self._crc: dict[int, int] = {}             # local rid → state
        self._prefix_cache: OrderedDict = OrderedDict()
        self._prefilling: dict = {}                # loadgen._busy probe
        self._failed: list = []
        self._orphans: list = []
        self._exports: dict[int, dict] = {}
        self._migrate_out: set[int] = set()
        self._next_rid = 0
        self._seq = 0
        self._tick = 0
        self._step_count = 0
        # accounting surface the pool aggregates
        self.emitted_tokens = 0
        self.prefill_waves = 0
        self.slot_steps = 0
        self._decode_tokens = 0
        self.stall_ms: list[float] = []
        self.slots_quarantined = 0
        self.dispatch_failures = 0
        self.requests_retried = 0
        self.requests_shed = 0
        self.requests_preempted = 0
        self.requests_resumed = 0
        self.deadline_misses = 0
        self.shed_by_reason: dict[str, int] = {}
        self.spec_drafts_proposed = 0
        self.spec_drafts_accepted = 0
        self.hbm_peak_bytes = 0
        self.sim_ms = 0.0           # cost-model wall clock (weather)
        # chip-tick attribution: one chip-tick per busy
        # engine tick (tp=1 in the sim), charged pro-rata by work
        # units to the resident (tenant, tier) keys; busy_ticks is
        # the independent counter the conservation law checks against
        self.cost = CostLedger()
        self.busy_ticks = 0
        # audit trail for the tier-ordering gate: (tick, tier, seq)
        # per admission, plus a counter that trips if an admission
        # ever jumps a strictly-more-critical queued request
        self.admission_log: list[tuple[int, int, int]] = []
        self.tier_inversions = 0

    # -- capacity ------------------------------------------------------

    def _pages_for(self, t: int, remaining: int) -> int:
        return -(-(t + remaining) // self.page_size)

    def _available_pages(self) -> int:
        return self.total_pages - sum(self._slot_pages.values())

    @property
    def hbm_pool_bytes(self) -> int:
        return ((self.total_pages - self._available_pages())
                * self.cfg.page_bytes)

    def warmup(self) -> None:
        return None

    # -- submit --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_s: float | None = None,
               migrate_out: bool = False, tier: int = 0,
               tenant: str = "",
               deadline_ticks: int | None = None) -> int:
        if self.dead is not None:
            raise ReplicaDeadError(self.dead)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if tier < 0:
            raise ValueError(f"tier must be >= 0, got {tier}")
        prompt_np = np.asarray(prompt, np.int32)
        t = int(prompt_np.shape[0])
        if t < 1:
            raise ValueError("prompt must have at least one token")
        if t + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {t} + max_new {max_new_tokens} > "
                f"max_len {self.max_len}")
        if self._pages_for(t, max_new_tokens) > self.total_pages:
            raise ValueError(
                f"request needs {self._pages_for(t, max_new_tokens)} "
                f"pages but the pool has only {self.total_pages}")
        # the port engine's and pool router's chain-hash scheme (over the
        # prompt's int64 bytes); tokens keep the int32 stream
        n_cacheable = (t - 1) // self.page_size
        p64 = prompt_np.astype(np.int64)
        keys = tuple(
            hash(p64[:(i + 1) * self.page_size].tobytes())
            for i in range(n_cacheable))
        req = _Request(rid=self._next_rid, prompt_len=t,
                       max_new_tokens=max_new_tokens,
                       temperature=float(temperature),
                       prefix_keys=keys, prompt=prompt_np,
                       admit_len=t, tier=int(tier),
                       tenant=str(tenant), seq=self._seq)
        req.submit_tick = self._tick
        if deadline_ticks is not None:
            req.deadline_tick = self._step_count + int(deadline_ticks)
        self._next_rid += 1
        self._seq += 1
        if migrate_out:
            self._migrate_out.add(req.rid)
        self.queue.append((req, prompt_np))
        return req.rid

    # -- cancel / orphan / export surface ------------------------------

    def _release(self, slot: int, req) -> None:
        self._slot_pages.pop(slot, None)
        self._prefill_left.pop(slot, None)
        self._crc.pop(req.rid, None)

    def cancel(self, rid: int, reason: str = "canceled"):
        for i, (r, _) in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                r.done, r.error = True, reason
                return r
        for slot, r in list(self.slot_req.items()):
            if r.rid == rid:
                self.slot_req.pop(slot)
                self._release(slot, r)
                r.done, r.error = True, reason
                return r
        return None

    def take_orphans(self) -> list:
        out, self._orphans = self._orphans, []
        return out

    def take_export(self, rid: int) -> dict | None:
        return self._exports.pop(rid, None)

    def import_chain(self, export: dict, max_new_tokens: int,
                     temperature: float = 0.0, tier: int = 0,
                     tenant: str = "") -> int | None:
        """Adopt a migrated chain (sim format: running crc travels
        with the first token, so decode resumes bit-exactly).  Returns
        the local rid or None when no slot/pages are free."""
        if self.dead is not None:
            raise ReplicaDeadError(f"replica dead: {self.dead}")
        if max_new_tokens < 2:
            raise ValueError(
                "import_chain needs max_new_tokens >= 2 — a satisfied "
                "request retires at its prefill replica")
        if int(export["page_size"]) != self.page_size:
            raise ValueError(
                f"page-size mismatch: chain {export['page_size']} vs "
                f"pool {self.page_size}")
        t = int(export["t"])
        need = self._pages_for(t, max_new_tokens)
        slot = next((s for s in range(self.n_slots)
                     if s not in self.slot_req), None)
        if slot is None or self._available_pages() < need:
            return None
        req = _Request(rid=self._next_rid, prompt_len=t,
                       max_new_tokens=max_new_tokens,
                       temperature=float(temperature),
                       prefix_keys=tuple(export["keys"]),
                       prompt=np.asarray(export["prompt_np"],
                                         np.int32),
                       admit_len=t, tier=int(tier),
                       tenant=str(tenant), seq=self._seq)
        req.tokens = list(export["tokens"])
        req.submit_tick = self._tick
        req.first_tick = self._tick
        self._next_rid += 1
        self._seq += 1
        self.slot_req[slot] = req
        self._slot_pages[slot] = need
        self._crc[req.rid] = int(export["crc"])
        self._register_keys(req.prefix_keys)
        self.sim_ms += self.cfg.costs.migration_ms
        return req.rid

    # -- the tick ------------------------------------------------------

    def _registry_hit(self, keys: tuple) -> int:
        hit = 0
        for k in keys:
            if k not in self._prefix_cache:
                break
            self._prefix_cache.move_to_end(k)
            hit += 1
        return hit

    def _register_keys(self, keys: tuple) -> None:
        for k in keys:
            self._prefix_cache[k] = True
            self._prefix_cache.move_to_end(k)
        while len(self._prefix_cache) > self.cfg.registry_cap:
            self._prefix_cache.popitem(last=False)

    def _quarantine_one(self) -> None:
        """NaN-poison response: re-queue the lowest resident slot's
        request as prompt + accepted (the engine-internal replay)."""
        if not self.slot_req:
            return
        slot = min(self.slot_req)
        req = self.slot_req.pop(slot)
        self._release(slot, req)
        replay = (np.concatenate([req.prompt,
                                  np.asarray(req.tokens, np.int32)])
                  if req.tokens else req.prompt)
        req.admit_len = int(replay.shape[0])
        req.retries += 1
        self.slots_quarantined += 1
        self.requests_retried += 1
        self.queue.append((req, replay))

    def step(self) -> list:
        if self.dead is not None:
            raise ReplicaDeadError(self.dead)
        kill_ev = None
        if self.chaos is not None:
            for ev in self.chaos.take(self._tick):
                if ev.kind == FAIL_DISPATCH:
                    # transient: the retry re-runs identical math
                    self.dispatch_failures += 1
                elif ev.kind == NAN_LOGITS:
                    if self.slot_req:
                        self._quarantine_one()
                    else:
                        self.chaos.defer(ev, self._tick + 1)
                elif ev.kind in (KILL, STALL):
                    kill_ev = ev
        finished: list = []
        # admission: strict tier, FIFO within (deadline_tick, seq) —
        # sorted rebuild keeps the _AdmissionQueue token counter exact
        if self.queue:
            items = sorted(self.queue, key=lambda it: (
                it[0].tier,
                it[0].deadline_tick if it[0].deadline_tick is not None
                else 1 << 62,
                it[0].seq))
            self.queue.clear()
            self.queue.extend(items)
        while self.queue and len(self.slot_req) < self.n_slots:
            req, pnp = self.queue[0]
            need = self._pages_for(req.admit_len, req.remaining_new)
            if need > self._available_pages():
                break   # strict head-of-line: never jump the order
            self.queue.popleft()
            if any(q.tier < req.tier for q, _ in self.queue):
                self.tier_inversions += 1   # must never happen
            self.admission_log.append((self._tick, req.tier, req.seq))
            slot = next(s for s in range(self.n_slots)
                        if s not in self.slot_req)
            self.slot_req[slot] = req
            self._slot_pages[slot] = need
            self._crc[req.rid] = zlib.crc32(pnp.tobytes())
            hit = self._registry_hit(req.prefix_keys)
            cold = max(1, req.admit_len - hit * self.page_size)
            self._prefill_left[slot] = -(-cold
                                         // self.cfg
                                         .prefill_tokens_per_tick)
            self.prefill_waves += 1
            self.sim_ms += cold * self.cfg.costs.prefill_ms_per_token
            self._register_keys(req.prefix_keys)
        # prefill progress + decode: one token per READY slot per tick
        if self.slot_req:
            self.sim_ms += self.cfg.costs.block_ms
            # chip-tick attribution, charged BEFORE the
            # decode loop consumes _prefill_left so a prefilling
            # slot's weight is its prefill work this tick
            self.busy_ticks += 1
            self.cost.charge(
                [(r.tenant, r.tier,
                  self.cfg.prefill_tokens_per_tick
                  if self._prefill_left.get(s, 0) > 0 else 1)
                 for s, r in sorted(self.slot_req.items())], 1)
        for slot in sorted(self.slot_req):
            req = self.slot_req[slot]
            if self._prefill_left.get(slot, 0) > 0:
                self._prefill_left[slot] -= 1
                if self._prefill_left[slot] > 0:
                    continue
                self._prefill_left.pop(slot)
                if req.first_tick < 0:
                    req.first_tick = self._tick
            crc = self._crc[req.rid]
            tok = _next_token(crc, self.cfg.vocab)
            self._crc[req.rid] = zlib.crc32(
                np.int32(tok).tobytes(), crc)
            req.tokens.append(tok)
            if req.first_tick < 0:
                req.first_tick = self._tick
            self.emitted_tokens += 1
            self._decode_tokens += 1
            self.slot_steps += 1
            if len(req.tokens) >= req.max_new_tokens:
                req.done = True
                req.finish_tick = self._tick
                self.slot_req.pop(slot)
                if req.rid in self._migrate_out:
                    self._migrate_out.discard(req.rid)
                    self._exports[req.rid] = {
                        "page_size": self.page_size,
                        "t": req.admit_len,
                        "pages": self._slot_pages.get(slot, 0),
                        "prompt_np": req.prompt,
                        "tokens": list(req.tokens),
                        "crc": self._crc[req.rid],
                        "keys": req.prefix_keys,
                    }
                self._release(slot, req)
                finished.append(req)
        self.hbm_peak_bytes = max(self.hbm_peak_bytes,
                                  self.hbm_pool_bytes)
        self._tick += 1
        self._step_count += 1
        if kill_ev is not None:
            # finishers of the dying step go to the orphan stash so
            # the pool's failover NEVER replays a completed request
            self._orphans.extend(finished)
            self.dead = f"chaos {kill_ev.kind} at tick {self._tick - 1}"
            if kill_ev.kind == STALL:
                raise TickStallError(self.dead)
            raise ReplicaDeadError(self.dead)
        return finished


# -- the fleet pools ----------------------------------------------------

def _virtual_devices(n: int) -> list:
    """``n`` device slots for simulated replicas: the ``meta`` device,
    which holds no memory, so the pool's device bookkeeping (one block a
    replica, reused after a death) runs while nothing touches a card."""
    return [torch.device("meta")] * n


class _SimEngineFactory:
    """Override of the pool's single engine-construction seam: every
    routing/admission/failover/autoscale line above runs unmodified."""

    def _build_engine(self, i: int):
        return SimReplicaEngine(self._cfg, metrics=self._metrics,
                                chaos=self._chaos.get(i))


class FleetPool(_SimEngineFactory, DataParallelServePool):
    """The REAL DataParallelServePool over simulated replicas.
    ``max_replicas`` caps total replica identities (device blocks are
    virtual, on the ``meta`` device) so autoscale/upgrade surge has
    room."""

    def __init__(self, cfg: FleetConfig | None = None, dp: int = 1,
                 max_replicas: int | None = None, metrics=None,
                 chaos=None, routing: str = "affinity",
                 max_replays: int = 2):
        cap = max(max_replicas or dp, dp)
        super().__init__(params=None, cfg=cfg or FleetConfig(),
                         dp=dp, tp=1, devices=_virtual_devices(cap),
                         metrics=metrics, max_replays=max_replays,
                         chaos=chaos, routing=routing)


class FleetDisaggPool(_SimEngineFactory, DisaggServePool):
    """The REAL DisaggServePool (prefill/decode roles, page-chain
    migration) over simulated replicas."""

    def __init__(self, cfg: FleetConfig | None = None,
                 prefill: int = 1, decode: int = 1,
                 max_replicas: int | None = None, metrics=None,
                 chaos=None, routing: str = "affinity",
                 max_replays: int = 2):
        n = prefill + decode
        cap = max(max_replicas or n, n)
        super().__init__(None, cfg or FleetConfig(),
                         prefill=prefill, decode=decode, tp=1,
                         devices=_virtual_devices(cap),
                         metrics=metrics, max_replays=max_replays,
                         chaos=chaos, routing=routing)


# -- topology -----------------------------------------------------------

class FleetTopology:
    """Replica → failure-domain map (slice/rack/zone — one level; the
    DOMAIN is the correlated-failure unit).  Replicas added later
    (autoscale backfill, upgrade surge) are assigned via
    :meth:`assign`."""

    def __init__(self, domains: dict[str, list[int]]):
        self.domains = {name: list(m) for name, m in domains.items()}

    @classmethod
    def grid(cls, n_replicas: int, n_domains: int,
             kind: str = "rack") -> "FleetTopology":
        per = -(-n_replicas // n_domains)
        doms = {}
        for d in range(n_domains):
            members = list(range(d * per, min((d + 1) * per,
                                              n_replicas)))
            if members:
                doms[f"{kind}{d}"] = members
        return cls(doms)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.domains)

    def members(self, name: str) -> list[int]:
        return list(self.domains.get(name, ()))

    def assign(self, replica: int, name: str) -> None:
        self.domains.setdefault(name, [])
        if replica not in self.domains[name]:
            self.domains[name].append(replica)

    def domain_of(self, replica: int) -> str | None:
        for name, members in self.domains.items():
            if replica in members:
                return name
        return None


# -- watch channel (health-delivery weather) ----------------------------

class _WatchChannel:
    """Health-watch delivery channel between the chaos layer and
    ``pool.observe_gang_eviction`` — the seam where watch-scope chaos
    (delay, duplication, reorder, partition/stale-reads) is injected.
    Deliveries are (due_tick, issue_seq) ordered; a partition buffers
    everything until heal — the stale-read window where routing still
    targets condemned replicas."""

    def __init__(self, pool):
        self.pool = pool
        self._pending: list[tuple[int, int, str, str]] = []
        self._issue_seq = 0
        self._windows: list[tuple[int, str, int]] = []
        self._partition_until = -1
        self.delivered = 0

    def apply(self, ev, tick: int) -> None:
        until = tick + max(1, int(ev.duration_ticks))
        if ev.kind == WATCH_DELAY:
            self._windows.append((until, "delay",
                                  max(0, int(ev.delay_ticks))))
        elif ev.kind == WATCH_DUP:
            self._windows.append((until, "dup", max(1, int(ev.dup))))
        elif ev.kind == WATCH_REORDER:
            self._windows.append((until, "reorder", 1))
        elif ev.kind == WATCH_PARTITION:
            self._partition_until = max(self._partition_until, until)

    def _active(self, tick: int, kind: str, default: int) -> int:
        vals = [v for until, k, v in self._windows
                if k == kind and tick < until]
        return max(vals) if vals else default

    def emit(self, tick: int, gang: str, reason: str) -> None:
        delay = self._active(tick, "delay", 0)
        for _ in range(self._active(tick, "dup", 1)):
            self._pending.append((tick + delay, self._issue_seq,
                                  gang, reason))
            self._issue_seq += 1

    def pump(self, tick: int) -> None:
        if tick < self._partition_until:
            return   # partitioned: stale reads until heal
        due = [p for p in self._pending if p[0] <= tick]
        if not due:
            return
        self._pending = [p for p in self._pending if p[0] > tick]
        due.sort(key=lambda p: (p[0], p[1]),
                 reverse=bool(self._active(tick, "reorder", 0)))
        for _, _, gang, reason in due:
            # duplicates / late deliveries for already-failed-over
            # replicas are idempotent no-ops inside the pool
            self.pool.observe_gang_eviction(gang, reason)
            self.delivered += 1

    @property
    def idle(self) -> bool:
        return not self._pending


# -- rolling upgrades ---------------------------------------------------

class UpgradeWaveController:
    """Drain-wave rolling upgrade: retire each failure domain's
    replicas in domain-sized batches through the pool's replay-parking
    drain, with a SURGE budget (extra new-generation replicas added
    first) so live capacity never drops below ``floor``.  Retired
    replicas are backfilled by new-generation replicas at wave end, so
    the fleet exits every wave at nominal size, fully upgraded."""

    def __init__(self, pool, topology: FleetTopology, *, floor: int,
                 surge: int = 1, start_tick: int = 0,
                 gang_namer=None, metrics=None):
        self.pool = pool
        self.topology = topology
        self.floor = int(floor)
        self.surge = int(surge)
        self.start_tick = int(start_tick)
        self._waves = deque((name, list(members))
                            for name, members in
                            topology.domains.items())
        self._phase = "idle"
        self._targets: list[int] = []
        self._retiring: list[int] = []
        self._wave_name = ""
        self._credit = 0        # surge replicas not yet consumed
        self._gen_serial = 0
        self.waves_done = 0
        self.upgraded: list[int] = []
        self.min_alive: int | None = None
        self._namer = gang_namer or (
            lambda k: f"fleet/upgrade-g{k}")
        self._metrics = metrics

    @property
    def done(self) -> bool:
        return not self._waves and self._phase == "idle"

    def _add_new_gen(self, domain: str) -> int:
        gang = self._namer(self._gen_serial)
        self._gen_serial += 1
        i = self.pool.add_replica(gang=gang)
        self.topology.assign(i, f"{domain}@gen1")
        self.upgraded.append(i)
        return i

    def on_tick(self, tick: int) -> None:
        alive = self.pool._alive()
        self.min_alive = (len(alive) if self.min_alive is None
                          else min(self.min_alive, len(alive)))
        if tick < self.start_tick or self.done:
            return
        if self._phase == "idle":
            name, members = self._waves[0]
            self._wave_name = name
            self._targets = [i for i in members
                             if i not in self.pool.dead_replicas]
            self._retiring = []
            if not self._targets:
                self._waves.popleft()
                return
            # surge FIRST: capacity may never dip below the floor
            # while a domain-sized batch drains.  The surge replicas
            # are a CREDIT against later backfill, so the wave still
            # exits at nominal fleet size.
            want = min(self.surge, len(self._targets))
            for _ in range(want):
                self._add_new_gen(name)
                self._credit += 1
            self._phase = "retire"
            return
        if self._phase == "retire":
            alive_n = len(self.pool._alive())
            budget = max(0, alive_n - self.floor)
            batch = [i for i in self._targets[:budget]]
            if not batch:
                return   # wait for drains to free budget
            for i in batch:
                self.pool.retire_replica(i)
                self._retiring.append(i)
            self._targets = self._targets[len(batch):]
            self._phase = "wait"
            return
        if self._phase == "wait":
            if any(i not in self.pool.dead_replicas
                   for i in self._retiring):
                return   # still draining through replay parking
            # backfill AS EACH BATCH DRAINS (consuming surge credit
            # first) — waiting until wave end would starve the retire
            # budget whenever a batch drains capacity down to the
            # floor exactly, wedging the wave
            drained = len(self._retiring)
            self._retiring = []
            use = min(self._credit, drained)
            self._credit -= use
            for _ in range(drained - use):
                self._add_new_gen(self._wave_name)
            if self._targets:
                self._phase = "retire"
                return
            self._waves.popleft()
            self.waves_done += 1
            if self._metrics is not None:
                self._metrics.inc("serve_upgrade_waves_total")
            self._phase = "idle"


# -- control-plane journal ---------------------------------------------

class ControlPlaneJournal:
    """Append-only control-plane log: the request ledger (submit /
    finish per global rid, with tier), routing placements, scale
    actions, and crash/recovery marks.  Recovery = rebuild the pool at
    the journaled size and re-drive every in-flight request (submitted
    minus finished) through the standing replay machinery in strict
    ``(tier, rid)`` order — tier ordering survives the crash by
    construction, and the deterministic token function makes the
    recovered outcomes identical to an uninterrupted twin."""

    def __init__(self):
        self.records: list[dict] = []

    def append(self, kind: str, **payload) -> dict:
        rec = {"kind": kind, **payload}
        self.records.append(rec)
        return rec

    def _rids(self, kind: str) -> set:
        return {r["gid"] for r in self.records
                if r["kind"] == kind and "gid" in r}

    def inflight(self) -> list[int]:
        """Submitted-but-unfinished global rids, the re-drive set."""
        return sorted(self._rids("submit") - self._rids("finish"))

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for r in self.records:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out


# -- the fleet run loop -------------------------------------------------

@dataclass
class FleetReport:
    """One fleet run's verdict: the standard goodput/SLO scoring
    (``load`` — scored by loadgen's own predicate) plus the
    fleet-layer audit trail the robustness gates assert on."""
    load: LoadReport
    replicas: int = 0
    domains: int = 0
    domain_kills: int = 0
    domain_evictions: int = 0
    killed_replicas: int = 0
    upgrade_waves: int = 0
    upgraded_replicas: int = 0
    recoveries: int = 0
    redriven: int = 0
    tier_inversions: int = 0
    min_alive: int = 0
    watch_delivered: int = 0
    journal_records: int = 0
    failovers: int = 0
    sim_ms: float = 0.0
    # chip-tick cost attribution: the fleet-wide ledger
    # (closed pools merged in), plus the independent busy-tick count
    # the exact conservation law is checked against
    busy_chip_ticks: int = 0
    busy_ticks: int = 0
    cost_by_key: dict = field(default_factory=dict)

    def cost_summary(self) -> dict:
        """Goodput-per-chip-tick per (tenant, tier) — delegates to
        the scored :class:`LoadReport`, which carries the same ledger
        fields."""
        return self.load.cost_summary()


def compare_outcomes(a: LoadReport, b: LoadReport) -> dict:
    """Per-request outcome equality between two runs of the SAME
    trace: completion status, error-ness, and the full token stream
    must match request for request (rids are trace-stable).  SLO
    stamps are excluded on purpose — a failover replay lands later by
    design; what must never change is WHAT was generated."""
    ra = {r["rid"]: r for r in a.records}
    rb = {r["rid"]: r for r in b.records}
    mismatched = []
    for rid in sorted(set(ra) | set(rb)):
        x, y = ra.get(rid), rb.get(rid)
        if (x is None or y is None
                or x["completed"] != y["completed"]
                or (x["error"] is None) != (y["error"] is None)
                or list(x["tokens"]) != list(y["tokens"])):
            mismatched.append(rid)
    return {"identical": not mismatched,
            "mismatched": len(mismatched),
            "checked": len(set(ra) | set(rb))}


def run_fleet(trace: list[dict], tiers: tuple[TierSpec, ...], *,
              cfg: FleetConfig | None = None, replicas: int = 64,
              domains: int = 4, domain_kind: str = "rack",
              topology: FleetTopology | None = None, chaos=None,
              engine_chaos=None, upgrade: bool = False,
              upgrade_floor: int | None = None, upgrade_surge: int = 2,
              upgrade_start: int = 8, journal=None,
              crash_at: int | None = None, controller=None,
              metrics=None, routing: str = "affinity",
              max_replays: int = 4,
              max_ticks: int = 20_000) -> FleetReport:
    """Drive ``trace`` through the REAL pool code over ``replicas``
    simulated engines, open-loop, one ``pool.step()`` per tick, with
    the three robustness layers composed in:

    - ``chaos`` (a ``DomainChaosInjector``): domain kills mark every
      member engine dead in the SAME tick (the pool discovers them
      via its normal failover paths) and emit watch evictions through
      a delivery channel whose weather (delay/dup/reorder/partition)
      the injector also schedules; domain evictions travel ONLY via
      the watch — a delayed delivery is a stale-read window.
    - ``upgrade``: an :class:`UpgradeWaveController` rolls every
      domain through the replay-parking drain under a surge budget.
    - ``crash_at`` + ``journal``: at that tick the control plane dies
      — the pool object and all host state are discarded — and
      recovery rebuilds a fresh pool at the journaled size, re-driving
      every in-flight request in strict (tier, rid) order.

    Scoring goes through loadgen's own :func:`score_run`, so lost /
    duplicated / goodput mean exactly what they mean everywhere else.
    """
    cfg = cfg or FleetConfig()
    topo = topology or FleetTopology.grid(replicas, domains,
                                          domain_kind)
    gang_of: dict[int, str] = {}
    pool_gen = [0]

    def _mk_pool(dp: int):
        cap = dp + (upgrade_surge if upgrade else 0) + 8
        p = FleetPool(cfg, dp=dp, max_replicas=cap, metrics=metrics,
                      chaos=engine_chaos, routing=routing,
                      max_replays=max_replays)
        gang_of.clear()
        for i in range(dp):
            g = f"fleet/gen{pool_gen[0]}-g{i}"
            gang_of[i] = g
            p.bind_replica_gang(i, g)
        pool_gen[0] += 1
        return p

    pool = _mk_pool(replicas)
    watch = _WatchChannel(pool)
    upg = (UpgradeWaveController(pool, topo, floor=upgrade_floor
                                 or max(1, replicas - replicas
                                        // max(1, domains)),
                                 surge=upgrade_surge,
                                 start_tick=upgrade_start,
                                 metrics=metrics)
           if upgrade else None)

    meta: dict[int, dict] = {}      # global rid (trace idx) → item
    seen: dict[int, int] = {}
    done_map: dict[int, object] = {}
    rid_map: dict[int, int] = {}    # CURRENT pool rid → global rid
    rep = FleetReport(load=None, replicas=replicas,
                      domains=len(topo.names))
    min_alive = replicas
    tier_inv_closed = 0             # from pools already torn down
    failovers_closed = 0
    sim_ms_closed = 0.0
    cost_closed = CostLedger()      # chip-ticks of torn-down pools
    busy_ticks_closed = 0
    n_ok = n_fail = n_met = 0
    crashed = False
    i = 0
    tick = 0
    t0 = time.perf_counter()
    while tick < max_ticks:
        # 1. control-plane crash + journal recovery
        if (crash_at is not None and not crashed and tick >= crash_at
                and journal is not None):
            crashed = True
            journal.append("crash", tick=tick)
            alive_n = max(1, len(pool._alive()))
            tier_inv_closed += sum(e.tier_inversions
                                   for e in pool.replicas)
            failovers_closed += pool.failovers
            sim_ms_closed += sum(e.sim_ms for e in pool.replicas)
            # the chips the dead control plane's pool burned were
            # real spend: close its ledger into the run total so the
            # conservation law survives the crash boundary
            cost_closed.merge(pool.cost)
            busy_ticks_closed += pool.busy_ticks
            # the control plane is DEAD: pool, router digests, entry
            # ledger, watch channel — all host state is gone
            pool = _mk_pool(alive_n)
            watch = _WatchChannel(pool)
            topo = FleetTopology.grid(alive_n, domains, domain_kind)
            rid_map = {}
            rep.recoveries += 1
            if metrics is not None:
                metrics.inc("serve_ctrl_recoveries_total")
            # re-drive in-flight work through the STANDING submit
            # path, strict (tier, rid) order — no tier inversion
            # across the recovery boundary
            redo = sorted((g for g in meta if g not in done_map),
                          key=lambda g: (meta[g]["tier"], g))
            for g in redo:
                it = meta[g]
                prid = pool.submit(it["prompt"], it["max_new"],
                                   tier=it["tier"],
                                   tenant=it["tenant"])
                rid_map[prid] = g
                journal.append("resubmit", gid=g, tier=it["tier"],
                               tick=tick)
            rep.redriven += len(redo)
            journal.append("recovered", tick=tick,
                           replicas=alive_n, inflight=len(redo))
        # 2. correlated chaos
        if chaos is not None:
            for ev in chaos.take(tick):
                if ev.kind == DOMAIN_KILL:
                    rep.domain_kills += 1
                    if metrics is not None:
                        metrics.inc("serve_domain_kills_total")
                    for r_i in topo.members(ev.domain):
                        if (r_i < len(pool.replicas)
                                and r_i not in pool.dead_replicas
                                and pool.replicas[r_i].dead is None):
                            # schedule an engine-level kill at the
                            # member's CURRENT tick: the whole domain
                            # dies in this one pool step, but each
                            # death surfaces through the pool's
                            # normal failover discovery — exactly how
                            # a real correlated host loss lands
                            eng = pool.replicas[r_i]
                            if eng.chaos is None:
                                eng.chaos = ChaosInjector(events=[])
                            eng.chaos.events.append(ChaosEvent(
                                tick=eng._tick, kind=KILL))
                            rep.killed_replicas += 1
                            if r_i in gang_of:
                                watch.emit(tick, gang_of[r_i],
                                           f"domain {ev.domain} "
                                           f"killed")
                elif ev.kind == DOMAIN_EVICT:
                    rep.domain_evictions += 1
                    for r_i in topo.members(ev.domain):
                        if r_i in gang_of:
                            watch.emit(tick, gang_of[r_i],
                                       f"domain {ev.domain} evicted")
                else:
                    watch.apply(ev, tick)
        # 3. watch deliveries due this tick (weather applied)
        watch.pump(tick)
        # 4. arrivals — a submit that lands on a dead-but-undetected
        # replica (the stale-read window) fails like the real RPC
        # would; the arrival retries next tick, after failover
        while i < len(trace) and trace[i]["arrival_tick"] <= tick:
            item = trace[i]
            gid = i
            try:
                prid = pool.submit(item["prompt"], item["max_new"],
                                   tier=item["tier"],
                                   tenant=item["tenant"])
            except ReplicaDeadError:
                break
            rid_map[prid] = gid
            meta[gid] = item
            if journal is not None:
                journal.append("submit", gid=gid, tier=item["tier"],
                               tick=tick,
                               replica=pool._entries[prid].replica)
            i += 1
        # 5. one control-plane tick
        for r in pool.step():
            gid = rid_map.get(r.rid)
            if gid is None:
                continue
            seen[gid] = seen.get(gid, 0) + 1
            done_map[gid] = r
            if journal is not None:
                journal.append("finish", gid=gid, tick=tick,
                               error=r.error)
            if seen[gid] == 1:
                if r.error is not None:
                    n_fail += 1
                else:
                    n_ok += 1
                    if _slo_met(r, tiers[meta[gid]["tier"]]):
                        n_met += 1
        # 6. controllers
        if upg is not None:
            upg.on_tick(tick)
        if controller is not None:
            controller(tick, {
                "submitted": len(meta), "finished": n_ok,
                "failed": n_fail, "slo_met": n_met,
                "in_flight": len(meta) - len(done_map),
                "attainment": (n_met / n_ok) if n_ok else 1.0,
            })
        n_alive = len(pool._alive())
        min_alive = min(min_alive, n_alive)
        if metrics is not None:
            metrics.set_gauge("serve_fleet_replicas", float(n_alive))
        tick += 1
        if (i >= len(trace) and not _busy(pool)
                and (upg is None or upg.done) and watch.idle
                and not pool._pending_deaths
                and not pool._pending_retire):
            break
    wall = time.perf_counter() - t0
    if i < len(trace) or _busy(pool):
        raise RuntimeError(
            f"fleet run did not go idle within {max_ticks} ticks "
            f"({len(trace) - i} arrivals unsubmitted, "
            f"{len(pool._entries)} entries in flight)")
    rep.load = score_run(meta, seen, done_map, tiers, ticks=tick,
                         wall_s=wall)
    fleet_cost = cost_closed.merge(pool.cost)
    rep.busy_chip_ticks = fleet_cost.busy_chip_ticks
    rep.busy_ticks = busy_ticks_closed + pool.busy_ticks
    rep.cost_by_key = fleet_cost.as_dict()
    rep.load.busy_chip_ticks = fleet_cost.busy_chip_ticks
    rep.load.cost_by_key = dict(rep.cost_by_key)
    rep.load.publish(metrics)
    rep.tier_inversions = tier_inv_closed + sum(
        e.tier_inversions for e in pool.replicas)
    rep.failovers = failovers_closed + pool.failovers
    rep.sim_ms = sim_ms_closed + sum(e.sim_ms
                                     for e in pool.replicas)
    rep.min_alive = min_alive
    rep.watch_delivered = watch.delivered
    if upg is not None:
        rep.upgrade_waves = upg.waves_done
        rep.upgraded_replicas = len(upg.upgraded)
        if upg.min_alive is not None:
            rep.min_alive = min(rep.min_alive, upg.min_alive)
    if journal is not None:
        rep.journal_records = len(journal.records)
    return rep
