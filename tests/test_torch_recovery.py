"""Fault recovery in the port against the reference: every scenario of
``tests/test_recovery.py``, the multislice recovery cases of
``tests/test_multislice.py`` and ``tests/test_fuzz.py``'s control-plane fuzz
(``wire_cri=False``) run on both packages' ``SimCluster`` with the same
calls.  After each call the two give equal ``RecoveryResult``s, pod phases,
allocations, ``gangs_evicted`` counts, degraded gangs and trace records.
Then switched ``h100-sxm-8`` nodes, which the reference does not register:
a failed card moves a gang onto healthy cards of its node, and a bad NVLink
pair evicts a gang where another footprint is free and parks it degraded
where none is.

The reference runs its Python paths (``KUBETPU_NO_NATIVE=1``), the ones the
port copies, with the coordinator port pinned."""

import random
from types import SimpleNamespace

import pytest
import torch

import kubegpu_tpu.cluster as rcluster
import kubegpu_tpu.config as rconfig
import kubegpu_tpu.kubemeta as rkubemeta
import kubegpu_tpu.scheduler as rscheduler
import kubegpu_tpu_torch.cluster as pcluster
import kubegpu_tpu_torch.config as pconfig
import kubegpu_tpu_torch.kubemeta as pkubemeta
import kubegpu_tpu_torch.scheduler as pscheduler

MILLI = 1000

REF = SimpleNamespace(cluster=rcluster, config=rconfig, kubemeta=rkubemeta,
                      scheduler=rscheduler)
PORT = SimpleNamespace(cluster=pcluster, config=pconfig, kubemeta=pkubemeta,
                       scheduler=pscheduler)


@pytest.fixture(scope="module", autouse=True)
def one_thread_python_paths():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield
    torch.set_num_threads(threads)


class Run:
    """One package's cluster for a scenario, and what it observed: every
    ``RecoveryResult`` and, at each :meth:`snap`, the cluster's state."""

    def __init__(self, pkg, slice_types):
        self.pkg = pkg
        cfg = pkg.config.KubeTpuConfig()
        cfg.scheduler.coordinator_port = 9476
        self.cl = pkg.cluster.SimCluster(slice_types, config=cfg)
        self.log = []
        self.watch_recovery()

    def watch_recovery(self):
        rec = self.cl.recovery
        run_once = rec.run_once

        def logged():
            r = run_once()
            self.log.append(("recovery", dict(r.evicted_gangs),
                             list(r.requeued_pods)))
            return r
        rec.run_once = logged

    def gang(self, name, size, chips, axes=None, multislice=False):
        km = self.pkg.kubemeta
        self.cl.submit(*[self.pkg.cluster.tpu_pod(
            f"{name}-{i}", chips=chips,
            gang=km.GangSpec(name=name, size=size, index=i),
            mesh_axes=axes, multislice=multislice, command=["noop"])
            for i in range(size)])
        return [f"{name}-{i}" for i in range(size)]

    def alloc(self, name):
        return self.pkg.kubemeta.pod_allocation(self.cl.api.get("Pod", name))

    def step(self):
        result, started = self.cl.step()
        self.log.append(("step", sorted(result.scheduled),
                         sorted(result.unschedulable), sorted(result.held),
                         sorted(h.pod_name for h in started)))
        self.snap()

    def snap(self):
        cl = self.cl
        pods = {}
        for p in sorted(cl.api.list("Pod"), key=lambda p: (
                p.metadata.namespace, p.name)):
            a = self.pkg.kubemeta.pod_allocation(p)
            pods[(p.metadata.namespace, p.name)] = (
                p.status.phase.value, p.spec.node_name, a and (
                    a.slice_id, a.node_name, a.worker_id, a.gang_name,
                    tuple((c.coord, c.local_index, c.millichips)
                          for c in a.chips)))
        self.log.append((
            "state", pods, cl.metrics.counter("gangs_evicted"),
            sorted(cl.recovery._degraded),
            [(e.kind, e.gang, e.detail) for e in cl.trace.events("degraded")],
            {sid: (sorted(st.unhealthy), sorted(st.bad_links),
                   sorted(st.available), sorted(st.used_millichips.items()))
             for sid, st in sorted(cl.scheduler.slices.items())}))

    def check_capacity(self):
        for st in self.cl.scheduler.slices.values():
            for coord, used in st.used_millichips.items():
                assert 0 <= used <= MILLI, (coord, used)


def both(scenario, evicts=True):
    """Run ``scenario(run)`` on each package; their logs must be equal (and
    a gang evicted in them, where ``evicts``)."""
    logs = []
    for pkg in (REF, PORT):
        run = scenario(pkg)
        try:
            logs.append(run.log)
        finally:
            run.cl.close()
    ref, port = logs
    assert len(port) == len(ref)
    for i, (want, got) in enumerate(zip(ref, port)):
        assert got == want, f"entry {i}"
    if evicts is not None:
        assert any(e[0] == "recovery" and e[1] for e in ref) == evicts
    return ref


NO_EVICTION = {"healed_chip_usable_again", "new_allocations_avoid_bad_link"}


# -- tests/test_recovery.py --------------------------------------------------

def failed_chip_evicts_and_reschedules_gang(pkg):
    r = Run(pkg, ["v5e-16"])
    names = r.gang("job", 4, 2, {"dp": 4, "tp": 2})
    r.step()
    a = r.alloc(names[0])
    r.cl.fail_chip(a.node_name, a.chips[0].local_index)
    r.step()
    after = [c.coord for n in names for c in r.alloc(n).chips]
    assert a.chips[0].coord not in after
    return r


def same_node_replacement_restarts_container_fresh_env(pkg):
    r = Run(pkg, ["v5e-16"])
    names = r.gang("job", 4, 2, {"dp": 4, "tp": 2})
    r.step()
    a = r.alloc(names[0])
    r.cl.fail_chip(a.node_name, a.chips[0].local_index)
    r.step()
    for n in names:
        al = r.alloc(n)
        agent = r.cl.agent_for(al.node_name)
        r.log.append(("env", n, agent.handles[n].env["TPU_VISIBLE_CHIPS"]))
    return r


def healed_chip_usable_again(pkg):
    r = Run(pkg, ["v4-8"])
    node = r.cl.agents[0].node_name
    r.cl.fail_chip(node, 0)
    r.cl.submit(pkg.cluster.tpu_pod("big", chips=4, command=["noop"]))
    r.step()
    r.cl.heal_chip(node, 0)
    r.step()
    return r


def host_death_reschedules_gang_to_other_slice(pkg):
    r = Run(pkg, ["v5e-16", "v5e-16"])
    names = r.gang("job", 4, 4, {"dp": 4, "tp": 4})
    r.step()
    r.cl.fail_host(r.alloc(names[0]).node_name)
    r.step()
    return r


def whole_slice_death_still_evicts_gang(pkg):
    r = Run(pkg, ["v4-8", "v5e-16"])
    names = r.gang("job", 4, 1)
    r.step()
    r.cl.fail_host(r.alloc(names[0]).node_name)
    r.step()
    return r


def single_slice_gang_pends_until_host_restored(pkg):
    r = Run(pkg, ["v5e-16"])
    names = r.gang("job", 4, 4)
    r.step()
    victim = r.alloc(names[0]).node_name
    r.cl.fail_host(victim)
    r.step()
    r.cl.restore_host(victim)
    r.step()
    return r


def dead_host_containers_killed_on_survivors(pkg):
    r = Run(pkg, ["v5e-16", "v5e-16"])
    names = r.gang("job", 4, 4)
    r.step()
    r.cl.fail_host(r.alloc(names[0]).node_name)
    r.step()
    r.log.append(("handles", {a.node_name: sorted(a.handles)
                              for a in r.cl.agents}))
    return r


def new_allocations_avoid_bad_link(pkg):
    r = Run(pkg, ["v5e-16"])
    sid = r.cl.agents[0].backend.slice_id
    r.cl.fail_link((0, 0, 0), (1, 0, 0), slice_id=sid)
    r.gang("job", 2, 4, {"tp": 8})
    r.step()
    return r


def link_failure_inside_allocation_triggers_recovery(pkg):
    r = Run(pkg, ["v5e-16", "v5e-16"])
    names = r.gang("job", 4, 4, {"dp": 4, "tp": 4})
    r.step()
    a0 = r.alloc(names[0])
    chips = sorted({c.coord for n in names for c in r.alloc(n).chips})
    topo = r.cl.scheduler.slices[a0.slice_id].topo
    link = next((a, b) for a in chips for b in chips
                if a < b and topo.are_ici_adjacent(a, b))
    r.cl.fail_link(*link, slice_id=a0.slice_id)
    r.step()
    r.cl.heal_link(*link, slice_id=a0.slice_id)
    r.step()
    return r


def eviction_does_not_resurrect_completed_pod(pkg):
    r = Run(pkg, ["v5e-16", "v5e-16"])
    names = r.gang("job", 4, 2)
    r.step()
    r.cl.api.set_pod_phase(names[3], pkg.kubemeta.PodPhase.SUCCEEDED,
                           exit_code=0)
    r.cl.fail_host(r.alloc(names[0]).node_name)
    r.step()
    return r


def fresh_scheduler_detects_fault_from_annotations(pkg):
    r = Run(pkg, ["v5e-16", "v4-8"])
    names = r.gang("job", 4, 2)
    r.step()
    victim = r.alloc(names[0])
    cl = r.cl
    cl.recovery.close()
    cl.scheduler = pkg.scheduler.DeviceScheduler(
        cl.api, metrics=cl.metrics, trace=cl.trace, coordinator_port=9900)
    cl.recovery = pkg.scheduler.FaultRecoveryController(cl.api, cl.scheduler)
    r.watch_recovery()
    cl.fail_chip(victim.node_name, victim.chips[0].local_index)
    r.step()
    return r


def random_fault_storm_never_overbooks(pkg):
    rng = random.Random(7)
    r = Run(pkg, ["v5e-16", "v4-8"])
    cl = r.cl
    gang_i = 0
    live = [a.node_name for a in cl.agents]
    down = set()
    for _ in range(40):
        op = rng.random()
        if op < 0.4:
            gang_i += 1
            r.gang(f"g{gang_i}", rng.choice([1, 2, 4]), rng.choice([1, 2, 4]))
        elif op < 0.6 and len(down) < len(live) - 1:
            n = rng.choice([x for x in live if x not in down])
            down.add(n)
            cl.fail_host(n)
        elif op < 0.8 and down:
            n = rng.choice(sorted(down))
            down.remove(n)
            cl.restore_host(n)
        else:
            running = [p for p in cl.api.list("Pod")
                       if p.status.phase != pkg.kubemeta.PodPhase.PENDING]
            if running:
                try:
                    cl.api.delete("Pod", rng.choice(running).name)
                except pkg.kubemeta.NotFound:
                    pass
        r.step()
        r.check_capacity()
    return r


RECOVERY = [failed_chip_evicts_and_reschedules_gang,
            same_node_replacement_restarts_container_fresh_env,
            healed_chip_usable_again,
            host_death_reschedules_gang_to_other_slice,
            whole_slice_death_still_evicts_gang,
            single_slice_gang_pends_until_host_restored,
            dead_host_containers_killed_on_survivors,
            new_allocations_avoid_bad_link,
            link_failure_inside_allocation_triggers_recovery,
            eviction_does_not_resurrect_completed_pod,
            fresh_scheduler_detects_fault_from_annotations,
            random_fault_storm_never_overbooks]


@pytest.mark.parametrize("scenario", RECOVERY, ids=[f.__name__
                                                    for f in RECOVERY])
def test_recovery_equals_the_reference(scenario):
    both(scenario, evicts=scenario.__name__ not in NO_EVICTION)


# -- tests/test_multislice.py ------------------------------------------------

def host_failure_evicts_whole_multislice_gang(pkg):
    r = Run(pkg, ["v4-8", "v4-8"])
    r.gang("ms", 4, 2, {"dp": 4, "tp": 2}, multislice=True)
    r.step()
    r.cl.fail_host(r.alloc("ms-0").node_name)
    r.cl.recovery.run_once()
    r.snap()
    return r


def hard_fault_in_second_slice_wins_over_link_in_first(pkg):
    r = Run(pkg, ["v4-8", "v4-8"])
    r.gang("ms", 4, 2, {"dp": 4, "tp": 2}, multislice=True)
    r.step()
    a0, a2 = r.alloc("ms-0"), r.alloc("ms-2")
    assert a0.slice_id != a2.slice_id
    r.cl.fail_link(a0.chips[0].coord, a0.chips[1].coord,
                   slice_id=a0.slice_id)
    r.cl.fail_host(a2.node_name)
    r.cl.recovery.run_once()
    r.snap()
    assert "default/ms" not in r.cl.recovery._degraded
    return r


MULTISLICE = [host_failure_evicts_whole_multislice_gang,
              hard_fault_in_second_slice_wins_over_link_in_first]


@pytest.mark.parametrize("scenario", MULTISLICE, ids=[f.__name__
                                                      for f in MULTISLICE])
def test_multislice_recovery_equals_the_reference(scenario):
    log = both(scenario)
    assert "default/ms" in next(e[1] for e in log if e[0] == "recovery"
                                and e[1])


# -- tests/test_fuzz.py ------------------------------------------------------

def fuzz(seed):
    def scenario(pkg):
        km = pkg.kubemeta
        rng = random.Random(seed)
        r = Run(pkg, ["v5e-16", "v4-8", "v4-8"])
        cl = r.cl
        cl.set_quota("team-a", chips=10)
        counter = 0
        hosts = [a.node_name for a in cl.agents]
        down_hosts, bad_chips = set(), set()

        def submit_random():
            nonlocal counter
            counter += 1
            kind = rng.random()
            prio = rng.choice([0, 0, 0, 5, 10])
            ns = rng.choice(["default", "default", "team-a", "team-b"])
            tpu_pod = pkg.cluster.tpu_pod
            if kind < 0.15:
                cl.submit(tpu_pod(f"f{counter}",
                                  millitpu=rng.choice([300, 500]),
                                  command=["x"], priority=prio,
                                  namespace=ns))
            elif kind < 0.4:
                cl.submit(tpu_pod(f"s{counter}", chips=rng.choice([1, 2, 4]),
                                  command=["x"], priority=prio,
                                  namespace=ns))
            else:
                size = rng.choice([2, 4, 8])
                chips = rng.choice([1, 2])
                ms = rng.random() < 0.5
                gname = rng.choice([f"g{counter}", "shared"])
                pods = [tpu_pod(f"g{counter}-{k}", chips=chips,
                                gang=km.GangSpec(name=gname, size=size,
                                                 index=k),
                                mesh_axes={"dp": size, "tp": chips},
                                multislice=ms, command=["x"], priority=prio,
                                namespace=ns,
                                migratable=rng.random() < 0.3)
                        for k in range(size)]
                if rng.random() < 0.25:
                    pods = pods[:-1]
                cl.submit(*pods)

        for _ in range(150):
            op = rng.random()
            if op < 0.45:
                submit_random()
            elif op < 0.6:
                pods = cl.api.list("Pod")
                if pods:
                    victim = rng.choice(pods)
                    try:
                        cl.api.delete("Pod", victim.name,
                                      namespace=victim.metadata.namespace)
                    except km.NotFound:
                        pass
            elif op < 0.7:
                h = rng.choice(hosts)
                if h in down_hosts:
                    cl.restore_host(h)
                    down_hosts.discard(h)
                elif len(down_hosts) < 2:
                    cl.fail_host(h)
                    down_hosts.add(h)
            elif op < 0.78:
                h = rng.choice(hosts)
                if h not in down_hosts:
                    key = (h, rng.randrange(2))
                    if key in bad_chips:
                        cl.heal_chip(*key)
                        bad_chips.discard(key)
                    else:
                        cl.fail_chip(*key)
                        bad_chips.add(key)
            else:
                r.step()
                cl.reap(timeout=0)
            r.check_capacity()
        for h in list(down_hosts):
            cl.restore_host(h)
        for key in list(bad_chips):
            cl.heal_chip(*key)
        for _ in range(8):
            r.step()
            cl.reap(timeout=0)
        return r
    scenario.__name__ = f"fuzz_{seed}"
    return scenario


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_plane_fuzz_equals_the_reference(seed):
    log = both(fuzz(seed), evicts=None)
    assert sum(e[0] == "step" for e in log) > 30


# -- switched H100 nodes (port only) ------------------------------------------

def h100_run(gangs):
    """A mock ``h100-sxm-8`` node with ``gangs`` ((name, pods, cards a
    pod)) placed in one step."""
    r = Run(PORT, ["h100-sxm-8"])
    for name, size, cards in gangs:
        r.gang(name, size, cards, {"dp": size * cards})
    r.step()
    return r


def cards_of(r, names):
    return sorted(c.coord for n in names for c in r.alloc(n).chips)


def test_a_failed_card_moves_a_gang_to_healthy_cards_of_its_node():
    r = h100_run([("job", 4, 1)])
    try:
        names = [f"job-{i}" for i in range(4)]
        before = cards_of(r, names)
        a = r.alloc(names[2])
        node = a.node_name
        r.cl.fail_chip(node, a.chips[0].local_index)
        r.step()
        after = cards_of(r, names)
        assert r.log[-3][1] == {"default/job": f"chip {a.chips[0].coord} "
                                "marked unhealthy"}
        assert len(after) == 4 and a.chips[0].coord not in after
        assert after != before
        assert all(r.alloc(n).node_name == node
                   and r.alloc(n).worker_id == i
                   for i, n in enumerate(names))
        assert r.cl.metrics.counter("gangs_evicted") == 1
        assert all(r.cl.pod_phase(n) == PORT.kubemeta.PodPhase.RUNNING
                   for n in names)
    finally:
        r.cl.close()


@pytest.mark.parametrize("cards,others_free", [(2, True), (2, False),
                                                (4, True)])
def test_a_bad_nvlink_pair_evicts_or_parks_a_gang(cards, others_free):
    """A pair inside the gang fails.  Where another footprint avoids it the
    gang is evicted and re-placed; where none is free it is parked as
    degraded until a pod ends.  A gang of four on a switched node is
    parked: its own cards in another order keep the pair off its ring,
    and only a different footprint counts as better (the reference's
    rule, ``_better_placement_exists``)."""
    gangs = [("job", cards, 1)] + ([] if others_free
                                   else [("other", 8 - cards, 1)])
    r = h100_run(gangs)
    try:
        names = [f"job-{i}" for i in range(cards)]
        before = cards_of(r, names)
        pair = (before[0], before[-1])
        sid = r.alloc(names[0]).slice_id
        r.cl.fail_link(*pair, slice_id=sid)
        r.step()
        evicted = r.log[-3][1]
        if others_free and cards == 2:
            assert evicted == {"default/job": f"ICI link {pair[0]}–"
                               f"{pair[1]} failed inside allocation"}
            after = cards_of(r, names)
            assert len(after) == cards and not set(pair) <= set(after)
            assert r.cl.metrics.counter("gangs_evicted") == 1
            return
        assert evicted == {}
        assert cards_of(r, names) == before
        assert r.cl.recovery._degraded == {"default/job"}
        assert [e.gang for e in r.cl.trace.events("degraded")] == [
            "default/job"]
        assert r.cl.metrics.counter("gangs_evicted") == 0
        if others_free:
            return
        # the other gang ends: the parked one is looked at again, and moves
        # off the bad pair
        for i in range(8 - cards):
            r.cl.api.set_pod_phase(f"other-{i}",
                                   PORT.kubemeta.PodPhase.SUCCEEDED,
                                   exit_code=0)
        r.step()
        assert r.cl.metrics.counter("gangs_evicted") == 1
        assert not set(pair) <= set(cards_of(r, names))
    finally:
        r.cl.close()
