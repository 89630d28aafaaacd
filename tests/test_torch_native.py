"""The port's C++ allocator core (``kubegpu_tpu_torch/allocator/_native.py``
over ``allocator/csrc/allocator_core.cpp``) against the reference's core
and against the port's own Python paths.

On every TPU spec the port's core returns what the reference's returns,
exactly, and what the port's Python path returns; on the switched H100
nodes (``h100-sxm-1/2/4/8``, and a spec of two 8-card hosts on one line)
it returns the Python path's, where the reference's torus distance would
differ.  ``GangAllocator`` decides the same with the core and without, the
sanitized driver builds and passes, and a missing compiler raises instead
of falling back.  The Python paths run under ``KUBETPU_NO_NATIVE=1``,
which both packages read at every call."""

import contextlib
import random
import subprocess
import zlib

import pytest
import torch

from kubegpu_tpu.allocator import _native as ref_native
from kubegpu_tpu.topology import mesh as ref_mesh
from kubegpu_tpu_torch.allocator import _native
from kubegpu_tpu_torch.allocator import gang as gang_mod
from kubegpu_tpu_torch.allocator.gang import (
    GangAllocator,
    GangRequest,
    SliceState,
)
from kubegpu_tpu_torch.allocator.ordering import candidate_orders
from kubegpu_tpu_torch.topology.locality import (
    ici_locality,
    traffic_pairs_for_mesh_axes,
)
from kubegpu_tpu_torch.topology.mesh import (
    TOPOLOGY_REGISTRY,
    TopologySpec,
    TpuTopology,
)
from kubegpu_tpu_torch.topology.slices import (
    Placement,
    enumerate_placements,
    find_free_placements,
    fragmentation_score,
    subslice_shapes,
)
from kubegpu_tpu_torch.tpuplugin.mock import MockBackend

TPU = sorted(ref_mesh.TOPOLOGY_REGISTRY)
# two 8-card NVSwitch hosts laid out on one line: cards 7 and 8 are one
# torus step apart but on two hosts, so not adjacent
TWO_HOSTS = TopologySpec(name="h100-2x8", generation="h100",
                         mesh_shape=(16, 1, 1), host_block=(8, 1, 1),
                         hbm_gib_per_chip=80.0, switched=True)
SWITCHED = [f"h100-sxm-{n}" for n in (1, 2, 4, 8)] + [TWO_HOSTS.name]
ALL = TPU + SWITCHED


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("KUBETPU_NO_NATIVE", raising=False)


@contextlib.contextmanager
def python_path():
    """The port's (and the reference's) Python implementations: the spec
    the cores must match."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBETPU_NO_NATIVE", "1")
        yield


def spec_of(name: str) -> TopologySpec:
    return TWO_HOSTS if name == TWO_HOSTS.name else TOPOLOGY_REGISTRY[name]


def topos(name: str):
    """(the port's topology, the reference's or None) of spec ``name``."""
    ref = (ref_mesh.TpuTopology.build(ref_mesh.TOPOLOGY_REGISTRY[name])
           if name in ref_mesh.TOPOLOGY_REGISTRY else None)
    return TpuTopology.build(spec_of(name)), ref


def rng_for(name: str, salt: int = 0) -> random.Random:
    return random.Random(zlib.crc32(name.encode()) + salt)


def random_axes(rng, n):
    """Random ordered factorization of n into 1–3 named axes."""
    names = ["dp", "fsdp", "tp"]
    sizes, rest = [], n
    for _ in range(rng.randrange(1, 3)):
        divs = [d for d in range(2, rest + 1) if rest % d == 0]
        if not divs:
            break
        d = rng.choice(divs)
        sizes.append(d)
        rest //= d
    sizes.append(rest)
    return {names[i]: s for i, s in enumerate(sizes)}


def shapes_of(topo, rng, totals, trials):
    n = topo.spec.num_chips
    for _ in range(trials):
        total = rng.choice(totals)
        if total <= n:
            yield total, subslice_shapes(total, topo.spec.mesh_shape)


@pytest.mark.parametrize("name", ALL)
def test_find_free_placements(name):
    topo, ref = topos(name)
    rng = rng_for(name)
    coords = [ch.coord for ch in topo.chips]
    for _, shapes in shapes_of(topo, rng, (1, 2, 4, 8, 16, 32), 12):
        occupied = set(rng.sample(coords, rng.randrange(0, len(coords))))
        for shape in shapes:
            for limit in (None, 3):
                nat = _native.find_free_placements_native(
                    topo, occupied, shape, limit)
                with python_path():
                    py = find_free_placements(topo, occupied, shape, limit)
                assert nat == py, (name, shape, limit)
                if ref is not None:
                    want = ref_native.find_free_placements_native(
                        ref, occupied, shape, limit)
                    assert [(p.origin, p.coords) for p in nat] == \
                        [(p.origin, p.coords) for p in want]


@pytest.mark.parametrize("name", ALL)
def test_rank_free_placements(name):
    """The fused enumerate + frag-rank equals the Python pipeline (find →
    frag each → stable sort descending → truncate: ties keep enumeration
    order) and, on a TPU spec, the reference's core, scores exactly."""
    topo, ref = topos(name)
    rng = rng_for(name, 1)
    coords = [ch.coord for ch in topo.chips]
    for _, shapes in shapes_of(topo, rng, (2, 4, 8, 16), 8):
        occupied = set(rng.sample(coords, rng.randrange(0, len(coords))))
        for shape in shapes:
            for limit, k in ((None, 4), (6, 2), (64, 8)):
                nat = _native.rank_free_placements_native(
                    topo, occupied, shape, limit, k)
                with python_path():
                    ranked = [(fragmentation_score(topo, occupied, pl), pl)
                              for pl in find_free_placements(
                                  topo, occupied, shape, limit=limit)]
                ranked.sort(key=lambda t: -t[0])
                assert nat == ranked[:k], (name, shape, limit, k)
                if ref is not None:
                    want = ref_native.rank_free_placements_native(
                        ref, occupied, shape, limit, k)
                    assert [(f, p.origin, p.coords) for f, p in nat] == \
                        [(f, p.origin, p.coords) for f, p in want]


@pytest.mark.parametrize("name", ALL)
def test_eval_order(name):
    """Weighted locality of the candidate orders and of shuffled ones,
    exactly as the Python path's (and the reference core's on a TPU
    spec)."""
    topo, ref = topos(name)
    rng = rng_for(name, 2)
    for total in (2, 4, 8, 16):
        if total > topo.spec.num_chips:
            continue
        for shape in subslice_shapes(total, topo.spec.mesh_shape)[:3]:
            for pl in enumerate_placements(topo, shape)[:4]:
                shuffled = list(pl.coords)
                rng.shuffle(shuffled)
                for order in candidate_orders(pl)[:6] + [shuffled]:
                    axes = random_axes(rng, total)
                    weights = {k: rng.choice([1.0, 2.0, 8.0]) for k in axes}
                    nat = _native.eval_order_native(topo, order, axes,
                                                    weights)
                    py = ici_locality(topo, traffic_pairs_for_mesh_axes(
                        order, axes, weights))
                    assert nat == py, (name, order, axes)
                    if ref is not None:
                        assert nat == ref_native.eval_order_native(
                            ref, order, axes, weights)


def test_switched_adjacency_is_the_hosts():
    """Cards 0 and 3 of one ``h100-sxm-8`` are one NVLink hop apart, as
    the Python path scores them (a torus core would say three); cards 7
    and 8 of two hosts are not adjacent, though one torus step apart."""
    sxm8 = TpuTopology.build(TOPOLOGY_REGISTRY["h100-sxm-8"])
    two = TpuTopology.build(TWO_HOSTS)
    for topo, order, want in ((sxm8, [(0, 0, 0), (3, 0, 0)], 1.0),
                              (two, [(7, 0, 0), (8, 0, 0)], 0.0),
                              (two, [(8, 0, 0), (15, 0, 0)], 1.0)):
        nat = _native.eval_order_native(topo, order, {"tp": 2}, None)
        with python_path():
            assert ici_locality(topo, traffic_pairs_for_mesh_axes(
                order, {"tp": 2})) == want
        assert nat == want, order


@pytest.mark.parametrize("name", ["v5e-64", "v5e-256", "v5p-128",
                                  "h100-sxm-8", TWO_HOSTS.name])
def test_fragmentation_score(name):
    """Mesh-based on every spec, switched ones too (slices.py's rule)."""
    topo, ref = topos(name)
    rng = rng_for(name, 3)
    coords = [ch.coord for ch in topo.chips]
    for _ in range(12):
        occupied = set(rng.sample(coords, rng.randrange(0, len(coords) // 2)))
        total = rng.choice([1, 2, 4, 8])
        shape = rng.choice(subslice_shapes(total, topo.spec.mesh_shape))
        with python_path():
            pls = find_free_placements(topo, occupied, shape, 5)
        for pl in pls:
            nat = _native.fragmentation_score_native(topo, occupied,
                                                     pl.coords)
            with python_path():
                assert nat == fragmentation_score(topo, occupied, pl)
            if ref is not None:
                assert nat == ref_native.fragmentation_score_native(
                    ref, occupied, pl.coords)
    # a connected (non-rectangular) set goes through the core too
    pl = Placement(origin=(0, 0, 0), shape=(0, 0, 0),
                   coords=tuple(coords[:3]))
    with python_path():
        want = fragmentation_score(topo, {coords[-1]}, pl)
    assert _native.fragmentation_score_native(
        topo, {coords[-1]}, pl.coords) == want


@pytest.mark.parametrize("name", ["v5e-16", "v5e-64", "v5e-256",
                                  TWO_HOSTS.name])
def test_orient_rings(name):
    """``_block_orders`` (ring orientation and unit alignment over host
    blocks) builds the same orders with the core as without."""
    topo, ref = topos(name)
    for total in (8, 16, 32, 64):
        if total > topo.spec.num_chips:
            continue
        for shape in subslice_shapes(total, topo.spec.mesh_shape)[:4]:
            for pl in enumerate_placements(topo, shape)[:3]:
                for span in (None, 4, 16):
                    nat = gang_mod._block_orders(topo, pl, span)
                    with python_path():
                        py = gang_mod._block_orders(topo, pl, span)
                    assert nat == py, (name, shape, pl.origin, span)
                    if ref is not None:
                        options = [gang_mod._block_cycle_options(b) for b in
                                   gang_mod._block_sequences(topo, pl)[0]]
                        for close in (False, True):
                            assert _native.orient_rings_native(
                                options, close) == \
                                ref_native.orient_rings_native(options,
                                                               close)


def test_align_units():
    """``ktpu_align_units`` picks the Python Viterbi's orientations (ties
    included) and the reference core's, on random ring sets."""
    rng = random.Random(7)
    for trial in range(120):
        n_units, ring_len = rng.randint(2, 6), rng.choice([2, 4, 8])
        step = rng.choice([1, 2])
        units = []
        for _ in range(n_units):
            base = rng.randint(0, 5)
            units.append([(base + i % 3, (base + i) % 4, rng.randint(0, 2))
                          for i in range(ring_len)])
        options = [gang_mod._cycle_variants(u, step) for u in units]
        nat = _native.align_units_native(options)
        with python_path():
            assert gang_mod._align_units(units, step) == nat, trial
        assert ref_native.align_units_native(options) == nat, trial


def slice_state(name: str, rng: random.Random | None = None) -> SliceState:
    """Every chip of spec ``name`` advertised, each used with probability
    0.35 under ``rng``."""
    st = SliceState("s0", spec_of(name))
    for i, ch in enumerate(st.topo.chips):
        st.available.add(ch.coord)
        st.local_index[ch.coord] = i % st.spec.chips_per_host
        st.hbm_gib[ch.coord] = st.spec.hbm_gib_per_chip
        if rng is not None and rng.random() < 0.35:
            st.used_millichips[ch.coord] = 1000
    return st


@pytest.mark.parametrize("name", ["v4-8", "v5e-16", "v5e-64", "h100-sxm-4",
                                  "h100-sxm-8", TWO_HOSTS.name])
def test_connected_order(name):
    """The connected fallback's chunked order and score, with the core and
    without, over random occupancy and gang shapes."""
    rng = rng_for(name, 4)
    alloc = GangAllocator()
    for trial in range(30):
        pods, cpp = rng.choice([1, 2, 3]), rng.choice([1, 2, 3])
        req = GangRequest("g", num_pods=pods, chips_per_pod=cpp)
        axes = {"dp": pods * cpp}
        st = slice_state(name, random.Random(trial))
        blocked = st.blocked_for_whole()
        nat = alloc._connected_candidate(st, req, blocked, axes)
        with python_path():
            py = alloc._connected_candidate(st, req, blocked, axes)
        assert (nat is None) == (py is None), trial
        if py is not None:
            assert (nat.order, nat.score, nat.locality) == \
                (py.order, py.score, py.locality), trial


def decisions(slices_of, reqs):
    alloc, slices, out = GangAllocator(), slices_of(), []
    for r in reqs:
        a = alloc.find_assignment(slices, r)
        if a is None:
            out.append(None)
            continue
        alloc.commit({s.slice_id: s for s in slices}, a)
        out.append((a.slice_id, a.locality, a.score,
                    [(p.pod_index, p.host_id, tuple(c.coord for c in p.chips))
                     for p in a.pods]))
    return out


def mock_slices(slice_type: str, n_slices: int = 1):
    out = []
    for s in range(n_slices):
        spec = MockBackend(slice_type, slice_id=f"s{s}").spec
        out.append(SliceState.from_advertisements([
            MockBackend(slice_type, host_id=h, slice_id=f"s{s}").discover()
            for h in range(spec.num_hosts)]))
    return out


@pytest.mark.parametrize("cluster", ["v5e-64", "h100-sxm-8 x4"])
def test_allocator_native_vs_python(cluster):
    """Whole ``GangAllocator`` decisions, committed one after another, are
    the same with the core as without: on a v5e-64 slice and on four
    ``h100-sxm-8`` nodes (a multislice gang across two of them)."""
    if cluster == "v5e-64":
        slices_of = lambda: mock_slices("v5e-64")  # noqa: E731
        reqs = [GangRequest("g0", num_pods=4, chips_per_pod=4,
                            mesh_axes={"dp": 4, "tp": 4}),
                GangRequest("g1", num_pods=8, chips_per_pod=4,
                            mesh_axes={"dp": 2, "tp": 16},
                            axis_weights={"dp": 1.0, "tp": 8.0}),
                GangRequest("g2", num_pods=1, chips_per_pod=2),
                GangRequest("g3", num_pods=1, chips_per_pod=3),
                GangRequest("g4", num_pods=2, chips_per_pod=3)]
    else:
        slices_of = lambda: mock_slices("h100-sxm-8", 4)  # noqa: E731
        reqs = [GangRequest("a", num_pods=1, chips_per_pod=3),
                GangRequest("b", num_pods=2, chips_per_pod=2,
                            mesh_axes={"dp": 2, "tp": 2}),
                GangRequest("c", num_pods=2, chips_per_pod=8,
                            mesh_axes={"dp": 2, "tp": 8},
                            allow_multislice=True),
                GangRequest("d", num_pods=3, chips_per_pod=1),
                GangRequest("e", num_pods=1, chips_per_pod=5),
                GangRequest("f", num_pods=1, chips_per_pod=8)]
    nat = decisions(slices_of, reqs)
    with python_path():
        py = decisions(slices_of, reqs)
    assert nat == py
    assert sum(d is not None for d in nat) >= 4


def test_sanitized_driver(tmp_path):
    """The address+UB-sanitized driver over every entry, switched specs
    included (skips where the compiler has no sanitizer runtime)."""
    exe = tmp_path / "sanitize_check"
    cmd = [_native.cxx(), "-O1", "-g", "-std=c++17", "-Wall", "-Wextra",
           "-fsanitize=address,undefined", "-fno-omit-frame-pointer", "-o",
           str(exe), str(_native.SOURCE), str(_native.CSRC /
                                               "sanitize_main.cpp")]
    built = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if built.returncode != 0:
        pytest.skip(f"no sanitizer build here: {built.stderr[-500:]}")
    assert "warning" not in built.stderr, built.stderr
    res = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin",
                                           "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "sanitize OK" in res.stdout


def test_missing_compiler_raises(monkeypatch):
    """No fail-soft: without a compiler the core raises, and so does the
    placement search that needs it."""
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    monkeypatch.setattr(_native, "_lib", None)
    assert not _native.so_path().exists()
    with pytest.raises(RuntimeError, match="/nonexistent/c\\+\\+"):
        _native.get_lib()
    topo = TpuTopology.build(TOPOLOGY_REGISTRY["h100-sxm-8"])
    with pytest.raises(RuntimeError, match="allocator core"):
        find_free_placements(topo, set(), (2, 1, 1))


def test_refusals_are_counted():
    """A mesh past the dedup key's 512 cells takes the Python path, and
    the refusal is counted; ``KUBETPU_NO_NATIVE`` turns every entry off."""
    big = TpuTopology.build(TopologySpec(
        name="big", generation="v5p", mesh_shape=(16, 16, 4)))
    before = dict(_native.fallbacks)
    assert _native.find_free_placements_native(
        big, set(), (2, 2, 1), 3) is None
    assert _native.rank_free_placements_native(
        big, set(), (2, 2, 1), 3, 2) is None
    assert [p.origin for p in find_free_placements(big, set(), (2, 2, 1),
                                                   3)] == \
        [(0, 0, 0), (0, 0, 1), (0, 0, 2)]
    assert _native.fallbacks["find_free_placements"] == \
        before["find_free_placements"] + 2
    assert _native.fallbacks["rank_free_placements"] == \
        before["rank_free_placements"] + 1
    topo = TpuTopology.build(TOPOLOGY_REGISTRY["h100-sxm-8"])
    with python_path():
        assert _native.get_lib() is None
        assert _native.occupancy_mask(topo, set()) is None
        assert _native.find_free_placements_native(
            topo, set(), (2, 1, 1), None) is None
