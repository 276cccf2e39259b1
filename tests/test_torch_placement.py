"""Gang placement on the port's topology against the reference's, on the CPU.

Each flow of ``tests/test_topology_placement.py`` runs through both
packages' ``SliceAllocator``, ``_guillotine_split``, ``_try_merge`` and
``render_pod``, one test a flow with a reference case and a port case
(``_torch_control.held``: the port's record held equal to the reference's).

The port is not a copy here: its ``utils/topology.py`` places NVIDIA H100
hosts of 8 cards joined all to all, so its host grid is the 1-D run
``(hosts,)`` where a TPU slice's is a 3-D box of hosts, and it has no
``host_block_shape``, ``hosts_contiguous`` or ``default_topology``. The
flows map the reference's ``v5p-8/16/32/64`` (1, 2, 4 and 8 hosts) to the
port's ``h100-8/16/32/64``, and ``v5litepod-8`` with ``v5litepod-4`` (one
host, and a sub-host shape of it) to ``h100-8`` with ``h100-4``. Held
equal: the carving arithmetic, admission and release counts, the rendered
selectors with the accelerator names mapped. Asserted as the port's own:
its pods request ``nvidia.com/gpu: "8"`` (a host's cards, where the
reference's request nothing off GKE), a live gang's hosts are a run of
consecutive indices (checked here: the port has no ``hosts_contiguous``),
and its geometry is the documented contract of ``utils/topology.py``.
"""

import importlib
import random

import pytest

from _torch_control import NAMES, PACKAGES, held, raised

# the reference's slice shapes and the port's with the same host counts
ACCELERATOR = {
    "reference": {1: "v5p-8", 2: "v5p-16", 4: "v5p-32", 8: "v5p-64"},
    "port": {1: "h100-8", 2: "h100-16", 4: "h100-32", 8: "h100-64"},
}
SUB_HOST = {"reference": ("v5litepod-8", "v5litepod-4"), "port": ("h100-8", "h100-4")}


def _gang(P):
    return importlib.import_module(f"{P.root}.trainer.gang")


def _topo(P):
    return importlib.import_module(f"{P.root}.utils.topology")


def _side(P):
    return "port" if P is PACKAGES["port"] else "reference"


def _acc(P, hosts):
    return ACCELERATOR[_side(P)][hosts]


def _unmap(P, value):
    """A port accelerator name written as the reference's of as many hosts."""
    if _side(P) == "reference":
        return value
    for hosts, acc in ACCELERATOR["port"].items():
        value = value.replace(acc, ACCELERATOR["reference"][hosts])
    return value


class _Jobs:
    """Jobs named and uid'd by a counter, so two packages' runs name alike."""

    def __init__(self, P):
        self.P, self.n = P, 0

    def __call__(self, accelerator, num_slices=1, workers=None):
        t = self.P.t
        info = _topo(self.P).parse_accelerator(accelerator)
        self.n += 1
        return t.TPUJob(
            metadata=t.ObjectMeta(name=f"j-{self.n}", uid=f"uid-{self.n}"),
            spec=t.TPUJobSpec(
                replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                    replicas=workers if workers is not None else info.hosts * num_slices,
                    template=t.ContainerSpec(entrypoint="x:y"))},
                tpu=t.TPUSpec(accelerator=accelerator, num_slices=num_slices),
            ),
        )


def _cells(box):
    cells = {()}
    for o, s in zip(box.origin, box.shape):
        cells = {c + (o + i,) for c in cells for i in range(s)}
    return cells


def _consecutive(hosts):
    """The port's contiguity: a 1-D grid's box is a run of consecutive hosts."""
    hosts = sorted(hosts)
    return hosts == list(range(hosts[0], hosts[0] + len(hosts)))


# -- guillotine split and merge ----------------------------------------------


def _split_flow(P):
    """``tests/test_topology_placement.py``'s 200 random splits, with 1-D
    boxes (the port's grid) among the 2-D and 3-D ones: the carved box at
    the parent's origin, carved and remainders disjoint and tiling the
    parent. The record is every split's boxes."""
    g = _gang(P)
    rng = random.Random(0)
    out = []
    for _ in range(200):
        nd = rng.choice([1, 2, 3])
        shape = tuple(rng.randint(1, 6) for _ in range(nd))
        origin = tuple(rng.randint(0, 3) for _ in range(nd))
        parent = g.Box(origin, shape)
        want = tuple(rng.randint(1, s) for s in shape)
        carved, rems = g._guillotine_split(parent, want)
        assert carved.shape == want and carved.origin == origin
        cell_sets = [_cells(p) for p in [carved] + rems]
        union = set().union(*cell_sets)
        assert sum(len(c) for c in cell_sets) == len(union)
        assert union == _cells(parent)
        out.append([(b.origin, b.shape) for b in [carved] + rems])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_guillotine_split_tiles_parent_exactly(name):
    held(_split_flow, name)


def _merge_flow(P):
    g = _gang(P)
    B = g.Box
    merged = [g._try_merge(a, b) for a, b in (
        (B((0, 0, 0), (2, 2, 2)), B((0, 0, 2), (2, 2, 2))),
        (B((0, 0, 0), (2, 2, 2)), B((1, 0, 2), (2, 2, 2))),  # not flush
        (B((0,), (2,)), B((2,), (2,))),  # the port's 1-D grid
        (B((2,), (2,)), B((0,), (2,))),
        (B((0,), (2,)), B((3,), (1,))),  # a gap
    )]
    return [None if m is None else (m.origin, m.shape) for m in merged]


@pytest.mark.parametrize("name", NAMES)
def test_try_merge_roundtrips_split(name):
    assert held(_merge_flow, name) == [((0, 0, 0), (2, 2, 4)), None, ((0,), (4,)),
                                       ((0,), (4,)), None]


# -- admission contiguity ----------------------------------------------------


def _random_sequence(P):
    """300 random admissions and releases of 1-, 2-, 4- and 8-host jobs on
    three 8-host slices (``tests/test_topology_placement.py``'s sequence,
    ``random.Random(7)``): each live gang's hosts contiguous on its
    package's grid, no physical host shared by two live gangs; then every
    gang released and the inventory whole again. Returns each step's
    admission outcome."""
    topo, jobs = _topo(P), _Jobs(P)
    alloc = _gang(P).SliceAllocator({_acc(P, 8): 3})
    full = alloc.free_slices(_acc(P, 8))
    rng = random.Random(7)
    live, outcomes = {}, []
    for _ in range(300):
        if live and rng.random() < 0.4:
            uid = rng.choice(list(live))
            alloc.release(uid)
            del live[uid]
            outcomes.append("release")
            continue
        hosts = rng.choice([1, 2, 4, 8])
        job = jobs(_acc(P, hosts))
        ga = alloc.admit(job)
        outcomes.append((hosts, ga is not None))
        if ga is None:
            continue
        for handle in ga.slices:
            phys = handle.physical
            assert phys is not None
            where = [handle.global_host_index(h) for h in range(ga.hosts_per_slice)]
            assert len(set(where)) == len(where)
            if P is PACKAGES["port"]:
                assert topo.host_grid_shape(phys.info) == (phys.info.hosts,)
                assert _consecutive(where), (handle.slice_id, where)
            else:
                assert topo.hosts_contiguous(phys.info, where), (handle.slice_id, where)
        live[job.metadata.uid] = ga
        seen = {}
        for uid, g in live.items():
            for handle in g.slices:
                for h in range(g.hosts_per_slice):
                    key = (handle.physical.slice_id, handle.global_host_index(h))
                    assert key not in seen, (key, uid, seen[key])
                    seen[key] = uid
    for uid in list(live):
        alloc.release(uid)
    assert alloc.free_slices(_acc(P, 8)) == full == 3
    return outcomes


@pytest.mark.parametrize("name", NAMES)
def test_every_admitted_gang_is_contiguous_on_its_grid(name):
    """The property of each package on its own grid (the reference's 3-D box
    of hosts, the port's 1-D run). The two grids carve alike only while
    their free lists do, so the admission outcomes are printed, not held
    equal: the step where a 3-D and a 1-D grid first admit differently."""
    outcomes = _random_sequence(PACKAGES[name])
    if name == "port":
        ref = _random_sequence(PACKAGES["reference"])
        first = next((i for i, (a, b) in enumerate(zip(ref, outcomes)) if a != b), None)
        admitted = {n: sum(1 for o in oc if o != "release" and o[1])
                    for n, oc in (("reference", ref), ("port", outcomes))}
        print(f"admitted {admitted}; first step admitted differently: {first}"
              + ("" if first is None else f" (reference {ref[first]}, port {outcomes[first]})"))


def _coalesce_flow(P):
    jobs = _Jobs(P)
    alloc = _gang(P).SliceAllocator({_acc(P, 4): 2})
    full = alloc.free_slices(_acc(P, 1))
    admitted = []
    while True:
        j = jobs(_acc(P, 1))
        if alloc.admit(j) is None:
            break
        admitted.append(j)
    emptied = alloc.free_slices(_acc(P, 1))
    for j in admitted:
        alloc.release(j.metadata.uid)
    return {"full": full, "admitted": len(admitted), "emptied": emptied,
            "after": alloc.free_slices(_acc(P, 1)),
            "whole_slice_fits": alloc.admit(jobs(_acc(P, 4))) is not None}


@pytest.mark.parametrize("name", NAMES)
def test_release_coalesces_back_to_full_capacity(name):
    rec = held(_coalesce_flow, name)
    assert rec == {"full": 8, "admitted": 8, "emptied": 0, "after": 8, "whole_slice_fits": True}


def _rollback_flow(P):
    jobs = _Jobs(P)
    alloc = _gang(P).SliceAllocator({_acc(P, 4): 1})
    before = alloc.free_slices(_acc(P, 2))
    # three 2-host slices cannot fit in one 4-host slice: all or nothing
    got = alloc.admit(jobs(_acc(P, 2), num_slices=3))
    return {"before": before, "admitted": got is not None,
            "after": alloc.free_slices(_acc(P, 2))}


@pytest.mark.parametrize("name", NAMES)
def test_all_or_nothing_rollback_restores_capacity(name):
    assert held(_rollback_flow, name) == {"before": 2, "admitted": False, "after": 2}


# -- placement wiring: pod selectors name PHYSICAL hosts ---------------------


def _selectors_flow(P):
    """Two 2-host jobs carved from one 4-host slice: each pod's selectors
    name the physical slice's accelerator, the slice and a host. Returns
    the selectors, accelerator names mapped to the reference's."""
    render_pod = importlib.import_module(f"{P.root}.trainer.replicas").render_pod
    jobs = _Jobs(P)
    alloc = _gang(P).SliceAllocator({_acc(P, 4): 1})
    j1, j2 = jobs(_acc(P, 2)), jobs(_acc(P, 2))
    ga1, ga2 = alloc.admit(j1), alloc.admit(j2)
    assert ga1 is not None and ga2 is not None
    out = []
    for job, ga in ((j1, ga1), (j2, ga2)):
        pods = [render_pod(job, P.t.ReplicaType.WORKER, i, ga) for i in range(ga.total_hosts)]
        resources = [p.spec.containers[0].resources for p in pods]
        # the port's one difference: a pod requests its host's cards
        assert resources == ([{"nvidia.com/gpu": "8"}] * len(pods) if _side(P) == "port"
                             else [{}] * len(pods)), resources
        out.append([{k: _unmap(P, v) for k, v in sorted(p.spec.node_selector.items())}
                    for p in pods])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_carved_jobs_render_disjoint_physical_selectors(name):
    s1, s2 = held(_selectors_flow, name)
    for pods in (s1, s2):
        # selectors name what nodes ARE labelled with: the parent slice's type
        assert {ns["tfk8s.dev/accelerator"] for ns in pods} == {"v5p-32"}
        assert {ns["tfk8s.dev/slice"] for ns in pods} == {"v5p-32/slice-0"}
    h1 = {ns["tfk8s.dev/host"] for ns in s1}
    h2 = {ns["tfk8s.dev/host"] for ns in s2}
    assert len(h1) == len(s1) and len(h2) == len(s2) and not h1 & h2


def _whole_slice_flow(P):
    alloc = _gang(P).SliceAllocator({_acc(P, 4): 1})
    ga = alloc.admit(_Jobs(P)(_acc(P, 4)))
    return sorted(ga.global_host_of(p) for p in range(ga.total_hosts))


@pytest.mark.parametrize("name", NAMES)
def test_whole_slice_job_covers_all_hosts(name):
    assert held(_whole_slice_flow, name) == [0, 1, 2, 3]


def _sub_host_flow(P):
    """A sub-host shape (``v5litepod-4`` of a one-host ``v5litepod-8``; the
    port's ``h100-4`` of an ``h100-8``) takes the whole host in both: one
    fits, a second is refused. The records of two 1-host jobs carved from a
    2-host slice name hosts 0 and 1 of slice 0."""
    whole, part = SUB_HOST[_side(P)]
    jobs = _Jobs(P)
    alloc = _gang(P).SliceAllocator({whole: 1})
    free = alloc.free_slices(part)
    first, second = alloc.admit(jobs(part)), alloc.admit(jobs(part))
    rec = {"free": free, "first": first is not None, "second": second is not None,
           "free_after": alloc.free_slices(part)}
    render_pod = importlib.import_module(f"{P.root}.trainer.replicas").render_pod
    alloc = _gang(P).SliceAllocator({_acc(P, 2): 1})
    hosts = []
    for job in (jobs(_acc(P, 1)), jobs(_acc(P, 1))):
        ns = render_pod(job, P.t.ReplicaType.WORKER, 0, alloc.admit(job)).spec.node_selector
        hosts.append((_unmap(P, ns["tfk8s.dev/slice"]), ns["tfk8s.dev/host"]))
    rec["hosts"] = hosts
    return rec


@pytest.mark.parametrize("name", NAMES)
def test_a_sub_host_job_takes_its_whole_host(name):
    assert held(_sub_host_flow, name) == {
        "free": 1, "first": True, "second": False, "free_after": 0,
        "hosts": [("v5p-16/slice-0", "0"), ("v5p-16/slice-0", "1")]}


# -- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_host_geometry_matches_the_machine(name):
    """The reference's case is its own test: a v4/v5p host owns a 2x2x1
    block of the chip torus. The port's case is the contract of its
    ``utils/topology.py`` docstring, a deliberate difference: an H100 host
    is 8 cards all to all, so ``h100-1``, ``-2``, ``-4`` and ``-8`` are one
    host, a larger N is N/8 hosts, the host grid is ``(hosts,)``, and any
    other N or generation is refused naming what is accepted."""
    P = PACKAGES[name]
    topo = _topo(P)
    if name == "reference":
        v5p128 = topo.parse_accelerator("v5p-128")
        assert v5p128.topology == (4, 4, 4)
        assert topo.host_block_shape(v5p128) == (2, 2, 1)
        assert topo.host_grid_shape(v5p128) == (2, 2, 4)
        assert topo.host_block_shape(topo.parse_accelerator("v5p-32", "2x2x4")) == (2, 2, 1)
        assert topo.host_block_shape(topo.parse_accelerator("v5litepod-16")) == (2, 2)
        return
    for n, hosts in ((1, 1), (2, 1), (4, 1), (8, 1), (16, 2), (64, 8)):
        info = topo.parse_accelerator(f"h100-{n}")
        assert (info.chips, info.hosts, info.topology) == (n, hosts, (n,))
        assert topo.host_grid_shape(info) == (hosts,)
        assert info.chips_per_host == (n if n <= 8 else 8)
    for bad, words in (("h100-3", "1, 2, 4, 8"), ("h100-12", "8-chip hosts"),
                       ("v5p-128", "accepted: cpu-N, h100-N")):
        with pytest.raises(topo.TopologyError, match=words):
            topo.parse_accelerator(bad)
    assert not hasattr(topo, "host_block_shape") and not hasattr(topo, "hosts_contiguous")


def _noncontiguous(P):
    topo = _topo(P)
    info = topo.parse_accelerator(_acc(P, 8))
    grid = topo.host_grid_shape(info)
    corner_a = topo.host_index_of(info, tuple(0 for _ in grid))
    corner_b = topo.host_index_of(info, tuple(g - 1 for g in grid))
    return {"hosts": info.hosts, "corners": (corner_a, corner_b)}


@pytest.mark.parametrize("name", NAMES)
def test_opposite_corners_are_not_contiguous(name):
    """Hosts 0 and 7 of an 8-host slice, its grid's opposite corners, are
    not contiguous: by ``hosts_contiguous`` on the reference's 3-D grid, by
    a run of consecutive indices on the port's 1-D one."""
    P = PACKAGES[name]
    rec = held(_noncontiguous, name)
    assert rec == {"hosts": 8, "corners": (0, 7)}
    if name == "reference":
        info = _topo(P).parse_accelerator("v5p-64")
        assert _topo(P).hosts_contiguous(info, range(8))
        assert not _topo(P).hosts_contiguous(info, [0, 7])
    else:
        assert _consecutive(range(8)) and not _consecutive([0, 7])


@pytest.mark.parametrize("name", NAMES)
def test_an_unknown_accelerator_is_refused_typed(name):
    """An allocator asked for a shape it cannot parse raises its package's
    ``TopologyError`` in both."""
    P = PACKAGES[name]
    got = raised(P, _topo(P).parse_accelerator, "tpu9-8")
    assert got == "tfk8s_tpu.utils.topology.TopologyError"
