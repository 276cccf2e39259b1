"""The port's control plane API against the reference's, on the CPU.

``tfk8s_tpu_torch`` keeps its own copy of the operator (``api/``,
``client/``, ``controller/``, ``trainer/``, ``runtime/kubelet.py``,
``cmd/``) with the reference's API group, kinds and wire form, and the
accelerator vocabulary of NVIDIA hosts (``utils/topology.py``):

- every example manifest decodes through both packages' serde to equal
  wire dicts, and the wire golden round-trips byte for byte;
- defaults and validation give the reference's objects and error texts
  for ``cpu-*``; TPU slices are refused, naming ``h100``;
- ``h100-N`` hosts, the gang allocator carving them, and the
  ``nvidia.com/gpu`` pod rendering;
- the port's kubelet is no node agent ``runtime/node_agent`` finds from
  its stop object, and a port replica registers once in its own table.

``tests/test_torch_operator_e2e.py`` runs jobs through both operators.
"""

import glob
import json
import os
import sys
import threading

import pytest

from tfk8s_tpu.api import defaults as rdefaults
from tfk8s_tpu.api import serde as rserde
from tfk8s_tpu.api import validation as rvalidation
from tfk8s_tpu.cmd.main import load_manifest as rload
from tfk8s_tpu_torch.api import defaults as tdefaults
from tfk8s_tpu_torch.api import serde as tserde
from tfk8s_tpu_torch.api import validation as tvalidation
from tfk8s_tpu_torch.api.types import (
    ContainerSpec,
    MeshSpec,
    ObjectMeta,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
)
from tfk8s_tpu_torch.cmd.main import load_manifest as tload
from tfk8s_tpu_torch.obs import trace as ttrace
from tfk8s_tpu_torch.runtime import kubelet as tkubelet
from tfk8s_tpu_torch.runtime import node_agent, progress, registry
from tfk8s_tpu_torch.trainer import replicas as treplicas
from tfk8s_tpu_torch.trainer.gang import SliceAllocator
from tfk8s_tpu_torch.utils import topology as ttopo

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "manifests", "examples")
GOLDEN = os.path.join(REPO, "tests", "golden", "tpujob_wire.json")
MANIFESTS = sorted(glob.glob(os.path.join(EXAMPLES, "*.yaml")))
NAMES = [os.path.basename(p) for p in MANIFESTS]


def _wire(serde, obj):
    return json.loads(json.dumps(serde.to_wire(obj), sort_keys=True))


def _accelerator(path):
    return rload(path).spec.tpu.accelerator


def test_twelve_manifests():
    assert len(MANIFESTS) == 12


@pytest.mark.parametrize("path", MANIFESTS, ids=NAMES)
def test_each_manifest_decodes_to_the_reference_wire(path):
    ref, port = rload(path), tload(path)
    assert type(port).__name__ == type(ref).__name__
    assert _wire(tserde, port) == _wire(rserde, ref)
    assert _wire(tserde, tserde.decode_object(tserde.to_wire(port))) == _wire(rserde, ref)


def test_the_wire_golden_round_trips_byte_for_byte():
    with open(GOLDEN) as f:
        text = f.read()
    job = tserde.decode_object(json.loads(text))
    assert json.dumps(tserde.to_wire(job), indent=2, sort_keys=True) == text.strip()


# -- defaults and validation ---------------------------------------------------------


def _defaulted(path, pkg_load, defaults_mod, validation_mod):
    obj = pkg_load(path)
    if type(obj).__name__ == "TPUServe":
        defaults_mod.set_serve_defaults(obj)
        return obj, validation_mod.validate_serve(obj)
    defaults_mod.set_defaults(obj)
    return obj, validation_mod.validate(obj)


CPU_MANIFESTS = [p for p in MANIFESTS if _accelerator(p).startswith("cpu")]
TPU_MANIFESTS = [p for p in MANIFESTS if not _accelerator(p).startswith("cpu")]


@pytest.mark.parametrize("path", CPU_MANIFESTS, ids=os.path.basename)
def test_cpu_manifests_default_and_validate_as_the_reference(path):
    """Equal objects, except that a TPUServe with no entry point defaults
    to each package's own model server."""
    ref, ref_errs = _defaulted(path, rload, rdefaults, rvalidation)
    port, port_errs = _defaulted(path, tload, tdefaults, tvalidation)
    if type(port).__name__ == "TPUServe" and not rload(path).spec.template.entrypoint:
        assert ref.spec.template.entrypoint == rdefaults.DEFAULT_SERVE_ENTRYPOINT
        assert port.spec.template.entrypoint == "tfk8s_tpu_torch.runtime.server:serve"
        port.spec.template.entrypoint = ref.spec.template.entrypoint
    assert _wire(tserde, port) == _wire(rserde, ref)
    assert port_errs == ref_errs == []


def _breakages():
    """Invalid edits of a cpu job, each applied the same way to both
    packages' objects."""

    def name(j):
        j.metadata.name = "Bad_Name"

    def mesh(j):
        j.spec.mesh.axes = {"data": 3}

    def replicas(j):
        next(iter(j.spec.replica_specs.values())).replicas = -1

    def provider(j):
        j.spec.tpu.provider = "aws"

    def slices(j):
        j.spec.tpu.num_slices = 0

    def topology(j):
        j.spec.tpu.topology = "3x3"

    def template(j):
        tmpl = next(iter(j.spec.replica_specs.values())).template
        tmpl.entrypoint, tmpl.image = "", ""

    def policy(j):
        j.spec.run_policy.backoff_limit = -1
        j.spec.run_policy.active_deadline_seconds = 0

    def accelerator(j):
        j.spec.tpu.accelerator = "cpu-0"

    # provider "gke" is refused for cpu on both, each naming its own
    # generations (test_gke_is_refused_for_cpu_naming_h100)
    return [name, mesh, replicas, provider, slices, topology, template, policy, accelerator]


JOB_CPU_MANIFESTS = [p for p in CPU_MANIFESTS if type(rload(p)).__name__ == "TPUJob"]


@pytest.mark.parametrize("path", JOB_CPU_MANIFESTS, ids=os.path.basename)
def test_cpu_error_texts_are_the_reference_texts(path):
    for breakage in _breakages():
        ref, port = rload(path), tload(path)
        for job, mod in ((ref, rdefaults), (port, tdefaults)):
            mod.set_defaults(job)
            breakage(job)
        ref_errs, port_errs = rvalidation.validate(ref), tvalidation.validate(port)
        assert ref_errs, breakage.__name__
        assert port_errs == ref_errs, breakage.__name__


@pytest.mark.parametrize("path", TPU_MANIFESTS, ids=os.path.basename)
def test_tpu_slices_are_refused_naming_h100(path):
    job = tload(path)
    tdefaults.set_defaults(job)
    errs = tvalidation.validate(job)
    assert len(errs) == 1 and errs[0].startswith("spec.tpu: unknown accelerator generation 'v5p'")
    assert "h100-N" in errs[0] and "a TPU slice cannot run on this operator" in errs[0]
    with pytest.raises(tvalidation.ValidationError):
        tvalidation.validate_or_raise(job)


def _h100_job(accelerator, workers=1, mesh=None, provider="", name="g"):
    return TPUJob(
        metadata=ObjectMeta(name=name, uid=f"uid-{name}"),
        spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=workers,
                template=ContainerSpec(entrypoint="tfk8s_tpu_torch.models.gpt:train"))},
            tpu=TPUSpec(accelerator=accelerator, provider=provider),
            mesh=None if mesh is None else MeshSpec(axes=mesh),
        ),
    )


@pytest.mark.parametrize("accelerator,hosts,mesh", [
    ("h100-1", 1, {"data": 1}), ("h100-8", 1, {"data": 8}), ("h100-16", 2, {"data": 16}),
])
def test_h100_defaults_and_host_rules(accelerator, hosts, mesh):
    """The mesh defaults to one data axis over every card; compute replicas
    must equal hosts and the mesh the cards, with the reference's texts."""
    job = tdefaults.set_defaults(_h100_job(accelerator, workers=hosts))
    assert job.spec.mesh.axes == mesh
    assert tvalidation.validate(job) == []
    wrong = tdefaults.set_defaults(_h100_job(accelerator, workers=hosts + 1, mesh={"data": 3}))
    cards = mesh["data"]
    assert tvalidation.validate(wrong) == [
        f"spec.replicaSpecs: {hosts + 1} compute replicas (Chief+Worker) but {accelerator} x1 "
        f"has {hosts} host(s); one process per host",
        f"spec.mesh: axes product 3 != total chips {cards} ({accelerator} x 1)",
    ]


# -- topology --------------------------------------------------------------------------


@pytest.mark.parametrize("accelerator,cards,hosts", [
    ("h100-1", 1, 1), ("h100-2", 2, 1), ("h100-4", 4, 1), ("h100-8", 8, 1),
    ("h100-16", 16, 2), ("h100-32", 32, 4),
])
def test_h100_sizes_parse_to_hosts(accelerator, cards, hosts):
    info = ttopo.parse_accelerator(accelerator)
    assert (info.generation, info.chips, info.hosts, info.topology) == (
        "h100", cards, hosts, (cards,))
    assert info.chips_per_host == min(cards, 8)
    assert ttopo.host_grid_shape(info) == (hosts,)


@pytest.mark.parametrize("accelerator,message", [
    ("h100-3", "'h100-3': 3 chips do not split one 8-chip host evenly (one host takes 1, 2, 4, 8)"),
    ("h100-12", "'h100-12': 12 chips not divisible into 8-chip hosts"),
    ("h100-0", "accelerator size must be >= 1, got 'h100-0'"),
    ("v5p-32", "unknown accelerator generation 'v5p' (accepted: cpu-N, h100-N; "
               "a TPU slice cannot run on this operator)"),
    ("a100-8", "unknown accelerator generation 'a100' (accepted: cpu-N, h100-N; "
               "a TPU slice cannot run on this operator)"),
    ("h100_8", "unknown accelerator type 'h100_8'"),
])
def test_other_sizes_are_refused(accelerator, message):
    with pytest.raises(ttopo.TopologyError) as e:
        ttopo.parse_accelerator(accelerator)
    assert str(e.value) == message


def test_cpu_sizes_parse_as_the_reference():
    from tfk8s_tpu.utils import topology as rtopo

    for acc, topo in (("cpu", ""), ("cpu-1", ""), ("cpu-4", ""), ("cpu-8", "2x4")):
        ref, port = rtopo.parse_accelerator(acc, topo), ttopo.parse_accelerator(acc, topo)
        assert (port.generation, port.chips, port.hosts, port.topology) == (
            ref.generation, ref.chips, ref.hosts, ref.topology)


def test_an_h100_16_carves_two_h100_8_gangs_onto_disjoint_hosts():
    alloc = SliceAllocator({"h100-16": 1})
    a = alloc.admit(tdefaults.set_defaults(_h100_job("h100-8", name="a")))
    b = alloc.admit(tdefaults.set_defaults(_h100_job("h100-8", name="b")))
    assert a is not None and b is not None
    ha, hb = a.global_host_of(0), b.global_host_of(0)
    assert {ha, hb} == {0, 1}
    assert a.slices[0].physical.slice_id == b.slices[0].physical.slice_id
    # the host inventory is spent: a third gang waits
    assert alloc.admit(tdefaults.set_defaults(_h100_job("h100-8", name="c"))) is None
    # a two-host job needs both hosts at once
    alloc.release("uid-a")
    assert alloc.admit(tdefaults.set_defaults(_h100_job("h100-16", workers=2, name="d"))) is None
    alloc.release("uid-b")
    d = alloc.admit(tdefaults.set_defaults(_h100_job("h100-16", workers=2, name="d")))
    assert sorted(d.global_host_of(p) for p in range(2)) == [0, 1]


# -- rendering -------------------------------------------------------------------------


@pytest.mark.parametrize("accelerator,workers,cards", [("h100-1", 1, "1"), ("h100-16", 2, "8")])
def test_a_gke_pod_requests_its_host_s_cards(accelerator, workers, cards):
    job = tdefaults.set_defaults(_h100_job(accelerator, workers=workers, provider="gke"))
    assert tvalidation.validate(job) == []
    ga = SliceAllocator({accelerator: 1}).admit(job)
    pods, _services = treplicas.render_all(job, ga)
    assert len(pods) == workers
    for pod in pods:
        (container,) = pod.spec.containers
        assert container.resources == {"nvidia.com/gpu": cards}
        assert pod.spec.node_selector == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        wire = tserde.to_wire(pod)
        assert wire["spec"]["containers"][0]["resources"] == {"nvidia.com/gpu": cards}


def test_a_hermetic_h100_pod_requests_cards_and_selects_its_host():
    job = tdefaults.set_defaults(_h100_job("h100-1"))
    pod = treplicas.render_pod(job, ReplicaType.WORKER, 0,
                               SliceAllocator({"h100-1": 1}).admit(job))
    assert pod.spec.containers[0].resources == {"nvidia.com/gpu": "1"}
    assert pod.spec.node_selector == {"tfk8s.dev/accelerator": "h100-1",
                                      "tfk8s.dev/slice": "h100-1/slice-0",
                                      "tfk8s.dev/host": "0"}
    env = pod.spec.containers[0].env
    assert (env["TFK8S_ACCELERATOR"], env["TFK8S_MESH"]) == ("h100-1", '{"data": 1}')
    assert "TFK8S_DEVICE" not in env


def test_gke_is_refused_for_cpu_naming_h100():
    job = tdefaults.set_defaults(_h100_job("cpu-1", provider="gke"))
    assert tvalidation.validate(job) == [
        "spec.tpu.provider: 'gke' has no nodepool shape for generation 'cpu' "
        "(supported: ['h100'])"]


def test_the_h100_example_manifest_loads_and_validates():
    path = os.path.join(EXAMPLES, "gpt-h100-torch.json")
    job = tdefaults.set_defaults(tload(path))
    assert tvalidation.validate(job) == []
    (worker,) = job.spec.replica_specs.values()
    assert (worker.replicas, worker.template.entrypoint) == (
        1, "tfk8s_tpu_torch.models.gpt:train")
    assert job.spec.tpu.accelerator == "h100-1"
    assert job.spec.mesh.axes == {"data": 1}
    env = worker.template.env
    assert env["TFK8S_MODEL_PRESET"] == "base" and "TFK8S_DEVICE" not in env
    # JSON, so a host without PyYAML reads it too
    with open(path) as f:
        assert tserde.decode_object(json.load(f)) == tload(path)


# -- the node agent --------------------------------------------------------------------


def test_the_port_kubelet_is_no_node_agent_of_its_stop_signal():
    """The port's kubelet reads the port's own drained class, progress dict
    and tracer, so node_agent finds no agent behind its stop signal and the
    pod reports as it would outside any agent."""
    stop = tkubelet.PodStopSignal()
    assert node_agent.find(stop) is None
    assert tkubelet.PodDrained is node_agent.PodDrained is registry.PodDrained
    assert tkubelet.pod_progress is progress
    tracer = ttrace.Tracer()
    prev = ttrace.set_tracer(tracer)
    ident = threading.get_ident()
    try:
        with node_agent.attach(stop) as bound:
            assert bound is None
            progress.report(step=3)
            assert ttrace.get_tracer() is tracer
        assert progress.snapshot(ident) == {"step": 3.0}
    finally:
        progress.clear(ident)
        ttrace.set_tracer(prev)


def test_the_reference_kubelet_s_tracer_holds_only_while_a_pod_is_bound():
    from tfk8s_tpu.obs import trace as rtrace
    from tfk8s_tpu.runtime import kubelet as rkubelet

    with node_agent.attach(rkubelet.PodStopSignal()) as bound:
        assert bound is not None
        assert ttrace.get_tracer() is rtrace.get_tracer()
    assert isinstance(ttrace.get_tracer(), ttrace.Tracer)


def test_a_port_replica_registers_once_in_its_own_table():
    """Under the port's kubelet no agent's serving table is found: the
    replica is registered once, unwrapped, in the port's own table."""
    from tfk8s_tpu_torch.runtime import server

    stop = tkubelet.PodStopSignal()
    assert node_agent.serving_module(stop) is None
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_TASK": "echo", "TFK8S_POD_NAME": "echo-0"}
    done = []
    t = threading.Thread(target=lambda: done.append(server.serve(env, stop)), daemon=True)
    t.start()
    try:
        assert wait_for(lambda: server.lookup_replica("default/echo-0") is not None, timeout=30)
        replica = server.lookup_replica("default/echo-0")
        assert type(replica).__name__ == "ModelServer"
        assert "default/echo-0" in server.replica_keys()
    finally:
        stop.set()
        t.join(timeout=30)
    assert done == [None]
    assert server.lookup_replica("default/echo-0") is None


def test_the_reference_kubelet_still_gets_a_wrapped_replica():
    """Under the reference's kubelet the agent's table is the reference's
    server module, where the port registers a wrapped replica."""
    from tfk8s_tpu.runtime import kubelet as rkubelet
    from tfk8s_tpu.runtime import server as rserver

    assert node_agent.serving_module(rkubelet.PodStopSignal()) is rserver
    assert sys.modules["tfk8s_tpu_torch.runtime.server"] is not rserver
