"""Jobs through the port's own operator against the reference's, on the CPU.

Each control plane is a fake cluster, its ``TPUJobController`` and its
``LocalKubelet`` in this process (two kubelets side by side: each reads
only its own pods' threads):

- the same ``cpu-1``, two-worker ``cpu-2`` and ``cpu-4`` ``{"data": 2,
  "tensor": 2}`` jobs, a recording entry point registered in both
  registries: equal rendered pods (uid, resourceVersion, timestamps and
  the random traceparent stripped), equal env at the entry point, equal
  condition types in order and equal event reasons;
- the reference's behaviours on the port's plane (``tests/
  test_tpujob_e2e.py``): a gang restart after ``TFK8S_TEST_FAIL_TIMES``
  (with no restart counted twice for one gang's failures), a
  job gang-pending on ``h100-8`` capacity, delete through the finalizer, a
  reclaim notice ending the pod Drained;
- the port's ``gpt:train`` at the tiny preset on ``TFK8S_DEVICE=cpu``: the
  same history through either operator, bit for bit, with its training
  progress in the port's pod status;
- ``python -m tfk8s_tpu_torch.cmd.main run`` with JAX and the reference
  package unimportable (``tests/test_torch_imports.py``'s finder).
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

from tfk8s_tpu import api as rapi
from tfk8s_tpu.api import serde as rserde
from tfk8s_tpu.client import FakeClientset as RFakeClientset
from tfk8s_tpu.runtime import LocalKubelet as RLocalKubelet
from tfk8s_tpu.runtime import registry as rregistry
from tfk8s_tpu.trainer import SliceAllocator as RSliceAllocator
from tfk8s_tpu.trainer import TPUJobController as RTPUJobController
from tfk8s_tpu_torch import api as tapi
from tfk8s_tpu_torch.api import serde as tserde
from tfk8s_tpu_torch.api.types import PodPhase
from tfk8s_tpu_torch.client import FakeClientset
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import registry
from tfk8s_tpu_torch.runtime.kubelet import LocalKubelet
from tfk8s_tpu_torch.trainer import FINALIZER, SliceAllocator, TPUJobController
from tfk8s_tpu_torch.trainer import labels as L
from tfk8s_tpu_torch.trainer import replicas as R

from conftest import wait_for
from test_torch_imports import _BLOCK
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES = {
    "reference": (rapi, RFakeClientset, RTPUJobController, RSliceAllocator, RLocalKubelet,
                  rregistry, rserde),
    "port": (tapi, FakeClientset, TPUJobController, SliceAllocator, LocalKubelet, registry,
             tserde),
}
ENVS = {}  # (plane, job, process id) -> the env the entry point received
HISTORIES = {}  # plane -> gpt:train's history
ATTEMPTS = {}  # (job, pod) -> attempts of the drainable entry point


RUNNING = {}  # plane -> its Plane while it runs


def _record(plane):
    def record(env, stop):
        """Keep the env; return once the controller has seen the gang
        running (a pod that ends first skips the Running condition)."""
        ENVS[(plane, env["TFK8S_JOB_NAME"], env["TFK8S_PROCESS_ID"])] = dict(env)
        assert wait_for(lambda: RUNNING[plane].has(env["TFK8S_JOB_NAME"], "Running"), timeout=30)
    return record


def _gpt(plane):
    def run(env, stop):
        HISTORIES[plane] = tgpt.train(env, stop)
    return run


def _echo(env, stop):
    time.sleep(0.02)


def _block(env, stop):
    stop.wait(30)


def _drainable(env, stop):
    """The first attempt waits for a reclaim notice and drains; a relaunch
    succeeds at once."""
    key = (env["TFK8S_JOB_NAME"], env["TFK8S_PROCESS_ID"])
    ATTEMPTS[key] = ATTEMPTS.get(key, 0) + 1
    if ATTEMPTS[key] == 1:
        deadline = time.monotonic() + 30
        while not stop.drain_requested and time.monotonic() < deadline:
            time.sleep(0.02)
        raise registry.PodDrained("drained at step 0 on reclaim notice")


for _plane, (_api, _cs, _ctrl, _alloc, _kl, _reg, _serde) in PLANES.items():
    _reg.register("test.operator.record", _record(_plane))
    _reg.register("test.operator.gpt", _gpt(_plane))
registry.register("test.operator.echo", _echo)
registry.register("test.operator.block", _block)
registry.register("test.operator.drainable", _drainable)


class Plane:
    """One control plane running: its clientset, controller, kubelet."""

    def __init__(self, name, capacity=None):
        self.name = name
        api, fake, controller, allocator, kubelet, _reg, self.serde = PLANES[name]
        self.api = api
        self.cs = fake()
        self.ctrl = controller(self.cs, allocator=allocator(capacity))
        self.kubelet = kubelet(self.cs)
        self.stop = threading.Event()

    def __enter__(self):
        RUNNING[self.name] = self
        self.kubelet.run(self.stop)
        assert self.ctrl.run(workers=2, stop=self.stop, block=False)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.ctrl.controller.shutdown()

    def job(self, name, accelerator="cpu-1", workers=1, entrypoint="test.operator.record",
            mesh=None, **env):
        a = self.api
        return a.TPUJob(
            metadata=a.ObjectMeta(name=name),
            spec=a.TPUJobSpec(
                replica_specs={a.ReplicaType.WORKER: a.ReplicaSpec(
                    replicas=workers, template=a.ContainerSpec(entrypoint=entrypoint, env=env))},
                tpu=a.TPUSpec(accelerator=accelerator),
                mesh=None if mesh is None else a.MeshSpec(axes=mesh),
                run_policy=a.RunPolicy(scheduling=a.SchedulingPolicy(gang=True)),
            ),
        )

    def status(self, name):
        try:
            return self.cs.tpujobs().get(name).status
        except Exception as e:  # noqa: BLE001 — either package's NotFound
            if type(e).__name__ == "NotFound":
                return None
            raise

    def has(self, name, cond):
        st = self.status(name)
        return st is not None and any(
            c.type.value == cond and c.status for c in st.conditions)

    def ended(self, name):
        return self.has(name, "Succeeded") or self.has(name, "Failed")

    def pods(self, name):
        pods, _ = self.cs.pods().list(label_selector={L.JOB_NAME: name})
        return sorted(pods, key=lambda p: p.metadata.name)

    def reasons(self, name):
        return [e.reason for e in self.ctrl.recorder.events(key=f"default/{name}")]


def _unnumbered(text):
    """A hermetic slice's number counts the allocator's admissions, a job
    re-admitted by a sync that raced its own status write included, so it
    depends on reconcile timing on both operators."""
    return re.sub(r"cpu/slice-[0-9]+", "cpu/slice-N", text)


def _stripped_pod(serde, pod):
    """A pod's wire form without what differs between two runs of one job:
    ids, versions, times, the random traceparent, the slice number, the
    status but its phase."""
    w = json.loads(_unnumbered(json.dumps(serde.to_wire(pod), sort_keys=True)))
    meta = w["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp", "deletionTimestamp"):
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    for c in w["spec"]["containers"]:
        c["env"].pop("TFK8S_TRACEPARENT", None)
    w["status"] = {"phase": w["status"]["phase"]}
    return w


PARITY_JOBS = {
    "one": dict(accelerator="cpu-1"),
    "two": dict(accelerator="cpu-2", workers=2),
    "four": dict(accelerator="cpu-4", mesh={"data": 2, "tensor": 2}),
}


@pytest.fixture(scope="module")
def parity():
    """The parity jobs through each plane, one after another (the hermetic
    slices are numbered in admission order): {plane: {job: (condition
    types, event reasons, stripped pods)}}."""
    out = {}
    for name in PLANES:
        with Plane(name) as plane:
            for job, spec in PARITY_JOBS.items():
                plane.cs.tpujobs().create(plane.job(job, **spec))
                assert wait_for(lambda: plane.ended(job), timeout=60)
                # the terminal event lands after the terminal status
                assert wait_for(lambda: "JobSucceeded" in plane.reasons(job), timeout=10)
            out[name] = {
                # each reason once, in order: a sync racing its own status
                # write records a reason twice, on either operator
                job: ([c.type.value for c in plane.status(job).conditions],
                      list(dict.fromkeys(plane.reasons(job))),
                      [_stripped_pod(plane.serde, p) for p in plane.pods(job)])
                for job in PARITY_JOBS
            }
    return out


@pytest.mark.parametrize("job", sorted(PARITY_JOBS))
def test_rendered_pods_equal_the_reference_s(parity, job):
    ref, port = parity["reference"][job][2], parity["port"][job][2]
    assert len(port) == PARITY_JOBS[job].get("workers", 1)
    assert port == ref
    assert all(p["status"]["phase"] == "Succeeded" for p in port)
    assert all("nvidia.com/gpu" not in p["spec"]["containers"][0]["resources"] for p in port)


@pytest.mark.parametrize("job", sorted(PARITY_JOBS))
def test_entry_point_env_equals_the_reference_s(parity, job):
    def envs(plane):
        return {pid: {k: _unnumbered(v) for k, v in env.items() if k != "TFK8S_TRACEPARENT"}
                for (p, j, pid), env in ENVS.items() if (p, j) == (plane, job)}

    ref, port = envs("reference"), envs("port")
    assert sorted(port) == [str(i) for i in range(PARITY_JOBS[job].get("workers", 1))]
    assert port == ref
    if job == "four":
        assert port["0"]["TFK8S_MESH"] == '{"data": 2, "tensor": 2}'


@pytest.mark.parametrize("job", sorted(PARITY_JOBS))
def test_conditions_and_event_reasons_equal_the_reference_s(parity, job):
    ref, port = parity["reference"][job], parity["port"][job]
    assert port[0] == ref[0]
    assert port[0][-1] == "Succeeded"
    assert port[1] == ref[1]
    assert "JobSucceeded" in port[1]


# -- the reference's behaviours on the port's plane --------------------------------


@pytest.fixture
def plane():
    with Plane("port", capacity={"h100-8": 1}) as p:
        yield p


def test_a_failed_pod_restarts_the_gang_then_succeeds(plane):
    job = plane.job("flaky", accelerator="cpu-2", workers=2, entrypoint="test.operator.echo",
                    TFK8S_TEST_FAIL_TIMES="1")
    plane.cs.tpujobs().create(job)
    assert wait_for(lambda: plane.has("flaky", "Succeeded"), timeout=60)
    # each pod name fails its first attempt, and a gang restart can delete
    # a worker before that attempt ran, so it fails in a later generation:
    # at most one restart a worker
    assert 1 <= plane.status("flaky").gang_restarts <= 2
    assert "GangRestart" in plane.reasons("flaky")


def test_a_stale_failed_pod_of_a_restarted_gang_counts_no_restart():
    """F10: a lagging pod cache shows the failed pods of one gang one
    subset at a time; after the restart that the first subset counted, the
    others are deleted, not counted."""
    cs = FakeClientset()
    ctrl = TPUJobController(cs, allocator=SliceAllocator(None))
    job = cs.tpujobs().create(tapi.defaults.set_defaults(
        Plane("port").job("stale", accelerator="cpu-2", workers=2)))
    pods, _ = R.render_all(job, ctrl.allocator.admit(job))
    for i, pod in enumerate(pods):
        pod.metadata.uid, pod.status.phase = f"{i:08d}", PodPhase.FAILED
    observed = {p.metadata.name: p for p in pods}
    assert ctrl._handle_failures(job, pods[:1], observed)
    assert job.status.gang_restarts == 1
    for stale in (pods[1:], pods):
        assert ctrl._handle_failures(job, stale, observed)
        assert job.status.gang_restarts == 1
    assert cs.tpujobs().get("stale").status.gang_restarts == 1
    assert [e.reason for e in ctrl.recorder.events(key="default/stale")] == ["GangRestart"]
    # a pod of the restarted gang that fails is a new episode
    pods[0].metadata.uid = "00000002"
    pods[0].spec.containers[0].env["TFK8S_GANG_RESTARTS"] = "1"
    assert ctrl._handle_failures(job, pods, observed)
    assert job.status.gang_restarts == 2


def test_a_gang_waits_for_h100_capacity(plane):
    """One h100-8 host: the second job is gang-pending, no pod made, until
    the first one goes."""
    cs = plane.cs
    cs.tpujobs().create(plane.job("first", accelerator="h100-8", entrypoint="test.operator.block"))
    assert wait_for(lambda: plane.has("first", "Running"))
    (pod,) = plane.pods("first")
    assert pod.spec.containers[0].resources == {"nvidia.com/gpu": "8"}
    cs.tpujobs().create(plane.job("second", accelerator="h100-8",
                                  entrypoint="test.operator.block"))
    assert wait_for(lambda: "GangPending" in plane.reasons("second"))
    assert plane.pods("second") == []
    assert not plane.has("second", "Running")
    cs.tpujobs().delete("first")
    assert wait_for(lambda: plane.has("second", "Running"), timeout=20)


def test_delete_tears_down_through_the_finalizer(plane):
    cs = plane.cs
    cs.tpujobs().create(plane.job("longrun", entrypoint="test.operator.block"))
    assert wait_for(lambda: plane.has("longrun", "Running"))
    job = cs.tpujobs().get("longrun")
    assert FINALIZER in job.metadata.finalizers
    assert job.status.start_time is not None
    cs.tpujobs().delete("longrun")
    assert wait_for(lambda: plane.status("longrun") is None)
    assert plane.pods("longrun") == []


def test_a_reclaim_notice_ends_the_pod_drained(plane):
    """The drained pod costs no backoff: the controller relaunches it and
    the job succeeds."""
    cs = plane.cs
    cs.tpujobs().create(plane.job("reclaimed", entrypoint="test.operator.drainable"))
    assert wait_for(lambda: plane.has("reclaimed", "Running"))
    assert wait_for(lambda: ATTEMPTS.get(("reclaimed", "0")) == 1)
    (pod,) = plane.pods("reclaimed")
    written, set_phase = [], plane.kubelet._set_phase

    def recording(key, uid, phase, *args, **kwargs):
        written.append((uid, phase))
        return set_phase(key, uid, phase, *args, **kwargs)

    plane.kubelet._set_phase = recording
    plane.kubelet.deliver_reclaim(pod.metadata.key, grace_s=30.0)
    assert wait_for(lambda: plane.has("reclaimed", "Succeeded"), timeout=30)
    assert (pod.metadata.uid, PodPhase.DRAINED) in written
    st = plane.status("reclaimed")
    assert (st.preemptions, st.gang_restarts) == (1, 0)
    assert "ReclaimRestart" in plane.reasons("reclaimed")
    assert ATTEMPTS[("reclaimed", "0")] == 2


# -- the port's trainer through either operator ------------------------------------


GPT_ENV = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_TRAIN_STEPS": "3",
           "TFK8S_SEQ_LEN": "16", "TFK8S_BATCH_SIZE": "4", "TFK8S_LOG_EVERY": "1",
           "TFK8S_SEED": "3"}


def test_the_port_trainer_runs_alike_under_either_operator():
    pods = {}
    for name in PLANES:
        with Plane(name) as plane:
            plane.cs.tpujobs().create(plane.job("gpt", entrypoint="test.operator.gpt", **GPT_ENV))
            assert wait_for(lambda: plane.ended("gpt"), timeout=60)
            assert plane.has("gpt", "Succeeded")
            (pods[name],) = plane.pods("gpt")
    def untimed(history):
        return [{k: v for k, v in h.items() if k != "steps_per_s"} for h in history]

    ref, port = untimed(HISTORIES["reference"]), untimed(HISTORIES["port"])
    assert [h["step"] for h in port] == [1, 2, 3]
    assert port == ref
    training = pods["port"].status.training
    assert training["step"] == 3 and training["steps_per_sec"] > 0
    assert training["compile_seconds"] == training["first_step_seconds"] > 0
    assert set(training) == set(pods["reference"].status.training)


# -- the command line, with JAX out of reach ---------------------------------------


def test_cmd_run_exits_0_with_jax_blocked():
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_LOG_EVERY": "100"}
    code = _BLOCK + (
        "from tfk8s_tpu_torch.cmd.main import main\n"
        f"rc = main(['run', '--entrypoint', 'tfk8s_tpu_torch.models.mlp:train', '--replicas',"
        f" '1', '--accelerator', 'cpu-1', '--timeout', '120', '--env', {json.dumps(env)!r}])\n"
        "assert not [m for m in sys.modules if forbidden(m)]\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
                          timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "job succeeded" in proc.stderr
