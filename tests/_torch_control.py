"""Both packages' control-plane modules side by side, for the tests that run
one flow through the reference and through the port and hold the records
equal: ``PACKAGES[name]`` holds the api types, serde, the apiserver, the
remote client, the stores, the operator's ``Options``/``Server``, the
kubelet, the entry-point registry, ``cmd.main``, ``LeaderElector``, the
controllers and the checkpointer. ``masked`` blanks what differs between
two runs of one flow: uids, resource versions and times. ``Cluster`` is
one package's fake cluster with its controller and kubelet running."""

import contextlib
import importlib
import io
import json
import re
import threading
import types

from conftest import wait_for

NAMES = ("reference", "port")
ROOTS = {"reference": "tfk8s_tpu", "port": "tfk8s_tpu_torch"}


def _load(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, t=m("api.types"), serde=m("api.serde"), helpers=m("api.helpers"),
        apiserver=m("client.apiserver"), remote=m("client.remote"), store=m("client.store"),
        Clientset=m("client.clientset").Clientset, FakeClientset=m("client").FakeClientset,
        Options=m("cmd.options").Options, Server=m("cmd.server").Server,
        LocalKubelet=m("runtime.kubelet").LocalKubelet, registry=m("runtime.registry"),
        main=m("cmd.main"),
        LeaderElector=m("controller").LeaderElector, labels=m("trainer.labels"),
        trace=m("obs.trace"), progress=m("runtime.progress"), trainer=m("trainer"),
        kubelet=m("runtime.kubelet"), checkpoint=m("runtime.checkpoint"),
        launcher=m("runtime.launcher"))


PACKAGES = {name: _load(root) for name, root in ROOTS.items()}
_TIMES = re.compile(r"(Timestamp|Time)$")


def masked(value):
    """uids, resource versions and times differ between two runs of one
    flow; every other field must not."""
    if isinstance(value, dict):
        return {k: ("<masked>" if v is not None and (k in ("uid", "resourceVersion")
                                                      or _TIMES.search(k))
                    else masked(v)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [masked(v) for v in value]
    return value


def wire(P, obj):
    """An object's masked wire form, the port's package name written as the
    reference's."""
    return masked(json.loads(json.dumps(P.serde.to_wire(obj)).replace("tfk8s_tpu_torch",
                                                                        "tfk8s_tpu")))


def make_job(P, name, entrypoint, workers=1, accelerator="cpu-1", env=None, labels=None,
             gang=True):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default", labels=dict(labels or {})),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=workers,
                template=t.ContainerSpec(entrypoint=entrypoint, env=dict(env or {})))},
            tpu=t.TPUSpec(accelerator=accelerator),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=gang)),
        ),
    )


def has(P, status, cond):
    return P.helpers.has_condition(status, getattr(P.t.JobConditionType, cond.upper()))


def kubeconfig(tmp_path, url, name="kubeconfig.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"server": url}))
    return str(path)


class ThreadStdout(io.TextIOBase):
    """``sys.stdout`` for flows that run side by side on threads: each
    thread writes into the buffer it (or the thread that started it)
    bound; an unbound thread writes to the stream that was there before."""

    def __init__(self, fallback):
        self.fallback = fallback
        self.local = threading.local()

    @contextlib.contextmanager
    def bound(self, buf):
        prev = getattr(self.local, "buf", None)
        self.local.buf = buf
        try:
            yield buf
        finally:
            self.local.buf = prev

    def current(self):
        return getattr(self.local, "buf", None)

    def write(self, s):
        buf = self.current()
        return (buf if buf is not None else self.fallback).write(s)

    def flush(self):
        pass


def run_side_by_side(flows, timeout=60.0):
    """Run ``flows[name]()`` for every name at once, each on its own thread;
    return ``{name: result}``. A flow's exception is raised here, and a flow
    that has not ended within ``timeout`` seconds fails the test."""
    results, errors = {}, {}

    def run(name):
        try:
            results[name] = flows[name]()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=run, args=(n,), name=f"flow-{n}", daemon=True)
               for n in flows]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    stuck = [t.name for t in threads if t.is_alive()]
    assert not stuck, f"{stuck} did not end within {timeout} s"
    for name, e in errors.items():
        raise AssertionError(f"the {name} flow failed: {e!r}") from e
    return results


def wait(pred, timeout=90.0):
    """``conftest.wait_for``, failing the test when ``pred`` stays false."""
    assert wait_for(pred, timeout=timeout)


class Cluster:
    """One package's fake cluster running in this process: its clientset, a
    ``TPUJobController`` over a ``SliceAllocator`` of ``capacity`` (or,
    with ``serves``, a ``TPUServeController``) and its ``LocalKubelet``. On
    exit every job and serve is deleted and the kubelet's pod threads are
    waited for: the kubelet's stop ends no pod, and a pod that outlives its
    test runs on in the process."""

    def __init__(self, name, capacity=None, serves=False):
        self.name = name
        self.P = P = PACKAGES[name]
        self.cs = P.FakeClientset()
        self.ctrl = (P.trainer.TPUServeController(self.cs) if serves else
                     P.trainer.TPUJobController(
                         self.cs, allocator=P.trainer.SliceAllocator(capacity)))
        self.kubelet = P.LocalKubelet(self.cs)
        self.stop = threading.Event()

    def __enter__(self):
        self.kubelet.run(self.stop)
        assert self.ctrl.run(workers=2, stop=self.stop, block=False)
        return self

    def __exit__(self, *exc):
        try:
            for kind in (self.cs.tpujobs, self.cs.tpuserves):
                objs, _ = kind().list()
                for obj in objs:
                    try:
                        kind().delete(obj.metadata.name)
                    except self.P.store.NotFound:
                        pass
            wait_for(lambda: not self.kubelet._claimed, timeout=60)
        finally:
            self.stop.set()
            self.ctrl.controller.shutdown()

    def status(self, name):
        try:
            return self.cs.tpujobs().get(name).status
        except self.P.store.NotFound:
            return None

    def has(self, name, cond):
        st = self.status(name)
        return st is not None and has(self.P, st, cond)

    def live_pods(self, name, replica_type=None):
        """The job's pods not being deleted, by name; with ``replica_type``
        only that type's."""
        pods, _ = self.cs.pods().list(label_selector=self.P.labels.job_selector(name))
        return sorted((p for p in pods if p.metadata.deletion_timestamp is None
                       and replica_type in (None, p.metadata.labels.get(
                           self.P.labels.REPLICA_TYPE))),
                      key=lambda p: p.metadata.name)

    def reasons(self, name=None):
        """Each event reason once, in first-seen order (how often a sync
        records one depends on reconcile timing in either package), but
        ``PodReplaced``: a sync whose pod cache still shows a pod of the
        gang that a restart just deleted re-renders it, in either package,
        or does not."""
        key = None if name is None else f"default/{name}"
        return list(dict.fromkeys(e.reason for e in self.ctrl.recorder.events(key=key)
                                  if e.reason != "PodReplaced"))

    def counter(self, name, labels=None):
        return self.ctrl.metrics.get_counter(name, labels)

    def record(self, name):
        """A job's status fields, as the flows hold them equal, with the
        conditions that hold (a false one's presence is history that a
        sync racing its own status write can rewrite, in either package)."""
        st = self.status(name)
        return {"world_version": st.world_version, "elastic_replicas": st.elastic_replicas,
                "gang_restarts": st.gang_restarts, "preemptions": st.preemptions,
                "conditions": sorted(c.type.value for c in st.conditions if c.status)}


def side_by_side(flow, capacity, port_only=()):
    """``flow(cluster)`` on both packages' ``Cluster``s at once, each over
    ``capacity[name]``; the two results held equal but for the keys
    ``port_only`` (records a known fault of the reference's can change),
    and the port's returned."""
    def go(name):
        def run():
            with Cluster(name, capacity=capacity[name]) as c:
                return flow(c)
        return run

    out = run_side_by_side({n: go(n) for n in PACKAGES}, timeout=150)
    held = {n: {k: v for k, v in rec.items() if k not in port_only} if port_only else rec
            for n, rec in out.items()}
    assert held["port"] == held["reference"], out
    return out["port"]


# the pod env of the rendering contract the elastic, preemption and
# suspend flows hold equal (trainer/replicas.py)
CONTRACT_ENV = ("TFK8S_WORLD_VERSION", "TFK8S_NUM_PROCESSES", "TFK8S_GANG_RESTARTS",
                "TFK8S_PROCESS_ID", "TFK8S_NUM_SLICES", "TFK8S_CLUSTER_SPEC")


def contract_env(pod):
    env = pod.spec.containers[0].env
    return {k: env.get(k) for k in CONTRACT_ENV}


_HELD = {}


def held(flow, name, *args):
    """``flow(PACKAGES[name], *args)``, one package's case of a flow that
    runs through both: the reference's record is kept, the port's held
    equal to it (the reference's flow is run here too when its case has
    not run first in this process). Returns the record."""
    key = f"{flow.__module__}.{flow.__qualname__}"
    record = flow(PACKAGES[name], *args)
    if name == "reference":
        _HELD[key] = record
    else:
        want = _HELD[key] if key in _HELD else flow(PACKAGES["reference"], *args)
        assert record == want, f"port {record!r}\nreference {want!r}"
    return record


def raised(P, fn, *args, **kwargs):
    """The class ``fn(*args, **kwargs)`` raised, as ``module.Class`` with
    the port's package name written as the reference's; None when it
    returned. The class must be ``P``'s own or a builtin."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the record is the class
        cls = type(e)
        assert cls.__module__ == "builtins" or cls.__module__.startswith(P.root + "."), (
            f"{cls.__module__}.{cls.__name__} is not {P.root}'s")
        return f"{cls.__module__.replace(ROOTS['port'], ROOTS['reference'])}.{cls.__name__}"
    return None
