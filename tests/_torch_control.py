"""Both packages' control-plane modules side by side, for the tests that run
one flow through the reference and through the port and hold the records
equal: ``PACKAGES[name]`` holds the api types, serde, the apiserver, the
remote client, the stores, the operator's ``Options``/``Server``, the
kubelet, the entry-point registry, ``cmd.main`` and ``LeaderElector``.
``masked`` blanks what differs between two runs of one flow: uids,
resource versions and times."""

import contextlib
import importlib
import io
import json
import re
import threading
import types

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
        trace=m("obs.trace"), progress=m("runtime.progress"))


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
