"""The port's kubectl-like verbs against the reference's, on the CPU.

Each flow of ``tests/test_cli_verbs.py``, of ``tests/test_events_api.py``'s
HTTP half (``describe`` and ``get --kind events`` over a running operator,
``scale`` and ``apply``) and of ``tests/test_pod_logs.py``'s verbs (``logs``,
``logs --job``, ``logs -f`` and the error exit codes) runs twice side by
side: the port's ``cmd.main.main`` against the port's ``APIServer``, and the
reference's ``main`` against the reference's. Every call's exit code and
standard output are held equal, uids, resource versions, times and ages
masked and the port's package name written as the reference's. One cross
case drives the port's verbs against the reference's apiserver.
"""

import difflib
import io
import json
import re
import sys
import threading

import pytest

from _torch_control import (PACKAGES, ThreadStdout, has, kubeconfig, make_job,
                            run_side_by_side)
from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

CLUSTERS = {}  # plane -> the clientset an entry point reads its job through


def _echo(name):
    def run(env, stop):
        """Return once the job shows Running, so that both packages record
        that condition."""
        P, job = PACKAGES[name], env["TFK8S_JOB_NAME"]
        wait_for(lambda: has(P, CLUSTERS[name].tpujobs().get(job).status, "Running"), timeout=10)
    return run


for _name, _P in PACKAGES.items():
    _P.registry.register("torch_cli.echo", _echo(_name))
    _P.registry.register("torch_cli.block", lambda env, stop: stop.wait(15))

_MASKS = [
    (re.compile(r'"(uid|resourceVersion|[A-Za-z]*(Timestamp|Time))": "[^"]*"'), r'"\1": "<m>"'),
    (re.compile(r"\(rv \d+\)"), "(rv <m>)"),
    (re.compile(r"(?<![\w.-])\d+[smh](?![\w.-])"), "<age>"),
]


_COUNTS = re.compile(r"( x|  )\d+(  |$)", re.M)


def norm(out):
    out = out.replace("tfk8s_tpu_torch", "tfk8s_tpu")
    for pattern, repl in _MASKS:
        out = pattern.sub(repl, out)
    return out


@pytest.fixture
def stdout():
    """A ``ThreadStdout``, put in place by ``side_by_side`` (the capture of
    pytest sets ``sys.stdout`` again between a fixture and its test)."""
    return ThreadStdout(sys.stdout)


class Cluster:
    """The verbs (``main``) of package ``name`` against an apiserver of
    package ``api`` (default: the same) over a fresh store, through a
    kubeconfig; with ``operator``, the apiserver's package's operator over
    it with its local kubelet."""

    def __init__(self, name, tmp_path, stdout, api=None, operator=False, server=None):
        self.name, self.stdout = name, stdout
        self.P = PACKAGES[api or name]
        self.main = PACKAGES[name].main.main
        self.tmp = tmp_path / name
        self.tmp.mkdir(parents=True)
        self.store = self.P.store.ClusterStore()
        self.own = server is None  # else a module's apiserver, given this fresh store
        if self.own:
            server = self.P.apiserver.APIServer(self.store, port=0)
            server.serve_background()
        self.server = server
        server.store = self.store
        self.kc = kubeconfig(self.tmp, self.server.url)
        self.remote = self.P.remote.RemoteStore(self.server.url)
        self.cs = CLUSTERS[name] = self.P.Clientset.new_for_config(self.remote)
        self.op = self.stop = None
        if operator:
            self.stop = threading.Event()
            self.op = self.P.Server(self.P.Options(kubeconfig=self.kc, capacity={"cpu-4": 2},
                                                   workers=2))
            self.op.run(self.stop, block=False)
        self.calls = []

    def close(self):
        if self.op is not None:
            self.stop.set()
            self.op.shutdown()
            for t in self.op._threads:
                t.join(5)
        if self.own:
            self.server.shutdown()
            self.server.server_close()

    def __call__(self, *argv, kc=True, counts=False):
        """Run one verb; keep and return (argv, rc, masked stdout). With
        ``counts``, an event's count (how often a reconcile recorded it,
        which depends on its timing in either package) is masked too."""
        argv = list(argv[:1]) + (["--kubeconfig", self.kc] if kc else []) + list(argv[1:])
        with self.stdout.bound(io.StringIO()) as buf:
            rc = self.main(argv)
        argv = [a.replace(str(self.tmp), "<tmp>") for a in (argv[:1] + argv[3:] if kc else argv)]
        out = norm(buf.getvalue())
        if counts:
            out = _COUNTS.sub(r"\1<n>\2", out)
        call = (argv, rc, out)
        self.calls.append(call)
        return call[1], call[2]

    def manifest(self, obj, name):
        path = self.tmp / f"{name}.json"
        path.write_text(json.dumps(self.P.serde.to_wire(obj)))
        return str(path)

    def job(self, name, entrypoint="torch_cli.echo", **kw):
        return make_job(self.P, name, entrypoint, gang=False, **kw)


@pytest.fixture(scope="module")
def apiservers():
    """One apiserver of each package for the module's flows that run no
    operator; each flow gives it a fresh store."""
    servers = {name: P.apiserver.APIServer(P.store.ClusterStore(), port=0)
               for name, P in PACKAGES.items()}
    for server in servers.values():
        server.serve_background()
    yield servers
    for server in servers.values():
        server.shutdown()
        server.server_close()


def side_by_side(tmp_path, stdout, flow, planes=None, **kw):
    """Run ``flow(cluster)`` for each plane at once; hold the calls equal;
    return the port's."""
    planes = planes or {"reference": {}, "port": {}}
    clusters = {}

    def run(name):
        def go():
            clusters[name] = Cluster(name, tmp_path, stdout, **planes[name], **kw)
            try:
                flow(clusters[name])
            finally:
                clusters[name].close()
            return clusters[name].calls
        return go

    prev, sys.stdout = sys.stdout, stdout
    try:
        out = run_side_by_side({name: run(name) for name in planes})
    finally:
        sys.stdout = prev
    names = list(planes)
    for a, b in zip(names, names[1:]):
        for call_a, call_b in zip(out[a], out[b]):
            assert call_b == call_a, "\n".join(difflib.unified_diff(
                call_a[2].splitlines(), call_b[2].splitlines(), f"{a} {call_a[:2]}",
                f"{b} {call_b[:2]}", lineterm=""))
        assert len(out[b]) == len(out[a])
    return out[names[-1]]


# -- tests/test_cli_verbs.py ------------------------------------------------------


def _roundtrip(c):
    manifest = c.manifest(c.job("cli-job"), "cli-job")
    rc, out = c("submit", "--file", manifest)
    assert rc == 0 and "cli-job created" in out
    rc, out = c("get")
    assert rc == 0 and "NAME" in out and "cli-job" in out and "Pending" in out
    rc, out = c("get", "cli-job", "-o", "json")
    assert rc == 0 and json.loads(out)[0]["metadata"]["name"] == "cli-job"
    rc, out = c("describe", "cli-job")
    assert rc == 0 and json.loads(out)["spec"]["replicaSpecs"]["Worker"]["replicas"] == 1
    rc, out = c("delete", "cli-job")
    assert rc == 0 and "deleted" in out
    assert c("get", "cli-job")[0] == 1  # no controller set a finalizer: gone
    assert c("delete", "cli-job")[0] == 1


def _pods_and_services(c):
    rc, out = c("get", "--kind", "pods")
    assert rc == 0 and "NAME" in out
    c.remote.create(c.P.t.Service(metadata=c.P.t.ObjectMeta(name="svc-0", namespace="default"),
                                  spec=c.P.t.ServiceSpec()))
    rc, out = c("get", "--kind", "services")
    assert rc == 0 and "svc-0" in out and "-" in out  # no status: rendered "-"


def _namespace_flag_wins(c):
    manifest = c.manifest(c.job("ns-job"), "ns-job")
    assert c("submit", "-n", "prod", "--file", manifest)[0] == 0
    rc, out = c("get", "-n", "prod", "ns-job")
    assert rc == 0 and "ns-job" in out


def _tpuserve_verbs(c):
    t = c.P.t
    serve = t.TPUServe(metadata=t.ObjectMeta(name="cli-serve", namespace="default"),
                       spec=t.TPUServeSpec(task="echo", checkpoint="v1", replicas=2))
    rc, out = c("submit", "--file", c.manifest(serve, "cli-serve"))
    assert rc == 0 and "tpuserve default/cli-serve created" in out
    rc, out = c("get", "--kind", "tpuserves")
    assert rc == 0 and "READY" in out and "cli-serve" in out and "0/2" in out
    rc, out = c("get", "--kind", "tpuserves", "cli-serve", "-o", "json")
    objs = json.loads(out)
    assert objs[0]["kind"] == "TPUServe" and objs[0]["spec"]["task"] == "echo"
    assert objs[0]["spec"]["template"]["entrypoint"].endswith("server:serve")
    rc, out = c("describe", "--kind", "tpuserves", "cli-serve")
    assert rc == 0 and json.loads(out.split("\nEvents:")[0])["spec"]["replicas"] == 2
    rc, out = c("delete", "--kind", "tpuserves", "cli-serve")
    assert rc == 0 and "tpuserve default/cli-serve deleted" in out
    assert c("get", "--kind", "tpuserves", "cli-serve")[0] == 1


def _label_selector(c):
    for name, team in (("red-job", "red"), ("blue-job", "blue")):
        c.remote.create(c.job(name, labels={"team": team}))
    rc, out = c("get", "-l", "team=red")
    assert rc == 0 and "red-job" in out and "blue-job" not in out


def _suspend_resume(c):
    assert c("submit", "--file", c.manifest(c.job("parkme"), "parkme"))[0] == 0
    rc, out = c("suspend", "parkme")
    assert rc == 0 and "suspended" in out
    assert c.remote.get("TPUJob", "default", "parkme").spec.run_policy.suspend
    assert "already suspended" in c("suspend", "parkme")[1]
    rc, out = c("resume", "parkme")
    assert rc == 0 and "resumed" in out
    assert not c.remote.get("TPUJob", "default", "parkme").spec.run_policy.suspend


def _user_errors(c):
    assert c("get", "--kubeconfig", str(c.tmp / "nope.json"), kc=False)[0] == 1
    for name, text in (("bad.json", json.dumps({"kind": "NoSuchKind", "metadata": {"name": "x"}})),
                       ("broken.yaml", "metadata: {name: x"), ("bare.yaml", "just a string")):
        (c.tmp / name).write_text(text)
        assert c("submit", "--file", str(c.tmp / name))[0] == 1


def _patch(c):
    assert c("submit", "--file", c.manifest(c.job("cli-job"), "cli-job"))[0] == 0
    P = lambda *a: c("patch", "cli-job", "-p", *a)[0]  # noqa: E731
    S = lambda body: c("patch", "cli-job", "--subresource", "status", "-p", body)[0]  # noqa: E731
    job = lambda: c.store.get("TPUJob", "default", "cli-job")  # noqa: E731
    assert P('{"spec": {"runPolicy": {"suspend": true}}}') == 0
    assert job().spec.run_policy.suspend is True
    assert P('{"spec": {"tpu": {"accelerator": "v5p-33"}}}') == 1  # admission's 422
    assert job().spec.tpu.accelerator == "cpu-1"
    assert P("{not json") == 1
    assert P('{"status": {"replicaStatuses": {}}}') == 1
    assert P('{"spec": {"runPolicy": {"suspend": false}}, "status": {}}') == 1
    assert S('{"replicaStatuses": {"Worker": {"active": 1}}}') == 1
    assert S('{"status": {}, "spec": {"runPolicy": {"suspend": false}}}') == 1
    rv = job().metadata.resource_version
    assert S(json.dumps({"apiVersion": "tpu.tfk8s.dev/v1alpha1", "kind": "TPUJob",
                         "metadata": {"resourceVersion": str(rv)},
                         "status": {"replicaStatuses": {"Worker": {"active": 2}}}})) == 0
    assert S('{"status": {}, "metadata": {"labels": {"team": "x"}}}') == 1
    assert S(json.dumps({"metadata": {"resourceVersion": str(rv)},  # now stale: 409
                         "status": {"replicaStatuses": {"Worker": {"active": 3}}}})) == 1
    assert S('{"status": {"replicaStatuses": {"Worker": {"active": 1}}}}') == 0
    assert job().status.replica_statuses[c.P.t.ReplicaType.WORKER].active == 1


FLOWS = [_roundtrip, _pods_and_services, _namespace_flag_wins, _tpuserve_verbs, _label_selector,
         _suspend_resume, _user_errors, _patch]


def shared(apiservers):
    return {name: {"server": server} for name, server in apiservers.items()}


@pytest.mark.parametrize("flow", FLOWS, ids=lambda f: f.__name__[1:])
def test_the_verbs_match_the_reference(flow, tmp_path, stdout, apiservers):
    side_by_side(tmp_path, stdout, flow, shared(apiservers))


def test_get_watch_streams_changes(tmp_path, stdout, apiservers):
    def flow(c):
        rc, watched = {}, io.StringIO()

        def watch():
            with c.stdout.bound(watched):
                rc["v"] = c.main(["get", "--kubeconfig", c.kc, "-w", "--watch-timeout", "2"])

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        # the watch replays from the list's resource version: once the table
        # is out, every later change reaches the stream
        assert wait_for(lambda: "NAME" in watched.getvalue(), timeout=10)
        assert c("submit", "--file", c.manifest(c.job("watched"), "watched"))[0] == 0
        job = c.remote.get("TPUJob", "default", "watched")
        job.status.gang_restarts = 1
        c.remote.update_status(job)
        c.remote.delete("TPUJob", "default", "watched")
        t.join(10)
        assert not t.is_alive() and rc["v"] == 0
        out = norm(watched.getvalue())
        for line in ("ADDED     watched", "MODIFIED  watched", "DELETED   watched"):
            assert line in out, out
        c.calls.append((["get", "-w"], rc["v"], out))

    side_by_side(tmp_path, stdout, flow, shared(apiservers))


def test_the_port_verbs_drive_the_reference_apiserver(tmp_path, stdout):
    """The cross case: the port's verbs against the reference's apiserver
    print what the reference's verbs print."""
    for flow in (_roundtrip, _patch):
        side_by_side(tmp_path / flow.__name__, stdout, flow,
                     planes={"reference": {}, "port": {"api": "reference"}})


# -- tests/test_events_api.py -------------------------------------------------------


def test_describe_and_get_events_over_http(tmp_path, stdout):
    def flow(c):
        assert c("submit", "--file", c.manifest(c.job("cli-ev"), "cli-ev"))[0] == 0
        assert wait_for(lambda: has(c.P, c.cs.tpujobs().get("cli-ev").status, "Succeeded"),
                        timeout=30)
        events = lambda: c.cs.generic("Event", "default").list()[0]  # noqa: E731
        assert wait_for(lambda: "JobSucceeded" in {e.reason for e in events()}, timeout=10)
        rc, out = c("describe", "cli-ev", counts=True)
        assert rc == 0 and "Events:" in out and "JobSucceeded" in out
        rc, out = c("get", "--kind", "events", counts=True)
        assert rc == 0 and "REASON" in out and "TPUJob/default/cli-ev" in out

    side_by_side(tmp_path, stdout, flow, operator=True)


def test_scale_and_apply_verbs(tmp_path, stdout):
    def flow(c):
        job = c.job("sa", entrypoint="torch_cli.block")
        path = c.manifest(job, "sa")
        rc, out = c("apply", "--file", path)
        assert rc == 0 and "created" in out
        assert wait_for(lambda: has(c.P, c.cs.tpujobs().get("sa").status, "Running"),
                        timeout=30)
        job.spec.replica_specs[c.P.t.ReplicaType.WORKER].template.env = {"X": "1"}
        c.manifest(job, "sa")
        rc, out = c("apply", "--file", path)
        assert rc == 0 and "configured" in out
        assert "unchanged" in c("apply", "--file", path)[1]
        rc, out = c("scale", "sa", "--replicas", "3")
        assert rc == 0 and "scaled" in out

        def live():
            pods, _ = c.cs.pods().list(label_selector=c.P.labels.job_selector("sa"))
            return len([p for p in pods if p.metadata.deletion_timestamp is None])

        assert wait_for(lambda: live() == 3, timeout=30)
        assert c("scale", "sa", "--replicas", "1", "--replica-type", "Banana")[0] == 1
        assert c("scale", "sa", "--replicas", "1", "--replica-type", "Chief")[0] == 1
        assert c("delete", "sa")[0] == 0
        # the finalizer deletes the pods, which ends their entry points: none
        # is left running into the next test
        assert wait_for(lambda: live() == 0, timeout=30)

    side_by_side(tmp_path, stdout, flow, operator=True)


# -- tests/test_pod_logs.py --------------------------------------------------------


def _pod(c, name, **kw):
    t = c.P.t
    return t.Pod(metadata=t.ObjectMeta(name=name, labels=kw.pop("labels", {})),
                 spec=t.PodSpec(containers=[t.ContainerSpec(entrypoint="x:y")]),
                 status=t.PodStatus(**kw))


def test_logs_cli_verb(tmp_path, stdout, apiservers):
    def flow(c):
        for i in range(2):
            labels = c.P.labels.replica_labels("lj", c.P.t.ReplicaType.WORKER, i)
            c.cs.pods().create(_pod(c, f"lj-worker-{i}", labels=labels,
                                    log_tail=[f"hello from {i}"]))
        rc, out = c("logs", "lj-worker-0")
        assert rc == 0 and "hello from 0" in out and "hello from 1" not in out
        rc, out = c("logs", "--job", "lj")
        assert rc == 0 and "hello from 1" in out and "==> default/lj-worker-1 (Pending) <==" in out
        assert c("logs")[0] == 1  # exactly one of POD / --job
        assert c("logs", "p", "--job", "j")[0] == 1
        assert c("logs", "nope")[0] == 1
        assert c("logs", "--job", "nope")[0] == 1
        assert c("logs", "lj-worker-0", "--job", "lj", "-f")[0] == 1

    side_by_side(tmp_path, stdout, flow, shared(apiservers))


def test_logs_follow_streams_new_lines(tmp_path, stdout, apiservers):
    def flow(c):
        Phase = c.P.t.PodPhase
        c.cs.pods().create(_pod(c, "fpod", phase=Phase.RUNNING, log_tail=["line-1"]))
        rc, followed = {}, io.StringIO()

        def follow():
            with c.stdout.bound(followed):
                rc["v"] = c.main(["logs", "--kubeconfig", c.kc, "fpod", "-f",
                                  "--follow-timeout", "15"])

        t = threading.Thread(target=follow, daemon=True)
        t.start()
        for tail, phase in ((["line-1", "line-2"], Phase.RUNNING),
                            (["line-1", "line-2", "line-3"], Phase.SUCCEEDED)):
            assert wait_for(lambda: tail[-2] in followed.getvalue(), timeout=10)
            p = c.cs.pods().get("fpod")
            p.status.log_tail, p.status.phase = tail, phase
            c.cs.pods().update_status(p)
        t.join(10)
        assert not t.is_alive() and rc["v"] == 0
        out = followed.getvalue()
        assert out.count("line-1") == 1 and "line-2" in out and "line-3" in out
        c.calls.append((["logs", "-f"], rc["v"], out))

    side_by_side(tmp_path, stdout, flow, shared(apiservers))
