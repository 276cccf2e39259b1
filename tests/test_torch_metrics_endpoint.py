"""The port's observability endpoint (``Server.start_metrics_server``)
against the reference's, on the CPU.

Each flow of ``tests/test_observability.py``'s endpoint tests (a job's
metrics, ``/healthz`` and ``/events``; training progress reaching
``/metrics``; the ``/events`` query filters; a deleted job's series removed)
and of ``tests/test_tracing.py``'s end-to-end trace (``/traces``, one trace
from the reconcile to the trainer's first step) runs on the port's
``Server`` and on the reference's, side by side. Held equal: each path's
status code and content type, the ``/metrics`` series names and label sets
(values masked where they are timings), the ``/events`` records (times
masked), the ``/traces`` span names, and ``/debug/*`` and an unknown path.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

from _torch_control import PACKAGES, has, make_job, run_side_by_side
from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)


def _echo(env):
    pass


def _progress(name):
    def run(env, stop=None):
        """Report progress as ``Trainer.fit`` does, long enough for the
        kubelet's flush (1 s cadence) to publish it."""
        for step in range(1, 4):
            PACKAGES[name].progress.report(step=step, steps_per_sec=2.0, examples_per_sec=64.0,
                                           step_seconds=0.5)
            time.sleep(0.6)
    return run


def _train(name):
    def run(env, stop):
        """A tiny MLP through ``run_task``, so the trainer's spans come from
        the production path."""
        import importlib

        root = PACKAGES[name].root
        mlp = importlib.import_module(f"{root}.models.mlp")
        run_task = importlib.import_module(f"{root}.runtime.train").run_task
        task = mlp.make_task(batch_size=8, hidden=16)
        task.targets = {}  # 3 steps; convergence is not the point here
        run_task(task, env, stop)
    return run


for _name, _P in PACKAGES.items():
    _P.registry.register("torch_mtest.echo", _echo)
    _P.registry.register("torch_mtest.progress", _progress(_name))
    _P.registry.register("torch_mtest.train", _train(_name))

_SERIES = re.compile(r"^([a-zA-Z_:][\w:]*)(\{.*\})? (\S+)$")
# series whose value is a duration or a rate the run measured, or counts
# work that depends on timing (reconciles, requeues, watch events)
_TIMED = re.compile(r"seconds|_per_sec|syncs|requeue|depth|adds|_total|retries|step$")
# series that exist only once such timing-dependent work happened at all
_TIMING_ONLY = re.compile(r"requeue|relist|coalesced|deltas|retries|conflict|dropped")


def fetch(port, path):
    """(status, content type, body) of a GET on the endpoint."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), ""


def series(text):
    """{(name, labels): value} of a Prometheus exposition; a value that is a
    timing or a count of timing-dependent work reads ``<v>``."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, labels, value = _SERIES.match(line).groups()
        out[(name, labels or "")] = "<v>" if _TIMED.search(name) else value
    return out


def types(text):
    """The ``# TYPE`` lines, but of the series that only timing brings about."""
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE") and not _TIMING_ONLY.search(line))


def events(body, unique=False):
    """The records of an ``/events`` reply, times dropped; with ``unique``,
    each record once, in first-seen order (how often a reconcile records one
    depends on its timing in either package)."""
    recs = [json.dumps({k: v for k, v in e.items() if k != "ts"}) for e in json.loads(body)]
    return [json.loads(r) for r in (dict.fromkeys(recs) if unique else recs)]


class Endpoint:
    """One package's in-process ``Server`` with its endpoint on a free
    port; with ``run``, its controllers and local kubelet started."""

    def __init__(self, name, run=True):
        self.P = P = PACKAGES[name]
        self.server = P.Server(P.Options(workers=1))
        self.port = self.server.start_metrics_server(0)
        self.stop = threading.Event()
        if run:
            self.server.run(self.stop, block=False)
        self.cs = self.server.clientset

    def close(self):
        self.stop.set()
        self.server.shutdown()
        self.server._http.server_close()
        for t in self.server._threads:
            t.join(5)

    def get(self, path):
        return fetch(self.port, path)

    def submit(self, name, entrypoint, env=None, wait="Succeeded"):
        self.cs.tpujobs("default").create(make_job(self.P, name, entrypoint, gang=False,
                                                   env=env))
        if wait:
            assert wait_for(lambda: has(self.P, self.cs.tpujobs().get(name).status, wait),
                            timeout=60), name


def side_by_side(flow, run=True):
    """``flow(endpoint)`` on both packages' servers at once; their results
    held equal; the port's returned."""
    def go(name):
        def run_flow():
            ep = Endpoint(name, run)
            try:
                return flow(ep)
            finally:
                ep.close()
        return run_flow

    out = run_side_by_side({name: go(name) for name in PACKAGES})
    assert out["port"] == out["reference"]
    return out["port"]


def test_the_endpoint_serves_a_jobs_metrics_health_and_events():
    def flow(ep):
        ep.submit("obsjob", "torch_mtest.echo")
        got = {p: ep.get(p) for p in ("/metrics", "/healthz", "/events", "/nope",
                                      "/debug/requests", "/debug/decode")}
        status = {p: (code, ctype) for p, (code, ctype, _body) in got.items()}
        text = got["/metrics"][2]
        return (status, got["/healthz"][2], events(got["/events"][2], unique=True), types(text),
                sorted({n for n, _labels in series(text) if not _TIMING_ONLY.search(n)}))

    status, health, evs, kinds, names = side_by_side(flow)
    assert status["/metrics"] == (200, "text/plain; version=0.0.4")
    assert status["/nope"][0] == 404 and health == "ok"
    assert "tpujob_syncs_total" in names and "tpujob_sync_seconds_bucket" in names
    assert any(e["reason"] == "JobSucceeded" for e in evs)


def test_training_progress_reaches_the_operators_metrics():
    def flow(ep):
        ep.submit("progjob", "torch_mtest.progress")
        pods, _ = ep.cs.pods("default").list()
        text = ep.get("/metrics")[2]
        job = {k: v for k, v in series(text).items() if 'job="progjob"' in k[1]}
        return pods[0].status.training, job

    training, job = side_by_side(flow)
    assert training["examples_per_sec"] == 64.0
    lbl = '{job="progjob",namespace="default"}'
    assert job[("tpujob_training_examples_per_sec", lbl)] == "<v>"
    assert ("tpujob_training_step", lbl) in job


def test_the_events_endpoint_honours_key_and_reason():
    def flow(ep):
        for key, reason, msg in (("default/a", "JobCreated", "m1"),
                                 ("default/a", "JobSucceeded", "m2"),
                                 ("default/b", "JobCreated", "m3")):
            ep.server.recorder.event("TPUJob", key, reason, msg)
        return {qs: (ep.get(f"/events{qs}")[:2], events(ep.get(f"/events{qs}")[2]))
                for qs in ("", "?key=default/a", "?reason=JobCreated",
                           "?key=default/b&reason=JobCreated", "?key=default/b&reason=JobSucceeded")}

    out = side_by_side(flow, run=False)
    assert [len(evs) for _status, evs in out.values()] == [3, 2, 2, 1, 0]
    assert out["?key=default/b&reason=JobCreated"][1][0]["message"] == "m3"


def test_deleting_a_job_removes_exactly_its_series():
    def flow(ep):
        for name in ("gcjob-a", "gcjob-b"):
            ep.submit(name, "torch_mtest.progress", wait=None)
        key = lambda n: f'job="{n}"'  # noqa: E731
        text = lambda: ep.get("/metrics")[2]  # noqa: E731
        assert wait_for(lambda: all(f"tpujob_training_steps_per_sec{{{key(n)},namespace"
                                    in text() for n in ("gcjob-a", "gcjob-b")), timeout=30)
        before = {k for k in series(text()) if "gcjob" in k[1]}
        ep.cs.tpujobs("default").delete("gcjob-a")
        assert wait_for(lambda: key("gcjob-a") not in text(), timeout=20)
        after = {k for k in series(text()) if "gcjob" in k[1]}
        return sorted(before), sorted(after)

    before, after = side_by_side(flow)
    assert after and all('job="gcjob-b"' in labels for _n, labels in after)
    assert set(after) == {k for k in before if 'job="gcjob-b"' in k[1]}


def test_one_trace_from_the_reconcile_to_the_first_step():
    def flow(name):
        def run():
            P = PACKAGES[name]
            prev = P.trace.set_tracer(P.trace.Tracer(capacity=16384))  # before the Server
            ep = Endpoint(name)
            try:
                ep.submit("ep-tracejob", "torch_mtest.train", env={
                    "TFK8S_TRAIN_STEPS": "3", "TFK8S_LOG_EVERY": "1", "TFK8S_DEVICE": "cpu"})
                code, ctype, body = ep.get("/traces")
                # this job's traces: a pod of another test still running in this
                # process would record into the same process-wide tracer
                mine = {"name": "kubelet.launch", "pod": "default/ep-tracejob-worker-0"}
                traces = [t for t in json.loads(body)
                          if any(s["name"] == "trainer.first_step" for s in t["spans"])
                          and any({"name": s["name"], "pod": s["attributes"].get("pod")} == mine
                                  for s in t["spans"])]
                assert len(traces) == 1, [t["trace_id"] for t in traces]
                spans = traces[0]["spans"]
                by_id = {s["span_id"]: s for s in spans}
                cur = next(s for s in spans if s["name"] == "trainer.first_step")
                chain = [cur["name"]]
                while cur["parent_id"] is not None:
                    cur = by_id[cur["parent_id"]]
                    chain.append(cur["name"])
                tid = traces[0]["trace_id"]
                only = json.loads(ep.get(f"/traces?trace_id={tid}")[2])
                assert [t["trace_id"] for t in only] == [tid]
                return (code, ctype), chain, sorted({s["name"] for s in spans})
            finally:
                ep.close()
                P.trace.set_tracer(prev)
        return run

    out = run_side_by_side({name: flow(name) for name in PACKAGES})
    ref, port = out["reference"], out["port"]
    assert port[:2] == ref[:2]
    status, chain, _names = port
    assert status == (200, "application/json")
    assert chain[0] == "trainer.first_step" and chain[-1] == "reconcile"
    assert {"pod.create", "kubelet.launch", "trainer.run"} <= set(chain)
    # the port's trainer has no compile split: its first step is its first
    # call of the step function, which torch does not compile
    assert port[2] == [n for n in ref[2] if n != "trainer.first_compile"]
