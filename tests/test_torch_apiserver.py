"""The port's HTTP apiserver and remote client against the reference's, on
the CPU.

Each flow of ``tests/test_apiserver.py`` (but the cross-process one, which
``tests/test_torch_operator_remote.py`` holds) and of the HTTP classes of
``tests/test_wire_conformance.py`` sends the same raw requests, in the same
order, to a reference ``APIServer`` and a port ``APIServer``, each over a
fresh store: the replies must be equal in status, ``reason`` and JSON body,
uids and timestamps masked (the resource_versions match, since both stores
count the same writes). Then the wire compatibility:

- each package's ``RemoteStore`` drives CRUD and a watch against either
  package's ``APIServer``;
- the goldens of ``tests/golden/`` come back byte for byte from the port's
  apiserver;
- the deliberate differences: the port's admission takes an ``h100-N``
  TPUJob, which the reference refuses with 422, refuses a TPU slice, which
  the reference takes, and gives an unpinned TPUServe the port's own model
  server.

The wire-form flows post ``full_job()`` of ``tests/test_wire_conformance.py``,
a ``v5p-32`` job, and the goldens hold a ``v5p-32`` job and its pod: those
run with admission off on both servers (``APIServer(admission=False)``), as
the port admits no TPU slice.
"""

import json
import os
import time
import types
import urllib.error
import urllib.request

import pytest
import yaml

from tfk8s_tpu import API_VERSION as R_API_VERSION
from tfk8s_tpu.api import serde as rserde
from tfk8s_tpu.api import types as rtypes
from tfk8s_tpu.client import apiserver as rapiserver
from tfk8s_tpu.client import remote as rremote
from tfk8s_tpu.client import store as rstore
from tfk8s_tpu_torch import API_VERSION
from tfk8s_tpu_torch.api import defaults as tdefaults
from tfk8s_tpu_torch.api import serde as tserde
from tfk8s_tpu_torch.api import types as ttypes
from tfk8s_tpu_torch.client import apiserver as tapiserver
from tfk8s_tpu_torch.client import remote as tremote
from tfk8s_tpu_torch.client import store as tstore

from test_wire_conformance import full_job
import _torch_threads  # noqa: F401  (torch's threads under xdist)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PACKAGES = {
    "reference": types.SimpleNamespace(t=rtypes, serde=rserde, api=rapiserver,
                                       remote=rremote, s=rstore),
    "port": types.SimpleNamespace(t=ttypes, serde=tserde, api=tapiserver,
                                  remote=tremote, s=tstore),
}
JOBS = f"/apis/{API_VERSION}/namespaces/default/tpujobs"
ML_JOBS = f"/apis/{API_VERSION}/namespaces/ml/tpujobs"


def make_job(P, name, accelerator="cpu-1", **env):
    t = P.t
    return t.TPUJob(
        metadata=t.ObjectMeta(name=name, namespace="default"),
        spec=t.TPUJobSpec(
            replica_specs={t.ReplicaType.WORKER: t.ReplicaSpec(
                replicas=1, template=t.ContainerSpec(entrypoint="test.echo", env=dict(env)))},
            tpu=t.TPUSpec(accelerator=accelerator),
            run_policy=t.RunPolicy(scheduling=t.SchedulingPolicy(gang=True)),
        ),
    )


def job_wire(name, **kw):
    body = tserde.to_wire(make_job(PACKAGES["port"], name, **kw))
    body["metadata"].pop("resourceVersion", None)
    return body


def _request(url, method, body=None, ctype="application/json"):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def masked(value):
    """uids and times differ between two runs of one flow; every other
    field must not."""
    if isinstance(value, dict):
        return {k: ("<masked>" if v is not None and (k == "uid" or k.endswith(("Timestamp", "Time")))
                    else masked(v)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [masked(v) for v in value]
    return value


class Pair:
    """A reference and a port apiserver, each over its own store;
    ``reset`` gives both fresh stores."""

    def __init__(self, admission=True, **store_kw):
        self.servers = {name: P.api.APIServer(P.s.ClusterStore(**store_kw), port=0,
                                              admission=admission)
                        for name, P in PACKAGES.items()}
        for server in self.servers.values():
            server.serve_background()

    def reset(self, **store_kw):
        for name, server in self.servers.items():
            server.store = PACKAGES[name].s.ClusterStore(**store_kw)
        return self

    def both(self, method, path, body=None, ctype="application/json"):
        """Send one request to both; assert equal replies; return the
        port's (status, body)."""
        replies = {n: _request(s.url + path, method, body, ctype) for n, s in self.servers.items()}
        assert masked(replies["port"]) == masked(replies["reference"]), (method, path)
        return replies["port"]

    def close(self):
        for server in self.servers.values():
            server.shutdown()
            server.server_close()


@pytest.fixture(scope="module")
def servers():
    pairs = {"admitted": Pair(), "unadmitted": Pair(admission=False)}
    yield pairs
    for p in pairs.values():
        p.close()


@pytest.fixture
def pair(servers):
    return servers["admitted"].reset()


@pytest.fixture
def unadmitted(servers):
    return servers["unadmitted"].reset()


# -- admission ---------------------------------------------------------------------


def test_invalid_create_rejected_422(pair):
    code, err = pair.both("POST", JOBS, job_wire("bad-acc", accelerator="cpu-0"))
    assert (code, err["reason"], err["kind"], err["code"]) == (422, "Invalid", "Status", 422)
    assert pair.both("GET", f"{JOBS}/bad-acc")[0] == 404


def test_invalid_update_rejected_422(pair):
    code, created = pair.both("POST", JOBS, job_wire("mutate-me"))
    assert code == 201
    created["spec"]["tpu"]["accelerator"] = "warp-drive"
    code, err = pair.both("PUT", f"{JOBS}/mutate-me", created)
    assert (code, err["reason"]) == (422, "Invalid")
    assert pair.both("GET", f"{JOBS}/mutate-me")[1]["spec"]["tpu"]["accelerator"] == "cpu-1"


def test_defaults_applied_at_admission(pair):
    code, created = pair.both("POST", JOBS, job_wire("defaulted"))
    assert code == 201
    assert created["spec"]["mesh"]["axes"]


def test_non_tpujob_kinds_skip_admission(pair):
    pod = tserde.to_wire(ttypes.Pod(
        metadata=ttypes.ObjectMeta(name="raw-pod", namespace="default"),
        spec=ttypes.PodSpec(containers=[ttypes.ContainerSpec(entrypoint="x:y")])))
    code, created = pair.both("POST", f"/apis/{API_VERSION}/namespaces/default/pods", pod)
    assert code == 201 and created["metadata"]["uid"]


# -- CRUD over the raw wire --------------------------------------------------------


def test_create_get_roundtrip(pair):
    code, created = pair.both("POST", JOBS, job_wire("alpha"))
    assert code == 201 and int(created["metadata"]["resourceVersion"]) > 0
    assert pair.both("GET", f"{JOBS}/alpha") == (200, created)


def test_create_duplicate_conflicts(pair):
    pair.both("POST", JOBS, job_wire("dup"))
    code, err = pair.both("POST", JOBS, job_wire("dup"))
    assert (code, err["reason"]) == (409, "AlreadyExists")


def test_get_missing_is_404(pair):
    code, err = pair.both("GET", f"{JOBS}/ghost")
    assert (code, err["reason"], err["status"]) == (404, "NotFound", "Failure")
    assert pair.both("GET", f"/apis/{API_VERSION}/namespaces/default/widgets")[0] == 404


def test_list_with_label_selector(pair):
    for name, team in (("l1", "x"), ("l2", "y")):
        body = job_wire(name)
        body["metadata"]["labels"] = {"team": team}
        pair.both("POST", JOBS, body)
    code, lst = pair.both("GET", f"{JOBS}?labelSelector=team%3Dx")
    assert code == 200
    assert [o["metadata"]["name"] for o in lst["items"]] == ["l1"]
    assert int(lst["metadata"]["resourceVersion"]) >= 2
    assert len(pair.both("GET", f"/apis/{API_VERSION}/tpujobs")[1]["items"]) == 2


def test_update_stale_rv_conflicts(pair):
    _, created = pair.both("POST", JOBS, job_wire("stale"))
    fresh = json.loads(json.dumps(created))
    fresh["status"]["gangRestarts"] = 1
    assert pair.both("PUT", f"{JOBS}/stale", fresh)[0] == 200
    created["status"]["gangRestarts"] = 9  # stale resourceVersion
    code, err = pair.both("PUT", f"{JOBS}/stale", created)
    assert (code, err["reason"]) == (409, "Conflict")


def test_update_status_path(pair):
    _, created = pair.both("POST", JOBS, job_wire("st"))
    created["status"]["gangRestarts"] = 3
    code, updated = pair.both("PUT", f"{JOBS}/st/status", created)
    assert code == 200 and updated["status"]["gangRestarts"] == 3
    assert pair.both("GET", f"{JOBS}/st")[1]["status"]["gangRestarts"] == 3


def test_status_subresource_isolation(pair):
    _, created = pair.both("POST", JOBS, job_wire("iso"))
    created["status"]["gangRestarts"] = 5
    created["spec"]["replicaSpecs"]["Worker"]["replicas"] = 99
    pair.both("PUT", f"{JOBS}/iso/status", created)
    cur = pair.both("GET", f"{JOBS}/iso")[1]
    assert cur["status"]["gangRestarts"] == 5
    assert cur["spec"]["replicaSpecs"]["Worker"]["replicas"] == 1


def test_put_url_body_mismatch_rejected(pair):
    _, created = pair.both("POST", JOBS, job_wire("real"))
    created["metadata"]["name"] = "imposter"
    code, err = pair.both("PUT", f"{JOBS}/real", created)
    assert (code, err["reason"]) == (400, "BadRequest")


def test_finalizer_gated_delete(pair):
    body = job_wire("fin")
    body["metadata"]["finalizers"] = ["tpu.tfk8s.dev/teardown"]
    pair.both("POST", JOBS, body)
    code, deleted = pair.both("DELETE", f"{JOBS}/fin")
    assert code == 200 and deleted["metadata"]["deletionTimestamp"]
    cur = pair.both("GET", f"{JOBS}/fin")[1]
    cur["metadata"]["finalizers"] = []
    pair.both("PUT", f"{JOBS}/fin", cur)
    assert pair.both("GET", f"{JOBS}/fin")[0] == 404


def test_merge_patch_and_its_refusals(pair):
    pair.both("POST", JOBS, job_wire("patched"))
    code, got = pair.both("PATCH", f"{JOBS}/patched",
                          {"spec": {"runPolicy": {"suspend": True}}},
                          ctype="application/merge-patch+json")
    assert code == 200 and got["spec"]["runPolicy"]["suspend"] is True
    assert pair.both("PATCH", f"{JOBS}/patched", {"spec": {}}, ctype="text/plain")[0] == 415
    assert pair.both("PATCH", f"{JOBS}/patched", [1], ctype="application/merge-patch+json")[0] == 400
    code, err = pair.both("PATCH", f"{JOBS}/patched",
                          {"spec": {"tpu": {"accelerator": "cpu-0"}}},
                          ctype="application/merge-patch+json")
    assert (code, err["reason"]) == (422, "Invalid")


def test_rest_path_shape_and_discovery(pair):
    for P in PACKAGES.values():
        store = P.remote.RemoteStore("http://127.0.0.1:1")
        assert store._path("TPUJob", "default", "j") == f"{JOBS}/j"
        assert store._path("Pod", None) == f"/apis/{API_VERSION}/pods"
    code, groups = pair.both("GET", "/apis")
    assert code == 200 and groups["kind"] == "APIGroupList"
    assert groups["groups"][0]["preferredVersion"]["groupVersion"] == API_VERSION
    code, res = pair.both("GET", f"/apis/{API_VERSION}")
    by_name = {r["name"]: r for r in res["resources"]}
    assert res["kind"] == "APIResourceList" and res["groupVersion"] == API_VERSION
    assert by_name["tpujobs"]["kind"] == "TPUJob" and "watch" in by_name["tpujobs"]["verbs"]
    assert "tpujobs/status" in by_name
    assert pair.both("GET", "/healthz") == (200, {"status": "ok"})
    assert tapiserver.PLURALS == rapiserver.PLURALS
    assert API_VERSION == R_API_VERSION


# -- watches -----------------------------------------------------------------------


def _events(resp, n):
    out = []
    while len(out) < n:
        ev = json.loads(resp.readline())
        if ev.get("type") != "HEARTBEAT":
            out.append(ev)
    return out


def test_watch_replay_then_live(pair):
    pair.both("POST", JOBS, job_wire("w1"))
    pair.both("POST", JOBS, job_wire("w2"))
    streams = {n: urllib.request.urlopen(
        f"{s.url}/apis/{API_VERSION}/tpujobs?watch=1&resourceVersion=0", timeout=10)
        for n, s in pair.servers.items()}
    try:
        assert streams["port"].headers["Content-Type"] == "application/json; stream=watch"
        replay = {n: _events(r, 2) for n, r in streams.items()}
        assert masked(replay["port"]) == masked(replay["reference"])
        assert [e["type"] for e in replay["port"]] == ["ADDED", "ADDED"]
        assert [e["object"]["metadata"]["name"] for e in replay["port"]] == ["w1", "w2"]
        pair.both("POST", JOBS, job_wire("w3"))
        live = {n: _events(r, 1) for n, r in streams.items()}
        assert masked(live["port"]) == masked(live["reference"])
        assert live["port"][0]["object"]["metadata"]["name"] == "w3"
    finally:
        for r in streams.values():
            r.close()


def test_watch_gone_on_evicted_history(servers):
    pair = servers["admitted"].reset(history_limit=2)
    for i in range(6):
        pair.both("POST", JOBS, job_wire(f"g{i}"))
    code, err = pair.both("GET", f"/apis/{API_VERSION}/tpujobs?watch=1&resourceVersion=1")
    assert (code, err["reason"]) == (410, "Gone")


def test_watch_stop_tears_down(pair):
    server = pair.servers["port"]
    store = tremote.RemoteStore(server.url)
    w = store.watch("TPUJob")
    assert server.store._watchers
    store.stop_watch(w)
    # the server notices at a heartbeat write to the closed socket
    deadline = time.time() + 10
    while time.time() < deadline and server.store._watchers:
        time.sleep(0.1)
    assert not server.store._watchers


# -- the k8s wire form (tests/test_wire_conformance.py's HTTP classes) -------------


def _full_job_wire(finalizers=True):
    body = rserde.to_wire(full_job())
    if not finalizers:
        body["metadata"]["finalizers"] = []
    return body


def test_create_get_list_delete_k8s_casing(unadmitted):
    pair = unadmitted
    body = _full_job_wire()
    del body["metadata"]["resourceVersion"]
    code, created = pair.both("POST", ML_JOBS, body)
    assert code == 201 and created["apiVersion"] == API_VERSION
    assert isinstance(created["metadata"]["resourceVersion"], str)
    assert created["spec"]["replicaSpecs"]["Worker"]["replicas"] == 4
    assert created["spec"]["runPolicy"]["backoffLimit"] == 3
    assert pair.both("GET", f"{ML_JOBS}/bert-mlm")[1]["spec"]["tpu"]["numSlices"] == 1
    code, lst = pair.both("GET", ML_JOBS)
    assert (lst["kind"], lst["apiVersion"], len(lst["items"])) == ("TPUJobList", API_VERSION, 1)
    assert pair.both("DELETE", f"{ML_JOBS}/bert-mlm")[0] == 200


def test_status_put_k8s_casing(unadmitted):
    pair = unadmitted
    code, created = pair.both("POST", ML_JOBS, _full_job_wire())
    assert code == 201
    created["status"]["gangRestarts"] = 7
    created["spec"]["runPolicy"]["backoffLimit"] = 99
    code, updated = pair.both("PUT", f"{ML_JOBS}/bert-mlm/status", created)
    assert code == 200 and updated["status"]["gangRestarts"] == 7
    got = pair.both("GET", f"{ML_JOBS}/bert-mlm")[1]
    assert got["status"]["gangRestarts"] == 7
    assert got["spec"]["runPolicy"]["backoffLimit"] == 3


def test_watch_deleted_event_wire_shape(unadmitted):
    pair = unadmitted
    pair.both("POST", ML_JOBS, _full_job_wire(finalizers=False))
    assert pair.both("DELETE", f"{ML_JOBS}/bert-mlm")[0] == 200
    streams = {n: urllib.request.urlopen(
        f"{s.url}/apis/{API_VERSION}/tpujobs?watch=1&resourceVersion=0", timeout=10)
        for n, s in pair.servers.items()}
    try:
        seen = {n: _events(r, 2) for n, r in streams.items()}
    finally:
        for r in streams.values():
            r.close()
    assert masked(seen["port"]) == masked(seen["reference"])
    assert [e["type"] for e in seen["port"]] == ["ADDED", "DELETED"]
    assert seen["port"][1]["object"]["kind"] == "TPUJob"


CORE = {
    "pods": ttypes.Pod(
        metadata=ttypes.ObjectMeta(name="w-0", namespace="ml"),
        spec=ttypes.PodSpec(containers=[ttypes.ContainerSpec(entrypoint="m:train")],
                            node_selector={"tfk8s.dev/host": "h0"}),
        status=ttypes.PodStatus(phase=ttypes.PodPhase.RUNNING, host="node-a",
                                log_tail=["line1"], training={"steps_per_sec": 2.5})),
    "leases": ttypes.Lease(
        metadata=ttypes.ObjectMeta(name="node-a", namespace="ml"),
        spec=ttypes.LeaseSpec(holder="op-1", lease_duration_s=15.0,
                              acquire_time=1700000000.5, renew_time=1700000009.25)),
    "events": ttypes.Event(
        metadata=ttypes.ObjectMeta(name="tpujob.j1.jobcreated", namespace="ml"),
        involved_kind="TPUJob", involved_key="ml/j1", reason="JobCreated", count=3,
        first_timestamp=1700000000.0, last_timestamp=1700000100.0),
}


@pytest.mark.parametrize("plural", sorted(CORE))
def test_core_kinds_over_the_wire(pair, plural):
    path = f"/apis/{API_VERSION}/namespaces/ml/{plural}"
    code, created = pair.both("POST", path, tserde.to_wire(CORE[plural]))
    assert code == 201
    name = CORE[plural].metadata.name
    code, got = pair.both("GET", f"{path}/{name}")
    assert code == 200 and got == created
    sent = tserde.to_wire(CORE[plural])
    assert {k: v for k, v in got.items() if k != "metadata"} == {
        k: v for k, v in sent.items() if k != "metadata"}
    assert type(tserde.decode_object(got)) is type(CORE[plural])
    assert pair.both("GET", path)[1]["kind"] == f"{CORE[plural].kind}List"


# -- either client against either server -------------------------------------------


@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_a_remote_store_drives_either_apiserver(client, server):
    C, S = PACKAGES[client], PACKAGES[server]
    api = S.api.APIServer(S.s.ClusterStore(), port=0)
    api.serve_background()
    try:
        store = C.remote.RemoteStore(api.url)
        created = store.create(make_job(C, "alpha"))
        assert created.metadata.uid and created.metadata.resource_version > 0
        assert store.get("TPUJob", "default", "alpha") == created
        with pytest.raises(C.s.AlreadyExists):
            store.create(make_job(C, "alpha"))
        with pytest.raises(C.s.NotFound):
            store.get("TPUJob", "default", "ghost")
        w = store.watch("TPUJob", since_rv=0)
        try:
            ev = w.next(timeout=5)
            assert (ev.type, ev.object.metadata.name) == (C.s.EventType.ADDED, "alpha")
            created.status.gang_restarts = 2
            updated = store.update_status(created)
            assert updated.status.gang_restarts == 2
            with pytest.raises(C.s.Conflict):
                store.update(created)  # stale resourceVersion
            ev = w.next(timeout=5)
            assert (ev.type, ev.object.status.gang_restarts) == (C.s.EventType.MODIFIED, 2)
            store.delete("TPUJob", "default", "alpha")
            ev = w.next(timeout=5)
            assert ev.type == C.s.EventType.DELETED
        finally:
            store.stop_watch(w)
        items, rv = store.list("TPUJob")
        assert items == [] and rv == api.store.resource_version
        # a server-side object decodes to the client package's own types
        assert type(created).__module__ == C.t.__name__
    finally:
        api.shutdown()
        api.server_close()


@pytest.mark.parametrize("client", sorted(PACKAGES))
def test_a_kubeconfig_builds_a_clientset_to_the_port(tmp_path, client):
    C = PACKAGES[client]
    api = tapiserver.APIServer(tstore.ClusterStore(), port=0)
    api.serve_background()
    try:
        path = tmp_path / "kc.json"
        path.write_text(json.dumps({"server": api.url, "qps": 10, "burst": 5}))
        assert C.remote.load_kubeconfig(str(path)) == C.remote.Kubeconfig(
            server=api.url, qps=10.0, burst=5)
        C.remote.clientset_from_kubeconfig(str(path)).tpujobs("default").create(
            make_job(C, "kc"))
        assert api.store.get("TPUJob", "default", "kc").metadata.name == "kc"
    finally:
        api.shutdown()
        api.server_close()


# -- the goldens, byte for byte ----------------------------------------------------

_ASSIGNED = ("uid", "resourceVersion", "creationTimestamp")


def test_the_tpujob_golden_comes_back_byte_for_byte(unadmitted):
    pair = unadmitted
    with open(os.path.join(GOLDEN, "tpujob_wire.json")) as f:
        want = f.read().strip()
    golden = json.loads(want)
    code, _ = pair.both("POST", ML_JOBS, golden)
    assert code == 201
    code, got = pair.both("GET", f"{ML_JOBS}/{golden['metadata']['name']}")
    assert code == 200
    for k in _ASSIGNED:  # what the server assigns on create
        got["metadata"][k] = golden["metadata"][k]
    assert json.dumps(got, indent=2, sort_keys=True) == want


def test_the_gke_pod_golden_comes_back_byte_for_byte():
    with open(os.path.join(GOLDEN, "gke_pod.yaml")) as f:
        want = f.read()
    golden = yaml.safe_load(want)
    api = tapiserver.APIServer(tstore.ClusterStore(), port=0, admission=False)
    api.serve_background()
    try:
        store = tremote.RemoteStore(api.url)
        store.create(tserde.decode_object(golden))
        got = tserde.to_dict(store.get("Pod", "default", golden["metadata"]["name"]))
    finally:
        api.shutdown()
        api.server_close()
    for k in ("uid", "resource_version", "creation_timestamp"):
        got["metadata"][k] = golden["metadata"][k]
    assert yaml.safe_dump(got, sort_keys=True) == want


# -- the deliberate difference -----------------------------------------------------


def test_an_h100_job_is_admitted_by_the_port_only(pair):
    replies = {name: _request(server.url + JOBS, "POST", job_wire("gpu", accelerator="h100-1"))
               for name, server in pair.servers.items()}
    code, err = replies["reference"]
    assert (code, err["reason"]) == (422, "Invalid")
    assert "h100-1" in err["message"]
    code, created = replies["port"]
    assert code == 201 and created["spec"]["tpu"]["accelerator"] == "h100-1"


def test_a_tpu_slice_is_admitted_by_the_reference_only(pair):
    replies = {name: _request(server.url + JOBS, "POST", job_wire("tpu", accelerator="v5p-8"))
               for name, server in pair.servers.items()}
    assert replies["reference"][0] == 201
    code, err = replies["port"]
    assert (code, err["reason"]) == (422, "Invalid")
    assert err["message"] == ("spec.tpu: unknown accelerator generation 'v5p' (accepted: "
                              "cpu-N, h100-N; a TPU slice cannot run on this operator)")


def test_an_unpinned_serve_gets_each_package_s_model_server(pair):
    serve = tserde.to_wire(ttypes.TPUServe(metadata=ttypes.ObjectMeta(name="echo"),
                                           spec=ttypes.TPUServeSpec(task="echo")))
    got = {name: _request(server.url + f"/apis/{API_VERSION}/namespaces/default/tpuserves",
                          "POST", serve) for name, server in pair.servers.items()}
    entry = {n: body["spec"]["template"]["entrypoint"] for n, (code, body) in got.items()}
    assert entry == {"port": tdefaults.DEFAULT_SERVE_ENTRYPOINT,
                     "reference": "tfk8s_tpu.runtime.server:serve"}
    assert masked({**got["port"][1], "spec": None}) == masked({**got["reference"][1], "spec": None})


def test_watch_streams_stay_open_across_heartbeats(pair):
    """A quiet watch gets HEARTBEAT lines, the same from either server."""
    streams = {name: urllib.request.urlopen(f"{server.url}/apis/{API_VERSION}/pods?watch=1",
                                            timeout=10) for name, server in pair.servers.items()}
    try:
        lines = {name: json.loads(r.readline()) for name, r in streams.items()}
    finally:
        for r in streams.values():
            r.close()
    assert lines == {"port": {"type": "HEARTBEAT"}, "reference": {"type": "HEARTBEAT"}}

