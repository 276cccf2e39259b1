"""The port's serving control plane end to end on the CPU: its ``Server``
(store, TPUServe controller, local kubelet) with a ``GatewayServer`` on a
real socket in front of port replicas (``TFK8S_DEVICE=cpu`` in each
template), driven over HTTP.

- a wire round trip, a typed 404 for an unknown serve, a bad route, health;
- a checkpoint rollout through the wire with zero failed requests;
- a tenant quota: a typed 429 with ``Retry-After``, and ``GatewayClient``
  raising the port's ``QuotaExceeded`` past its deadline;
- a replica crashed while it holds a request (``chaos_crash_replica``):
  the request is rerouted to the survivor; with the retry budget spent,
  a 503 naming the replicas tried;
- a tiny-GPT decode-loop replica: its replies through the port's gateway
  equal its direct submits, and equal the bodies the reference's gateway
  returns for the same port replica under the reference's operator;
- a disaggregated serve (a prefill and a decode pool) giving the
  single-pool tokens;
- one trace from ``GatewayClient`` through the gateway into the decode
  loop, and a shed request's trace always kept.
"""

import http.client
import json
import threading
import time

import pytest

import tfk8s_tpu.runtime.kubelet as r_kubelet_mod
import tfk8s_tpu.trainer.serve_controller as r_sc_mod
from tfk8s_tpu.api import types as r_api
from tfk8s_tpu.client import FakeClientset as RFakeClientset
from tfk8s_tpu.gateway.server import GatewayServer as RGatewayServer
from tfk8s_tpu.runtime import LocalKubelet as RLocalKubelet
from tfk8s_tpu.trainer import TPUServeController as RTPUServeController
import tfk8s_tpu_torch.runtime.kubelet as kubelet_mod
import tfk8s_tpu_torch.trainer.serve_controller as sc_mod
from tfk8s_tpu_torch.api import types as api
from tfk8s_tpu_torch.client.store import NotFound
from tfk8s_tpu_torch.cmd.options import Options
from tfk8s_tpu_torch.cmd.server import Server
from tfk8s_tpu_torch.gateway import GatewayClient, GatewayServer
from tfk8s_tpu_torch.obs import trace as obstrace
from tfk8s_tpu_torch.runtime import node_agent
from tfk8s_tpu_torch.runtime import server as serving
from tfk8s_tpu_torch.trainer import labels as L

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PORT_SERVE = "tfk8s_tpu_torch.runtime.server:serve"
GPT_PAYLOADS = [
    {"tokens": [5, 9, 13, 2, 7, 11, 3, 8, 21, 4], "gen_tokens": 6},
    {"tokens": list(range(1, 20)), "gen_tokens": 5},
    {"tokens": [17, 3, 3, 9], "gen_tokens": 6,
     "sampling": {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7}},
]


def echo_serve(a, name, replicas=1, checkpoint="v1", delay_ms="2", tenancy=None, **spec_kw):
    serve = a.TPUServe(
        metadata=a.ObjectMeta(name=name),
        spec=a.TPUServeSpec(
            task="echo", checkpoint=checkpoint, replicas=replicas,
            batching=a.BatchingPolicy(max_batch_size=8, batch_timeout_ms=5.0, queue_limit=256),
            **spec_kw),
    )
    if tenancy is not None:
        serve.spec.tenancy = tenancy
    serve.spec.template.entrypoint = PORT_SERVE
    serve.spec.template.env.update({"TFK8S_SERVE_ECHO_DELAY_MS": delay_ms,
                                    "TFK8S_DEVICE": "cpu"})
    return serve


def gpt_serve(a, name, replicas=1, disaggregation=None):
    serve = a.TPUServe(
        metadata=a.ObjectMeta(name=name),
        spec=a.TPUServeSpec(
            task="gpt", checkpoint="seed:0", replicas=replicas,
            batching=a.BatchingPolicy(max_batch_size=4, batch_timeout_ms=2.0, queue_limit=64,
                                      page_size=8, max_pages=64),
            disaggregation=disaggregation),
    )
    serve.spec.template.entrypoint = PORT_SERVE
    serve.spec.template.env.update({"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_GPT_SIZE": "tiny",
                                    "TFK8S_SERVE_GEN_TOKENS": "6"})
    return serve


@pytest.fixture(scope="module")
def plane():
    """The port's operator with a gateway on an ephemeral port; yields
    (server, gateway)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    mp.setattr(sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    server = Server(Options(workers=2))
    stop = threading.Event()
    server.run(stop, block=False)
    gw = GatewayServer(server.clientset, port=0, metrics=server.metrics)
    gw.serve_background()
    yield server, gw
    # the kubelet's stop ends no pod: deleting the serves drains them
    serves, _ = server.clientset.tpuserves().list()
    for serve in serves:
        server.clientset.tpuserves().delete(serve.metadata.name)
    wait_for(lambda: not [k for s in serves for k in keys_of(s.metadata.name)], timeout=30)
    stop.set()
    gw.shutdown()
    gw.server_close()
    server.shutdown()
    mp.undo()


def ready(cs, name, n):
    try:
        st = cs.tpuserves().get(name).status
    except Exception:  # noqa: BLE001 — either package's NotFound
        return False
    return st.ready_replicas == n


def keys_of(name):
    return sorted(k for k in serving.replica_keys() if k.startswith(f"default/{name}-srv-"))


def start(cs, serve, n=None):
    n = serve.spec.replicas if n is None else n
    cs.tpuserves().create(serve)
    name = serve.metadata.name
    assert wait_for(lambda: ready(cs, name, n) and len(keys_of(name)) == n, timeout=60)
    return keys_of(name)


def raw(gw_port, method, path, payload=None, tenant=None):
    conn = http.client.HTTPConnection("127.0.0.1", gw_port, timeout=30)
    try:
        headers = {"Content-Type": "application/json"}
        if tenant:
            headers["X-Tenant"] = tenant
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, json.loads(
            resp.read() or b"{}")
    finally:
        conn.close()


def test_wire_roundtrip_typed_404_bad_route_and_health(plane):
    server, gw = plane
    cs = server.clientset
    start(cs, echo_serve(api, "echo-gw", replicas=2))
    client = GatewayClient(gw.url, "echo-gw")
    try:
        assert client.request(42.0, timeout=20) == {"echo": 42.0, "version": "v1"}
    finally:
        client.close()
    assert cs.tpuserves().get("echo-gw").status.endpoint == "/v1/serve/default/echo-gw"
    assert server.metrics.get_counter("tfk8s_gateway_requests_total", {
        "serve": "default/echo-gw", "tenant": "default", "code": "200"}) == 1.0
    status, _h, body = raw(gw.port, "POST", "/v1/serve/default/nope", {"payload": 1.0})
    assert (status, body["reason"], body["kind"]) == (404, "NotFound", "Status")
    nope = GatewayClient(gw.url, "nope")
    with pytest.raises(NotFound):
        nope.request(1.0, timeout=5)
    nope.close()
    assert raw(gw.port, "POST", "/v2/other", {})[0] == 404
    assert raw(gw.port, "GET", "/healthz")[:3:2] == (200, {"status": "ok"})
    status, _h, decode = raw(gw.port, "GET", "/debug/decode")
    assert status == 200 and set(keys_of("echo-gw")) <= set(decode["replicas"])


def test_rollout_through_the_wire_fails_no_request(plane):
    server, gw = plane
    cs = server.clientset
    start(cs, echo_serve(api, "roll-gw", replicas=2, rolling_update=api.RollingUpdatePolicy(
        max_surge=1, max_unavailable=0)))
    v1 = cs.tpuserves().get("roll-gw").status.observed_version
    errors, versions, lows, hammer_stop = [], set(), [], threading.Event()

    def hammer(i):
        client = GatewayClient(gw.url, "roll-gw")
        while not hammer_stop.is_set():
            try:
                versions.add(client.request(float(i), timeout=20)["version"])
            except Exception as e:  # noqa: BLE001 — any failure breaks the contract
                errors.append(e)
        client.close()

    threads = [threading.Thread(target=hammer, args=(i,), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    cs.tpuserves().patch("roll-gw", {"spec": {"checkpoint": "v2"}})

    def rolled():
        pods, _ = cs.pods().list(label_selector=L.serve_selector("roll-gw"))
        lows.append(sum(serving.replica_is_ready(p) for p in pods))
        st = cs.tpuserves().get("roll-gw").status
        return (st.observed_version not in ("", v1) and st.ready_replicas == 2
                and st.updated_replicas == 2)

    assert wait_for(rolled, timeout=60, interval=0.02)
    time.sleep(0.3)
    hammer_stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, f"wire requests failed during the rollout: {errors[:3]}"
    assert versions == {"v1", "v2"}
    assert min(lows) >= 2


def test_tenant_quota_sheds_typed_and_the_client_raises_past_its_deadline(plane):
    server, gw = plane
    cs = server.clientset
    start(cs, echo_serve(api, "ten-gw", tenancy=api.TenantPolicy(
        enabled=True,
        tenants={"abuser": api.TenantQuota(qps=2.0, burst=1),
                 "t": api.TenantQuota(qps=0.01, burst=1)},
        default_quota=api.TenantQuota(qps=10_000.0))))
    codes = []
    for i in range(6):
        status, headers, body = raw(gw.port, "POST", "/v1/serve/default/ten-gw",
                                    {"payload": float(i)}, tenant="abuser")
        codes.append(status)
        if status != 200:
            assert (status, body["reason"]) == (429, "QuotaExceeded")
            assert float(headers["retry-after"]) > 0
            assert body["details"]["tenant"] == "abuser"
    assert 200 in codes and 429 in codes
    assert server.metrics.get_counter("tfk8s_gateway_shed_total", {
        "serve": "default/ten-gw", "tenant": "abuser", "reason": "qps"}) >= 1
    client = GatewayClient(gw.url, "ten-gw", tenant="t")
    try:
        assert client.request(1.0, timeout=10)["version"] == "v1"
        with pytest.raises(serving.QuotaExceeded) as ei:
            client.request(2.0, timeout=0.3)
    finally:
        client.close()
    assert ei.value.tenant == "t" and ei.value.reason == "qps"


class _NoBudget:
    def try_accept(self):
        return False


def test_a_crash_mid_flight_reroutes_and_a_spent_budget_names_the_replicas(plane):
    server, gw = plane
    cs = server.clientset
    keys = start(cs, echo_serve(api, "chaos-gw", replicas=2))
    replicas = {k: serving.lookup_replica(k) for k in keys}
    held = []
    for key, rep in replicas.items():  # record which replica takes the request
        rep.chaos_delay(0.5)
        submit = rep.submit
        rep.submit = lambda payload, _k=key, _s=submit, **kw: (held.append(_k), _s(payload, **kw))[1]
    client = GatewayClient(gw.url, "chaos-gw")
    out = {}
    t = threading.Thread(target=lambda: out.update(r=client.request(7.0, timeout=20)),
                         daemon=True)
    t.start()
    assert wait_for(lambda: held, timeout=10, interval=0.005)
    victim = held[0]
    survivor = next(k for k in keys if k != victim)
    replicas[survivor].chaos_delay(0.0)
    assert serving.chaos_crash_replica(victim)
    t.join(timeout=30)
    client.close()
    assert out["r"] == {"echo": 7.0, "version": "v1"}
    assert held == [victim, survivor]
    assert server.metrics.get_counter("tfk8s_gateway_retries_total", {
        "serve": "default/chaos-gw", "tenant": "default", "reason": "transport"}) == 1.0

    (key,) = start(cs, echo_serve(api, "budget-gw"))
    gw.state_for("default", "budget-gw").retry_budget = _NoBudget()
    assert serving.chaos_crash_replica(key)
    status, _h, body = raw(gw.port, "POST", "/v1/serve/default/budget-gw",
                           {"payload": 1.0, "timeoutS": 5.0})
    assert (status, body["reason"]) == (503, "Unavailable")
    assert body["details"]["triedReplicas"] == [key]
    assert "retry budget exhausted" in body["message"]


def _masked(body):
    result = body.get("result")
    if isinstance(result, dict):
        result = {k: v for k, v in result.items() if k != "ttft_s"}
        return {**body, "result": result}
    return body


def _reference_plane_bodies(monkeypatch, serve, paths_payloads):
    """Start the reference's serve controller, kubelet and gateway over a
    fake cluster, run ``serve`` there and POST each payload; the (status,
    body) of each."""
    monkeypatch.setattr(r_kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    monkeypatch.setattr(r_sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    cs = RFakeClientset()
    ctrl = RTPUServeController(cs)
    kubelet = RLocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    gw = RGatewayServer(cs, port=0)
    gw.serve_background()
    try:
        cs.tpuserves().create(serve)
        assert wait_for(lambda: ready(cs, serve.metadata.name, 1), timeout=60)
        return [raw(gw.port, "POST", path, payload)[::2] for path, payload in paths_payloads]
    finally:
        cs.tpuserves().delete(serve.metadata.name)
        name = serve.metadata.name
        wait_for(lambda: not keys_of(name), timeout=30)
        stop.set()
        gw.shutdown()
        gw.server_close()
        ctrl.controller.shutdown()


def test_gpt_replies_equal_direct_submits_and_the_reference_gateways_bodies(plane, monkeypatch):
    server, gw = plane
    cs = server.clientset
    (key,) = start(cs, gpt_serve(api, "gpt-gw"))
    loop = serving.lookup_replica(key)
    assert isinstance(loop, serving.DecodeLoopExecutor)
    client = GatewayClient(gw.url, "gpt-gw")
    try:
        via = [client.request(p, timeout=30) for p in GPT_PAYLOADS]
    finally:
        client.close()
    direct = [loop.submit(dict(p), timeout=30) for p in GPT_PAYLOADS]
    assert [r["tokens"] for r in via] == [r["tokens"] for r in direct]
    assert all(len(r["tokens"]) == p["gen_tokens"] for r, p in zip(via, GPT_PAYLOADS))

    path = "/v1/serve/default/gpt-gw"
    sent = [(path, {"payload": p, "timeoutS": 30}) for p in GPT_PAYLOADS]
    sent.append((path, {"payload": {"tokens": [1] * 70, "gen_tokens": 6}}))  # past max_len
    ours = [raw(gw.port, "POST", p, b)[::2] for p, b in sent]
    cs.tpuserves().delete("gpt-gw")
    assert wait_for(lambda: not keys_of("gpt-gw"), timeout=30)
    theirs = _reference_plane_bodies(monkeypatch, gpt_serve(r_api, "gpt-gw"), sent)
    assert [(s, _masked(b)) for s, b in ours] == [(s, _masked(b)) for s, b in theirs]
    assert ours[-1][0] == 400 and ours[-1][1]["reason"] == "InvalidRequest"
    assert [b["result"]["tokens"] for _s, b in ours[:-1]] == [r["tokens"] for r in direct]


def test_a_disaggregated_serve_gives_the_single_pool_tokens(plane):
    """Greedy requests: the gateway's handoff carries tokens and pages but
    not a request's sampling knobs (``submit_handoff`` gets no
    ``sampling``, in the reference's gateway as in the port's), so a
    sampled request decodes greedily after its first token there."""
    server, gw = plane
    greedy = [p for p in GPT_PAYLOADS if "sampling" not in p]
    cs = server.clientset
    start(cs, gpt_serve(api, "gpt-one"))
    start(cs, gpt_serve(api, "gpt-split", disaggregation=api.DisaggregationPolicy(
        prefill_replicas=1, decode_replicas=1)), n=2)
    pods, _ = cs.pods().list(label_selector=L.serve_selector("gpt-split"))
    assert sorted(p.metadata.labels[L.SERVE_PHASE] for p in pods) == ["decode", "prefill"]
    out = {}
    for name in ("gpt-one", "gpt-split"):
        client = GatewayClient(gw.url, name)
        try:
            out[name] = [client.request(p, timeout=30)["tokens"] for p in greedy]
        finally:
            client.close()
    assert out["gpt-split"] == out["gpt-one"]
    assert server.metrics.get_counter("tfk8s_disagg_handoffs_total", {
        "serve": "default/gpt-split", "outcome": "ok"}) == len(greedy)


@pytest.fixture
def tracer():
    # while a port pod runs under the reference's kubelet anywhere in this
    # process (the reference plane's replica, draining), get_tracer() is the
    # reference's; the trace below must go to the port's own
    assert wait_for(lambda: node_agent.tracer_agent() is None, timeout=30)
    t = obstrace.Tracer(sampler=obstrace.TailSampler(keep_probability=1.0))
    prev = obstrace.set_tracer(t)
    yield t
    obstrace.set_tracer(prev)


def test_one_trace_from_the_client_into_the_decode_loop_and_sheds_kept(plane, tracer):
    server, gw = plane
    cs = server.clientset
    start(cs, gpt_serve(api, "gpt-trace"))
    client = GatewayClient(gw.url, "gpt-trace")
    try:
        assert len(client.request(GPT_PAYLOADS[0], timeout=30)["tokens"]) == 6
    finally:
        client.close()
    want = {"gateway.client.request", "gateway.request", "serve.request"}
    assert wait_for(lambda: want <= {s.name for s in tracer.spans()}, timeout=10)
    by_name = {s.name: s for s in tracer.spans()}
    root, gw_span, serve_span = (by_name[n] for n in ("gateway.client.request",
                                                     "gateway.request", "serve.request"))
    assert root.trace_id == gw_span.trace_id == serve_span.trace_id
    assert (root.parent_id, gw_span.parent_id, serve_span.parent_id) == (
        None, root.span_id, gw_span.span_id)
    assert {"admit", "route.pick"} <= {e["name"] for e in gw_span.events}
    events = [e["name"] for e in serve_span.events]
    assert events[0] == "admitted" and "first_token" in events and events[-1] == "retire"
    status, _h, dbg = raw(gw.port, "GET", f"/debug/requests?trace_id={root.trace_id}")
    assert status == 200 and [r["trace_id"] for r in dbg["recent"]] == [root.trace_id]

    # the coin drops every fast success; a shed is kept all the same
    tracer.set_sampler(obstrace.TailSampler(keep_probability=0.0))
    start(cs, echo_serve(api, "shed-trace", tenancy=api.TenantPolicy(
        enabled=True, tenants={"t": api.TenantQuota(qps=0.01, burst=1)},
        default_quota=api.TenantQuota(qps=10_000.0))))
    client = GatewayClient(gw.url, "shed-trace", tenant="t")
    try:
        client.request(1.0, timeout=10)
        with pytest.raises(serving.QuotaExceeded):
            client.request(2.0, timeout=0.3)
    finally:
        client.close()

    def shed_span():
        return next((s for s in tracer.find_spans("gateway.request")
                     if s.attributes.get("http.status_code") == 429), None)

    assert wait_for(lambda: shed_span() is not None, timeout=10)
    span = shed_span()
    assert span.attributes["sampling.reason"] in ("error", "status_code")
    assert "shed" in [e["name"] for e in span.events]
    assert tracer.dropped.get("sampled", 0) >= 1
    assert any(s.trace_id == span.trace_id for s in tracer.find_spans("gateway.client.request"))
