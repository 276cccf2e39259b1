"""F5: the reference's gateway routes to port replicas.

A TPUServe whose template pins the port's entrypoint runs under the
reference's serve controller and ``LocalKubelet``, behind a real
``GatewayServer`` on a socket (the ``tests/test_gateway_e2e.py`` fixture).
The port's ``serve`` finds the agent's serving table through the stop
object and registers its replica there, wrapped in ``AgentReplica``:

- gateway traffic reaches the port replica, and ``/debug/decode`` lists it;
- a request the replica sheds reads the same status and reason through the
  gateway as one a JAX replica sheds, and the replica raises the agent's
  own ``Overloaded`` with its fields;
- draining the replica fires the gateway's drain hooks;
- a port GPT replica's decode loop answers gateway requests with the
  tokens it gives a direct caller, and its KV peer fetch resolves peers
  in the agent's table;
- the adapter speaks the agent's types on the disaggregated path too:
  prefill hands back the agent's ``KVHandoffBuffer``, and the agent's buffer
  decodes to the same tokens as a single-replica run.
"""

import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import tfk8s_tpu.runtime.kubelet as kubelet_mod
import tfk8s_tpu.trainer.serve_controller as sc_mod
from tfk8s_tpu.api.types import BatchingPolicy, ObjectMeta, TPUServe, TPUServeSpec
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.gateway.client import GatewayClient
from tfk8s_tpu.gateway.server import GatewayServer
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.runtime import handoff as jhandoff
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu.runtime.kubelet import PodStopSignal
from tfk8s_tpu.trainer import TPUServeController
from tfk8s_tpu.utils.logging import Metrics
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import node_agent
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.agent_replica import AgentReplica

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

PORT_ENTRY = "tfk8s_tpu_torch.runtime.server:serve"


def make_serve(name, port=True, delay_ms=2, max_batch=8, queue_limit=256):
    serve = TPUServe(
        metadata=ObjectMeta(name=name),
        spec=TPUServeSpec(
            task="echo", checkpoint="v1", replicas=1,
            batching=BatchingPolicy(max_batch_size=max_batch, batch_timeout_ms=0.0,
                                    queue_limit=queue_limit),
        ),
    )
    serve.spec.template.env["TFK8S_SERVE_ECHO_DELAY_MS"] = str(delay_ms)
    if port:
        serve.spec.template.entrypoint = PORT_ENTRY
        serve.spec.template.env["TFK8S_DEVICE"] = "cpu"
    return serve


@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    monkeypatch.setattr(sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    cs = FakeClientset()
    ctrl = TPUServeController(cs)
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    gw = GatewayServer(cs, port=0, metrics=Metrics())
    gw.serve_background()
    yield cs, gw
    try:
        # the kubelet's stop ends no pod: delete the serves so their replicas
        # drain, or a port replica stays bound to the reference's node agent
        # (and its tracer) for the rest of the process
        for serve in cs.tpuserves().list()[0]:
            cs.tpuserves().delete(serve.metadata.name)
        assert wait_for(lambda: not kubelet._claimed, timeout=60)
    finally:
        stop.set()
        gw.shutdown()
        gw.server_close()
        ctrl.controller.shutdown()


def _ready(cs, name):
    try:
        return cs.tpuserves().get(name).status.ready_replicas
    except Exception:  # noqa: BLE001
        return -1


def _key(name):
    keys = [k for k in jserver.replica_keys() if k.startswith(f"default/{name}-srv-")]
    return keys[0] if len(keys) == 1 else None


def _start(cs, serve):
    cs.tpuserves().create(serve)
    name = serve.metadata.name
    assert wait_for(lambda: _ready(cs, name) == 1 and _key(name) is not None, timeout=60)
    return _key(name)


def _post(gw, name, payload):
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=20)
    try:
        conn.request("POST", f"/v1/serve/default/{name}", body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _get(gw, path):
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_the_serving_table_is_found_from_the_kubelet_stop_signal():
    assert node_agent.serving_module(PodStopSignal()) is jserver
    for outside in (None, threading.Event(), object()):
        assert node_agent.serving_module(outside) is None


def test_gateway_traffic_reaches_a_port_replica(cluster):
    cs, gw = cluster
    key = _start(cs, make_serve("torch-echo"))
    held = jserver.lookup_replica(key)
    assert isinstance(held, AgentReplica)
    assert isinstance(held.server, tserver.ModelServer)
    assert tserver.lookup_replica(key) is held.server
    client = GatewayClient(gw.url, "torch-echo")
    try:
        out = client.request(42.0, timeout=20)
    finally:
        client.close()
    assert out == {"echo": 42.0, "version": "v1"}
    assert held.server.served_total == 1
    status, body = _get(gw, "/debug/decode")
    assert status == 200
    assert body["replicas"][key]["kind"] == "batch"
    assert body["replicas"][key]["served_total"] == 1


def _shed_through_the_gateway(cs, gw, name, port):
    """Wedge the replica (one slow request running, one queued, queue
    limit 1), then: a direct call through the agent's table and a gateway
    POST. Returns (the direct error, (status, reason))."""
    key = _start(cs, make_serve(name, port=port, delay_ms=1000, max_batch=1, queue_limit=1))
    replica = jserver.lookup_replica(key)
    with ThreadPoolExecutor(2) as ex:
        running = ex.submit(replica.submit, 1.0, timeout=20)
        time.sleep(0.25)  # the batcher takes it at once (batch timeout 0)
        assert replica.queue_depth == 0 and not running.done()
        queued = ex.submit(replica.submit, 2.0, timeout=20)
        assert wait_for(lambda: replica.queue_depth == 1, timeout=5)
        with pytest.raises(jserver.ServeError) as direct:
            replica.submit(3.0, timeout=5)
        status, body = _post(gw, name, {"payload": 4.0})
        assert running.result(timeout=20)["echo"] == 1.0
        assert queued.result(timeout=20)["echo"] == 2.0
    return direct.value, (status, body.get("reason"))


def test_a_shed_reads_the_same_status_as_from_a_jax_replica(cluster):
    cs, gw = cluster
    port_err, port_wire = _shed_through_the_gateway(cs, gw, "shed-torch", port=True)
    jax_err, jax_wire = _shed_through_the_gateway(cs, gw, "shed-jax", port=False)
    assert port_wire == jax_wire == (429, "Overloaded")
    for err in (port_err, jax_err):
        assert type(err) is jserver.Overloaded
        assert (err.queue_depth, err.queue_limit) == (1, 1)
    assert isinstance(port_err.__cause__, tserver.Overloaded)


def test_draining_a_port_replica_fires_the_drain_hooks(cluster):
    cs, gw = cluster
    key = _start(cs, make_serve("torch-drain"))
    replica = jserver.lookup_replica(key)
    fired = []
    jserver.add_drain_hook(fired.append)
    try:
        cs.tpuserves().patch("torch-drain", {"spec": {"replicas": 0}})
        assert wait_for(lambda: key in fired, timeout=30)
    finally:
        jserver.remove_drain_hook(fired.append)
    assert jserver.lookup_replica(key) is None and tserver.lookup_replica(key) is None
    with pytest.raises(jserver.Draining):
        replica.submit(1.0, timeout=5)


def test_gateway_gpt_requests_reach_a_port_decode_loop(cluster):
    cs, gw = cluster
    serve = TPUServe(
        metadata=ObjectMeta(name="torch-gpt-gw"),
        spec=TPUServeSpec(task="gpt", checkpoint="seed:0", replicas=1,
                          batching=BatchingPolicy(max_batch_size=2, page_size=8, max_pages=32)),
    )
    serve.spec.template.entrypoint = PORT_ENTRY
    serve.spec.template.env.update({"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_GEN_TOKENS": "4"})
    key = _start(cs, serve)
    loop = tserver.lookup_replica(key)
    assert isinstance(loop, tserver.DecodeLoopExecutor)
    payload = {"tokens": [5, 9, 13, 2, 7], "gen_tokens": 4}
    client = GatewayClient(gw.url, "torch-gpt-gw")
    try:
        out = client.request(payload, timeout=30)
    finally:
        client.close()
    assert out["tokens"] == loop.submit(dict(payload, tokens=np.array(payload["tokens"])),
                                        timeout=30)["tokens"]
    peer = object()
    jserver.register_replica("default/jax-peer", peer)
    try:
        assert loop._kv_resolve("default/jax-peer") is peer
        assert loop._kv_resolve(key) is loop
    finally:
        jserver.unregister_replica("default/jax-peer")


def test_the_adapter_carries_handoffs_and_errors_in_the_agents_types():
    """A port decode loop behind ``AgentReplica``: prefill returns the
    agent's buffer, the agent's buffer decodes to a single-replica run's
    tokens; a garbled buffer raises the agent's ``HandoffError``, one of
    another geometry the agent's ``RowFault``, and a prompt past max_len
    the agent's ``InvalidRequest``."""
    decoder = tserver.PagedGptDecoder(
        "seed:0", slots=2, page_size=8, max_pages=32, gen_tokens=6,
        cfg=tgpt.tiny_config(dtype=torch.float32), device="cpu")
    decoder.load()
    loop = tserver.DecodeLoopExecutor(decoder, metrics=tserver.Metrics()).start()
    replica = AgentReplica(loop, jserver)
    payload = {"tokens": np.random.default_rng(4).integers(1, 64, 19).astype(np.int32),
               "gen_tokens": 6}
    try:
        whole = replica.submit(payload, timeout=30)["tokens"]
        first = replica.submit_prefill(payload, timeout=30)
        assert type(first["handoff"]) is jhandoff.KVHandoffBuffer
        assert first["tokens"] == whole[:1]
        assert replica.submit_handoff(first["handoff"], timeout=30)["tokens"] == whole
        prefix = replica.export_prefix(payload["tokens"])
        assert prefix is None or type(prefix) is jhandoff.KVHandoffBuffer
        assert set(replica.kv_digest_report()) >= {"digests"}
        with pytest.raises(jserver.InvalidRequest):
            replica.submit({"tokens": np.ones(70, np.int32), "gen_tokens": 6}, timeout=5)
        class Garbled:
            def to_bytes(self):
                return b"not a handoff buffer"

        with pytest.raises(jhandoff.HandoffError):
            replica.submit_handoff(Garbled(), timeout=30)
        short = jhandoff.KVHandoffBuffer.from_bytes(first["handoff"].to_bytes())
        short.kv = short.kv[:1]
        with pytest.raises(jserver.RowFault):  # the executor's typed row failure
            replica.submit_handoff(short, timeout=30)
    finally:
        loop.drain(10)
    with pytest.raises(jserver.Draining):
        replica.submit(payload, timeout=5)
