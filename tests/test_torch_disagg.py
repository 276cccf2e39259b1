"""Disaggregated prefill/decode serving on port replicas, held to the
reference's executor and routed by the reference's gateway.

The flows of ``tests/test_disagg_serving.py`` (its replica-bearing
classes and its slow e2e) with port decode loops: tiny float32 GPT on
bridged parameters (``_torch_serving``), so every generated token is held
exactly to a JAX executor's run of the same request.

- handoff bit identity across port pools for a sub-page prompt, an exact
  page multiple, and pages plus a partial page;
- mixed pools through ``GatewayServer.dispatch``: JAX prefill -> port
  decode and port prefill -> JAX decode;
- page-size and version mismatches refused with ``HandoffError``, the
  port's own and, behind ``AgentReplica``, the agent's;
- the prefix-cache counters in ``debug_state``;
- the gateway's two-phase round trip with its session, the session
  re-pinned after its affine replica is ejected, a decode replica that
  died mid-handoff (one prefill, one transport retry), ``/debug/routes``;
- the wire: a port buffer's bytes equal the reference's on the same
  leaves;
- the e2e: a disaggregated TPUServe pinning the port's entrypoint under
  the serve controller, ``LocalKubelet`` and a socket gateway.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

import tfk8s_tpu.gateway.server as gw_mod
import tfk8s_tpu.runtime.kubelet as kubelet_mod
import tfk8s_tpu.trainer.serve_controller as sc_mod
from _torch_serving import (
    PAGE,
    agent,
    greedy,
    jax_exec,
    port_exec,
    serve_state,
    start_gateway,
    stop_gateway,
    tokens,
)
from conftest import wait_for
from tfk8s_tpu.api.types import (
    BatchingPolicy,
    DisaggregationPolicy,
    ObjectMeta,
    TPUServe,
    TPUServeSpec,
)
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.gateway.affinity import AffinityRing, affinity_key_of
from tfk8s_tpu.gateway.client import GatewayClient
from tfk8s_tpu.gateway.server import GatewayServer
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.runtime import handoff as jhandoff
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu.trainer import TPUServeController
from tfk8s_tpu.trainer import labels as L
from tfk8s_tpu.utils.logging import Metrics
from tfk8s_tpu_torch.runtime import handoff as thandoff
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.agent_replica import AgentReplica
from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain

PORT_ENTRY = "tfk8s_tpu_torch.runtime.server:serve"


@pytest.fixture(scope="module")
def pools():
    """Two port prefill loops, one port decode loop, and a JAX loop (the
    reference tokens, and the JAX pool of the mixed cases)."""
    execs = {"p-a": port_exec(), "p-b": port_exec(), "d-x": port_exec(), "j": jax_exec()}
    yield execs
    for ex in execs.values():
        ex.drain(10)


def table(pools, **keys):
    """The gateway's ``lookup_replica``: key -> replica as the agent's
    table holds it (a port loop behind ``AgentReplica``, a JAX loop as is)."""
    return {f"default/{k}": (ex if ex is pools["j"] else agent(ex))
            for k, ex in ((k, pools[v]) for k, v in keys.items())}.get


@pytest.fixture
def gw():
    cs, server, metrics = start_gateway()
    yield cs, server, metrics
    stop_gateway(server)


class TestHandoffBitIdentity:
    @pytest.mark.parametrize("plen,gen", [
        (5, 4),            # sub-page prompt: no full pages ride the chain
        (PAGE * 2, 6),     # exact page multiple
        (PAGE * 3 + 3, 8),  # pages + a trailing partial page
    ])
    def test_handoff_generation_equals_the_reference(self, pools, plen, gen):
        """Prefill on one port replica + the wire + decode on another ==
        a single-replica run, and both == the JAX executor's tokens."""
        payload = {"tokens": tokens(plen, seed=100 + plen), "gen_tokens": gen}
        want = greedy(pools["j"], payload)
        assert greedy(pools["d-x"], payload) == want
        pre = pools["p-a"].submit_prefill(dict(payload), timeout=30)
        buf = pre["handoff"]
        assert pre["tokens"] == want[:1]
        assert type(buf) is thandoff.KVHandoffBuffer
        assert buf.n_pages == -(-plen // PAGE)
        moved, nbytes = thandoff.LocalKVTransport().transfer(buf)
        assert nbytes == len(buf.to_bytes()) > 0
        assert pools["d-x"].submit_handoff(moved, timeout=30)["tokens"] == want

    def _buffer(self, pools, seed):
        return pools["p-a"].submit_prefill(
            {"tokens": tokens(PAGE, seed=seed), "gen_tokens": 2}, timeout=30)["handoff"]

    def test_page_size_mismatch_refused(self, pools):
        buf = self._buffer(pools, 41)
        buf.page_size = PAGE * 2
        with pytest.raises(thandoff.HandoffError):
            pools["d-x"].submit_handoff(buf, timeout=30)
        with pytest.raises(jhandoff.HandoffError):
            agent(pools["d-x"]).submit_handoff(buf, timeout=30)

    def test_version_mismatch_refused(self, pools):
        buf = self._buffer(pools, 42)
        buf.version = "seed:1"
        with pytest.raises(thandoff.HandoffError, match="params differ"):
            pools["d-x"].submit_handoff(buf, timeout=30)
        with pytest.raises(jhandoff.HandoffError, match="params differ"):
            agent(pools["d-x"]).submit_handoff(buf, timeout=30)

    def test_prefix_cache_counters_in_debug_state(self, pools):
        ex = pools["p-b"]
        prompt = tokens(PAGE * 2, seed=77)
        ex.submit_prefill({"tokens": prompt, "gen_tokens": 2}, timeout=30)
        before = ex.debug_state()["prefix_cache"]
        grown = np.concatenate([prompt, tokens(PAGE, seed=78)])
        ex.submit_prefill({"tokens": grown, "gen_tokens": 2}, timeout=30)
        after = ex.debug_state()["prefix_cache"]
        assert after["hits"] == before["hits"] + 1
        assert after["misses"] == before["misses"]
        assert 0.0 <= after["hit_ratio"] <= 1.0

    def test_wire_bytes_equal_the_references(self):
        """The port's buffer serializes the reference's leaves to the
        reference's bytes, and each package reads the other's."""
        n = PAGE * 2
        toks = [int(t) for t in tokens(n, seed=7)]
        leaf = np.arange(2 * PAGE * 2 * 4, dtype=np.float32).reshape(2 * PAGE, 2, 4)
        common = dict(version="seed:0", page_size=PAGE, tokens=toks, last_token=3,
                      gen_budget=4, digests=prefix_digest_chain(toks, PAGE, n // PAGE))
        twire = thandoff.KVHandoffBuffer(kv=[torch.from_numpy(leaf)], **common).to_bytes()
        jwire = jhandoff.KVHandoffBuffer(kv=[leaf], **common).to_bytes()
        assert twire == jwire
        back, nbytes = thandoff.LocalKVTransport().transfer(
            thandoff.KVHandoffBuffer.from_bytes(jwire))
        assert nbytes == len(jwire)
        assert back.tokens == toks and back.digests == common["digests"]
        assert torch.equal(back.kv[0], torch.from_numpy(leaf))
        np.testing.assert_array_equal(jhandoff.KVHandoffBuffer.from_bytes(twire).kv[0], leaf)


class TestDisaggGateway:
    def test_two_phase_roundtrip_equals_the_reference_and_sets_session(
            self, gw, pools, monkeypatch):
        cs, server, metrics = gw
        monkeypatch.setattr(gw_mod, "lookup_replica", table(pools, **{"p-a": "p-a", "d-x": "d-x"}))
        serve_state(cs, server, "dz", ["default/p-a"], ["default/d-x"])
        prompt = tokens(PAGE * 2, seed=200)
        payload = {"tokens": [int(t) for t in prompt], "gen_tokens": 4}
        want = greedy(pools["j"], payload)
        meta = {}
        out = server.dispatch("default", "dz", "default", payload, 20.0, meta=meta)
        assert out["tokens"] == want
        assert meta["session"] == affinity_key_of(prompt, PAGE)
        assert metrics.get_counter("tfk8s_disagg_handoffs_total", {
            "serve": "default/dz", "outcome": "ok"}) >= 1

    @pytest.mark.parametrize("prefill,decode", [("j", "d-x"), ("p-a", "j")],
                             ids=["jax_prefill_port_decode", "port_prefill_jax_decode"])
    def test_mixed_pools_through_the_gateway(self, gw, pools, monkeypatch, prefill, decode):
        """One pool of each backend: the gateway moves the agent's buffer
        across, and the stream is the single-replica reference's."""
        cs, server, metrics = gw
        monkeypatch.setattr(gw_mod, "lookup_replica", table(pools, pre=prefill, dec=decode))
        name = f"mix-{prefill}-{decode}"
        serve_state(cs, server, name, ["default/pre"], ["default/dec"])
        port = pools["p-a"] if prefill == "p-a" else pools["d-x"]
        family = "tfk8s_disagg_exports_total" if prefill == "p-a" else "tfk8s_disagg_imports_total"
        moved0 = port.metrics.get_counter(family) or 0
        payload = {"tokens": [int(t) for t in tokens(PAGE * 3 + 5, seed=210)], "gen_tokens": 6}
        want = greedy(pools["j"], payload)
        out = server.dispatch("default", name, "default", payload, 20.0)
        assert out["tokens"] == want
        assert port.metrics.get_counter(family) == moved0 + 1
        assert metrics.get_counter("tfk8s_disagg_handoffs_total", {
            "serve": f"default/{name}", "outcome": "ok"}) == 1.0

    def test_session_repins_after_affine_replica_ejection(self, gw, pools, monkeypatch):
        """A session whose affine prefill replica is ejected re-prefills
        its history exactly once on the ring successor, then hits there."""
        cs, server, _ = gw
        keys = ["default/p-a", "default/p-b"]
        monkeypatch.setattr(gw_mod, "lookup_replica",
                            table(pools, **{"p-a": "p-a", "p-b": "p-b", "d-x": "d-x"}))
        state = serve_state(cs, server, "sess", keys, ["default/d-x"])
        history = tokens(PAGE * 2, seed=300)
        meta = {}
        server.dispatch("default", "sess", "default",
                        {"tokens": [int(t) for t in history], "gen_tokens": 4}, 20.0, meta=meta)
        akey = meta["session"]
        ring = AffinityRing()
        for k in keys:
            ring.add(k)
        owner = ring.owner(akey)
        survivor = keys[0] if owner == keys[1] else keys[1]
        owner_ex, surv_ex = pools[owner.split("/")[1]], pools[survivor.split("/")[1]]
        ejected = {}

        def counters(ex):
            pc = ex.debug_state()["prefix_cache"]
            return pc["hits"], pc["misses"]

        def turn(hist):
            for k in keys:
                if k != ejected.get("key"):
                    state.prefill.observe(k, 0.0)
            state.decode.observe("default/d-x", 0.0)
            meta = {}
            payload = {"tokens": [int(t) for t in hist], "gen_tokens": 4}
            out = server.dispatch("default", "sess", "default", payload, 20.0,
                                  session=akey, meta=meta)
            assert meta["session"] == akey
            assert out["tokens"] == greedy(pools["j"], payload)
            return np.concatenate([hist, np.asarray(out["tokens"], np.int32),
                                   tokens(4, seed=len(hist))])

        h0, m0 = counters(owner_ex)
        history = turn(history)  # turn 2: the owner's cache
        assert counters(owner_ex) == (h0 + 1, m0)
        ejected["key"] = owner
        state.prefill.remove(owner)
        sh0, sm0 = counters(surv_ex)
        history = turn(history)  # turn 3: one re-prefill on the successor
        assert counters(surv_ex) == (sh0, sm0 + 1)
        turn(history)  # turn 4: re-pinned, warm
        assert counters(surv_ex) == (sh0 + 1, sm0 + 1)

    def test_decode_death_mid_handoff_reroutes_without_reprefill(self, gw, pools, monkeypatch):
        """The handoff target is a crashed port replica: the gateway still
        holds the buffer, a surviving port decode replica takes the same
        buffer, the prefill ran once, and one transport retry counts."""
        cs, server, metrics = gw

        class Counted(AgentReplica):
            calls = 0

            def submit_handoff(self, buf, **kw):
                type(self).calls += 1
                return super().submit_handoff(buf, **kw)

        corpse = port_exec()
        corpse.chaos_crash("chaos: decode host died")
        dead = Counted(corpse, jserver)
        lookup = table(pools, **{"p-a": "p-a", "d-x": "d-x"})
        monkeypatch.setattr(gw_mod, "lookup_replica",
                            lambda key: dead if key == "default/d-dead" else lookup(key))
        state = serve_state(cs, server, "hdie", ["default/p-a"], ["default/d-dead", "default/d-x"])
        state.decode.observe("default/d-dead", 0.0)
        for _ in range(4):
            state.decode.observe("default/d-x", 2.0)
        served0 = pools["p-a"].served_total
        payload = {"tokens": [int(t) for t in tokens(PAGE * 2, seed=400)], "gen_tokens": 4}
        want = greedy(pools["j"], payload)
        out = server.dispatch("default", "hdie", "default", payload, 20.0)
        assert out["tokens"] == want
        assert Counted.calls == 1
        assert pools["p-a"].served_total == served0 + 1
        assert metrics.get_counter("tfk8s_gateway_retries_total", {
            "serve": "default/hdie", "tenant": "default", "reason": "transport"}) == 1.0

    def test_debug_routes_shows_phase_tables_and_ring(self, gw, pools, monkeypatch):
        cs, server, _ = gw
        monkeypatch.setattr(gw_mod, "lookup_replica", table(pools, **{"p-a": "p-a", "d-x": "d-x"}))
        serve_state(cs, server, "dbg", ["default/p-a"], ["default/d-x"])
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        try:
            conn.request("GET", "/debug/routes")
            resp = conn.getresponse()
            assert resp.status == 200
            body = json.loads(resp.read())
        finally:
            conn.close()
        entry = body["serves"]["default/dbg"]
        assert set(entry) == {"prefill", "decode"}
        assert entry["prefill"]["replicas"][0]["replica"] == "default/p-a"
        assert "default/p-a" in entry["prefill"]["ring"]["members"]
        assert "ring" not in entry["decode"]


def test_disagg_serve_of_port_pods_e2e_with_sticky_session(monkeypatch):
    """Two port pods, one a phase, rendered by the serve controller and
    run by ``LocalKubelet``; a socket gateway moves each request across
    them, and the second turn rides the session."""
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    monkeypatch.setattr(sc_mod, "AUTOSCALE_PERIOD_S", 0.1)
    cs = FakeClientset()
    ctrl = TPUServeController(cs)
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    metrics = Metrics()
    gw = GatewayServer(cs, port=0, metrics=metrics)
    gw.serve_background()
    try:
        serve = TPUServe(
            metadata=ObjectMeta(name="tdge2e"),
            spec=TPUServeSpec(
                task="gpt", checkpoint="seed:0",
                batching=BatchingPolicy(max_batch_size=4, batch_timeout_ms=2.0, queue_limit=64,
                                        page_size=PAGE, max_pages=64),
                disaggregation=DisaggregationPolicy(prefill_replicas=1, decode_replicas=1),
            ),
        )
        serve.spec.template.entrypoint = PORT_ENTRY
        serve.spec.template.env.update({"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_GEN_TOKENS": "4",
                                        "TFK8S_SERVE_GPT_SIZE": "tiny"})
        cs.tpuserves().create(serve)

        def ready():
            try:
                return cs.tpuserves().get("tdge2e").status.ready_replicas
            except Exception:  # noqa: BLE001
                return -1

        assert wait_for(lambda: ready() == 2, timeout=120)
        pods, _ = cs.pods().list(label_selector=L.serve_selector("tdge2e"))
        by_phase = {p.metadata.labels.get(L.SERVE_PHASE, ""): p for p in pods}
        assert sorted(by_phase) == ["decode", "prefill"]
        for phase, pod in by_phase.items():
            held = jserver.lookup_replica(pod.metadata.key)
            assert isinstance(held, AgentReplica)
            assert isinstance(held.server, tserver.DecodeLoopExecutor)
            assert held.server.labels["phase"] == phase
        assert cs.tpuserves().get("tdge2e").status.endpoint == (
            "/v1/serve/default/tdge2e#prefill,/v1/serve/default/tdge2e#decode")

        client = GatewayClient(gw.url, "tdge2e")
        try:
            history = [int(t) for t in tokens(PAGE * 2, seed=500)]
            out = client.request({"tokens": history, "gen_tokens": 4}, timeout=60)
            assert len(out["tokens"]) == 4
            assert client.session, "the disaggregated gateway returns the session"
            history += out["tokens"] + [int(t) for t in tokens(4, seed=501)]
            out2 = client.request({"tokens": history, "gen_tokens": 4}, timeout=60)
            assert len(out2["tokens"]) == 4
        finally:
            client.close()
        assert metrics.get_counter("tfk8s_disagg_handoffs_total", {
            "serve": "default/tdge2e", "outcome": "ok"}) >= 2
        prefill = jserver.lookup_replica(by_phase["prefill"].metadata.key).server
        assert prefill.debug_state()["prefix_cache"]["hits"] >= 1, "turn 2 hits the pinned cache"
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=10)
        try:
            conn.request("GET", "/debug/routes")
            body = json.loads(conn.getresponse().read())
        finally:
            conn.close()
        assert len(body["serves"]["default/tdge2e"]["prefill"]["ring"]["members"]) == 1
    finally:
        stop.set()
        gw.shutdown()
        gw.server_close()
        ctrl.controller.shutdown()
