"""The gateway's KV cache directory over port replicas.

``TestDirectoryGateway``'s four flows (``tests/test_kv_tier.py``) on a
port fleet: two prefill loops with host and peer tiers, one decode loop,
each a tiny float32 GPT on bridged parameters (``_torch_serving``) behind
``AgentReplica`` where the reference's gateway looks them up, and the
port's own executors where a port replica resolves its peers (as
``serve`` does: the port's table first). Every request's tokens are held
exactly to a JAX executor's.

- a fresh directory report overrides the consistent hash: the warm
  replica takes the prefill and hits its cache (``outcome=hit``);
- a stale owner ejected between the report and the pick costs a fallback
  prefill on the survivor, and the request is still served;
- a serve without ``kvTier`` polls no replica and has no directory series;
- ``/debug/routes`` shows the directory's digest counts, the host-tier
  occupancy and the lookup outcomes.
"""

import http.client
import json

import pytest

import tfk8s_tpu.gateway.server as gw_mod
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
from tfk8s_tpu.api.types import KVTierPolicy

PEER_FETCH = "tfk8s_serving_kv_peer_fetches_total"


@pytest.fixture(scope="module")
def kvfleet():
    """(the gateway's table: key -> ``AgentReplica``, the peers' table:
    key -> port executor, the JAX reference executor)."""
    peers = {}
    for key in ("default/p-a", "default/p-b"):
        peers[key] = port_exec(kv_host_bytes=8 << 20, kv_peer_fetch=True,
                               kv_peer_resolve=peers.get)
    peers["default/d-x"] = port_exec()
    ref = jax_exec()
    yield {k: agent(ex) for k, ex in peers.items()}, peers, ref
    for ex in (*peers.values(), ref):
        ex.drain(10)


@pytest.fixture
def gw():
    cs, server, metrics = start_gateway()
    yield cs, server, metrics
    stop_gateway(server)


def kv_state(cs, server, name, prefill_keys, decode_keys, kv_tier=True):
    policy = KVTierPolicy(host_bytes=8 << 20, peer_fetch=True) if kv_tier else None
    return serve_state(cs, server, name, prefill_keys, decode_keys, kv_tier=policy)


def test_directory_hit_overrides_the_ring(gw, kvfleet, monkeypatch):
    cs, server, metrics = gw
    fleet, peers, ref = kvfleet
    monkeypatch.setattr(gw_mod, "lookup_replica", fleet.get)
    state = kv_state(cs, server, "kvd", ["default/p-a", "default/p-b"], ["default/d-x"])
    assert state.kv_dir is not None
    payload = {"tokens": [int(t) for t in tokens(PAGE * 2, seed=1000)], "gen_tokens": 4}
    warm = peers["default/p-a"]
    warm.submit_prefill(dict(payload), timeout=30)  # warm p-a out of band
    state.kv_dir._last_poll = float("-inf")
    hits0 = warm.debug_state()["prefix_cache"]["hits"]
    state.prefill.observe("default/p-a", 0.0)
    state.prefill.observe("default/p-b", 0.0)
    state.decode.observe("default/d-x", 0.0)
    out = server.dispatch("default", "kvd", "default", payload, 20.0)
    assert out["tokens"] == greedy(ref, payload)
    assert metrics.get_counter("tfk8s_gateway_kv_directory_total", {
        "serve": "default/kvd", "outcome": "hit"}) >= 1.0
    assert warm.debug_state()["prefix_cache"]["hits"] == hits0 + 1


def test_stale_owner_ejected_midfetch_still_serves(gw, kvfleet, monkeypatch):
    cs, server, metrics = gw
    fleet, peers, ref = kvfleet
    gateway_table = dict(fleet)
    monkeypatch.setattr(gw_mod, "lookup_replica", gateway_table.get)
    state = kv_state(cs, server, "kvs", ["default/p-a", "default/p-b"], ["default/d-x"])
    payload = {"tokens": [int(t) for t in tokens(PAGE * 2, seed=1100)], "gen_tokens": 4}
    want = greedy(ref, payload)
    # warm p-a, the replica about to vanish (not d-x, which must stay cold)
    assert greedy(peers["default/p-a"], payload) == want
    state.kv_dir._last_poll = float("-inf")
    state.prefill.observe("default/p-a", 0.0)
    state.prefill.observe("default/p-b", 0.0)
    state.kv_dir.report("default/p-a", fleet["default/p-a"].kv_digest_report())
    # ejected mid-flight: gone from the route table, the gateway's table
    # and the peers' table
    state.prefill.remove("default/p-a")
    del gateway_table["default/p-a"]
    gone = peers.pop("default/p-a")
    try:
        state.prefill.observe("default/p-b", 0.0)
        state.decode.observe("default/d-x", 0.0)
        survivor = peers["default/p-b"]
        fb0 = survivor.metrics.get_counter(PEER_FETCH, {"outcome": "fallback"}) or 0
        out = server.dispatch("default", "kvs", "default", payload, 20.0)
        assert out["tokens"] == want, "the fallback prefill still serves"
        assert survivor.metrics.get_counter(PEER_FETCH, {"outcome": "fallback"}) == fb0 + 1
    finally:
        peers["default/p-a"] = gone


def test_absent_policy_zero_directory_traffic(gw, kvfleet, monkeypatch):
    cs, server, metrics = gw
    fleet, _peers, ref = kvfleet
    polled = []

    class Spy:
        def __init__(self, replica):
            self._replica = replica

        def __getattr__(self, name):
            if name == "kv_digest_report":
                polled.append(name)
            return getattr(self._replica, name)

    gateway_table = dict(fleet, **{"default/p-a": Spy(fleet["default/p-a"])})
    monkeypatch.setattr(gw_mod, "lookup_replica", gateway_table.get)
    state = kv_state(cs, server, "kvoff", ["default/p-a"], ["default/d-x"], kv_tier=False)
    assert state.kv_dir is None
    payload = {"tokens": [int(t) for t in tokens(PAGE * 2, seed=1200)], "gen_tokens": 4}
    out = server.dispatch("default", "kvoff", "default", payload, 20.0)
    assert out["tokens"] == greedy(ref, payload)
    assert polled == []
    assert metrics.get_counter("tfk8s_gateway_kv_directory_total", {
        "serve": "default/kvoff", "outcome": "hit"}) is None


def test_debug_routes_shows_directory_and_host_occupancy(gw, kvfleet, monkeypatch):
    cs, server, _ = gw
    fleet, _peers, ref = kvfleet
    monkeypatch.setattr(gw_mod, "lookup_replica", fleet.get)
    state = kv_state(cs, server, "kvdbg", ["default/p-a"], ["default/d-x"])
    payload = {"tokens": [int(t) for t in tokens(PAGE * 2, seed=1300)], "gen_tokens": 4}
    state.kv_dir._last_poll = float("-inf")
    state.prefill.observe("default/p-a", 0.0)
    state.decode.observe("default/d-x", 0.0)
    out = server.dispatch("default", "kvdbg", "default", payload, 20.0)
    assert out["tokens"] == greedy(ref, payload)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.request("GET", "/debug/routes")
        resp = conn.getresponse()
        assert resp.status == 200
        body = json.loads(resp.read())
    finally:
        conn.close()
    kv = body["serves"]["default/kvdbg"]["kv_directory"]
    row = kv["replicas"]["default/p-a"]
    assert row["digests"] > 0 and row["fresh"]
    assert {"bytes", "capacity_bytes", "cached_prefixes", "demotions", "restores"} <= set(row["host"])
    assert set(kv["lookups"]) == {"hit", "miss", "stale"}
