"""The port's host and peer KV tiers against the JAX package's executor.

The port's ``DecodeLoopExecutor`` over its torch ``PagedGptDecoder``, and
the reference's executor over the JAX decoder, load the same bridged
parameters (tiny config, float32, on the CPU), as ``test_torch_serve.py``
does; the flows are the reference's ``tests/test_kv_tier.py`` with the
tokens of every flow held exactly to a JAX executor's run of the same
request:

- host tier: on a tight 16-page port pool an idle prefix is demoted to
  host memory and restored, generating the reference's tokens; the
  device and host evictions land on their counters; a corrupt host entry
  costs a plain prefill (the same tokens), counts ``restore_failed`` and
  is dropped;
- peer tier: a warm prefix pulled across backends, JAX -> port and
  port -> JAX (``outcome=ok``, the source's ``kv_peer_serves``), gives the
  source's tokens; a foreign digest chain is refused (the identity gate
  of ``kvtier.fetch_prefix``) and costs a fallback prefill.
"""

import hashlib

import pytest

from _torch_serving import PAGE, jax_exec, port_exec, tokens
from tfk8s_tpu_torch.runtime import kvtier as tkvtier
from tfk8s_tpu_torch.runtime.handoff import HandoffError, KVHandoffBuffer
from tfk8s_tpu_torch.runtime.paging import prefix_digest_chain


def _port_exec(max_pages=64, **kw):
    return port_exec(geometry={"max_pages": max_pages}, **kw)


def _churn(ex, n, seed0, plen=PAGE * 3):
    """Distinct multi-page prompts that fill and roll a 16-page pool."""
    for i in range(n):
        ex.submit({"tokens": tokens(plen, seed=seed0 + i), "gen_tokens": 4}, timeout=60)


@pytest.fixture(scope="module")
def tight():
    """A port executor with a tight device pool and a roomy host tier, and
    the reference's executor for the uninterrupted tokens."""
    ex, ref = _port_exec(max_pages=16, kv_host_bytes=8 << 20), jax_exec()
    yield ex, ref
    ex.drain(10)
    ref.drain(10)


def test_demote_then_restore_gives_the_reference_tokens(tight):
    ex, ref = tight
    payload = {"tokens": tokens(PAGE * 3, seed=500), "gen_tokens": 6}
    want = ref.submit(payload, timeout=60)["tokens"]
    assert ex.submit(payload, timeout=60)["tokens"] == want
    demotions0 = ex.debug_state()["kv_host"]["demotions"]
    _churn(ex, 8, seed0=510)
    st = ex.debug_state()
    assert st["kv_host"]["demotions"] > demotions0
    restores0 = st["kv_host"]["restores"]
    assert ex.submit(payload, timeout=60)["tokens"] == want
    assert ex.debug_state()["kv_host"]["restores"] > restores0


def test_eviction_counters_on_both_tiers(tight):
    ex, _ = tight
    _churn(ex, 4, seed0=560)
    st = ex.debug_state()
    assert st["prefix_cache"]["evictions_device"] > 0
    assert ex.metrics.get_counter("tfk8s_serving_prefix_cache_evictions_total",
                                  {"tier": "device"}) == float(st["prefix_cache"]["evictions_device"])
    assert ex.metrics.get_counter("tfk8s_serving_kv_host_ops_total",
                                  {"op": "demote"}) == float(st["kv_host"]["demotions"])
    # a host budget of ~2 entries overflows through the executor's on_evict
    host = _port_exec(max_pages=16, kv_host_bytes=64 << 20)
    try:
        _churn(host, 10, seed0=600)
        nbytes = max(len(w) for w, _a, _s in host._kv_host._entries.values())
        host._kv_host.capacity_bytes = int(2.5 * nbytes)
        _churn(host, 8, seed0=640)
        evictions = host.debug_state()["kv_host"]["evictions"]
        assert evictions > 0
        assert host.metrics.get_counter("tfk8s_serving_prefix_cache_evictions_total",
                                        {"tier": "host"}) == float(evictions)
    finally:
        host.drain(10)


def test_corrupt_host_entry_falls_back_and_is_dropped(tight):
    ex, ref = tight
    prompt = tokens(PAGE * 3, seed=700)
    payload = {"tokens": prompt, "gen_tokens": 6}
    want = ref.submit(payload, timeout=60)["tokens"]
    ex.submit(payload, timeout=60)
    _churn(ex, 8, seed0=710)
    entries, tampered = ex._kv_host._entries, []
    for key in prefix_digest_chain([int(t) for t in prompt], PAGE, len(prompt) // PAGE):
        if key in entries:
            wire, akey, checksum = entries[key]
            # flipped K/V bytes under the stale checksum: a host-RAM bit flip
            entries[key] = (wire[:-3] + b"\xff\xff\xff", akey, checksum)
            tampered.append(key)
    assert tampered
    assert ex.submit(payload, timeout=60)["tokens"] == want
    assert (ex.metrics.get_counter("tfk8s_serving_kv_host_ops_total",
                                   {"op": "restore_failed"}) or 0) > 0
    for key in tampered:
        if ex._kv_host.has(key):  # re-demoted since: clean
            w, _a, s = ex._kv_host._entries[key]
            assert hashlib.sha256(w).digest() == s


@pytest.fixture(scope="module")
def peers():
    """A port and a JAX replica, each with peer fetch on, resolving each
    other through one dict."""
    registry = {}
    registry["P"] = _port_exec(kv_host_bytes=8 << 20, kv_peer_fetch=True,
                               kv_peer_resolve=registry.get)
    registry["J"] = jax_exec(kv_host_bytes=8 << 20, kv_peer_fetch=True,
                              kv_peer_resolve=registry.get)
    yield registry
    for ex in registry.values():
        ex.drain(10)


@pytest.mark.parametrize("source,dest,seed", [("J", "P", 900), ("P", "J", 950)])
def test_peer_fetch_crosses_backends(peers, source, dest, seed):
    """The destination pulls the source's warm pages through the wire
    bytes and generates the source's tokens, a prefix-cache hit."""
    src, dst = peers[source], peers[dest]
    payload = {"tokens": tokens(PAGE * 3, seed=seed), "gen_tokens": 6}
    want = src.submit(dict(payload), timeout=60)["tokens"]
    serves0, hits0 = src.kv_peer_serves, dst.debug_state()["prefix_cache"]["hits"]
    ok0 = dst.metrics.get_counter("tfk8s_serving_kv_peer_fetches_total",
                                  {"outcome": "ok"}) or 0
    assert dst.submit(dict(payload), timeout=60, kv_peer=source)["tokens"] == want
    assert src.kv_peer_serves == serves0 + 1
    assert dst.debug_state()["prefix_cache"]["hits"] == hits0 + 1
    assert dst.metrics.get_counter("tfk8s_serving_kv_peer_fetches_total",
                                   {"outcome": "ok"}) == ok0 + 1


def test_tampered_digest_chain_is_refused(peers):
    """A peer that answers with another prompt's self-consistent pages:
    ``fetch_prefix`` refuses the foreign chain, and the port replica's
    request falls back to a plain prefill with the reference's tokens."""
    port, ref = peers["P"], peers["J"]
    warm = [int(t) for t in tokens(PAGE * 2, seed=911)]
    ref.submit({"tokens": warm, "gen_tokens": 2}, timeout=60)

    class _ForeignPeer:
        def export_prefix(self, toks):
            return ref.export_prefix(warm)

    peers["F"] = _ForeignPeer()
    try:
        prompt = tokens(PAGE * 2, seed=912)
        with pytest.raises(HandoffError, match="foreign"):
            tkvtier.fetch_prefix(peers.get, "F", [int(t) for t in prompt])
        assert isinstance(tkvtier.fetch_prefix(peers.get, "J", warm), KVHandoffBuffer)
        payload = {"tokens": prompt, "gen_tokens": 6}
        want = ref.submit(dict(payload), timeout=60)["tokens"]
        fb0 = port.metrics.get_counter("tfk8s_serving_kv_peer_fetches_total",
                                       {"outcome": "fallback"}) or 0
        assert port.submit(dict(payload), timeout=60, kv_peer="F")["tokens"] == want
        assert port.metrics.get_counter("tfk8s_serving_kv_peer_fetches_total",
                                        {"outcome": "fallback"}) == fb0 + 1
    finally:
        del peers["F"]
