"""Fault containment in the port's decode loop, held to the reference's.

The flows of ``tests/test_fault_containment.py`` on the port's
``PageAllocator`` and ``DecodeLoopExecutor`` (tiny float32 GPT on bridged
parameters, ``_torch_serving``):

- quarantine: a faulted row's pages stay out of the free list and the
  prefix cache until verified, a shared page diverts at its last release;
- a poisoned row retires typed ``RowFault`` while its siblings stay
  bit-identical to a clean batch and equal the JAX executor's tokens;
- quarantined pages survive allocation churn;
- ``chaos_crash`` fails everything typed ``ReplicaUnavailable`` and goes
  non-Ready, and ``chaos_wire_reset`` fails in-flight requests while the
  replica keeps serving;
- the port's ``chaos_crash_replica`` crashes a registered replica and
  leaves it registered; behind ``AgentReplica`` the corpse refuses with
  the agent's ``ReplicaUnavailable``;
- F7: a chaos hook that lands while a row is mid-prefill (another thread
  failing the rows the loop is stepping) neither kills a replica that a
  wire reset should leave serving nor replaces a crash's fault with an
  error of its own.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from _torch_serving import (
    ThrottledDecoder,
    agent,
    greedy,
    jax_exec,
    port_decoder,
    port_exec,
    tokens,
    wait_until,
)
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.paging import PageAllocator
from tfk8s_tpu_torch.runtime.server import PagedGptDecoder, ReplicaUnavailable, RowFault
from tfk8s_tpu_torch.utils.logging import Metrics
import _torch_threads  # noqa: F401  (torch's threads under xdist)


class TestQuarantine:
    def test_quarantine_holds_pages_out_of_the_free_list(self):
        a = PageAllocator(num_pages=8, page_size=4, prefix_cache=False)
        lease = a.admit(list(range(6)), gen_budget=6)  # 3 pages
        for _ in range(lease.reserved):
            a.extend(lease)
        free_before_fault = a.free_pages
        assert a.quarantine(lease) == 3
        assert a.quarantined_pages == 3
        assert a.free_pages == free_before_fault
        assert lease.pages == []

    def test_verify_returns_quarantined_pages_to_circulation(self):
        a = PageAllocator(num_pages=8, page_size=4, prefix_cache=False)
        lease = a.admit(list(range(6)), gen_budget=6)
        for _ in range(lease.reserved):
            a.extend(lease)
        a.quarantine(lease)
        free_held = a.free_pages
        assert a.verify_quarantined() == 3
        assert a.quarantined_pages == 0
        assert a.free_pages == free_held + 3

    def test_tainted_shared_page_diverts_at_final_release(self):
        a = PageAllocator(num_pages=16, page_size=4)
        prompt = list(range(10, 22))  # 12 tokens -> 2 full reusable pages
        l1 = a.admit(prompt, gen_budget=4)
        for _ in range(l1.reserved):
            a.extend(l1)
        a.register_prefix(prompt, l1)
        l2 = a.admit(prompt, gen_budget=4)
        assert l2.cached_pages == 2
        shared = list(l2.pages[:2])
        a.quarantine(l1)  # l1 faulted; l2 still holds the shared pages
        assert a.quarantined_pages >= 2
        free_before = a.free_pages
        a.release(l2)  # the last holder releases: divert, do not free
        for pid in shared:
            assert pid in a._quarantined
        assert a.free_pages == free_before
        assert a.verify_quarantined() >= 2

    def test_quarantine_unpublishes_the_prefix(self):
        a = PageAllocator(num_pages=16, page_size=4)
        prompt = list(range(50, 62))
        lease = a.admit(prompt, gen_budget=4)
        for _ in range(lease.reserved):
            a.extend(lease)
        a.register_prefix(prompt, lease)
        assert a.match_prefix(prompt)[1] > 0
        a.quarantine(lease)
        assert a.match_prefix(prompt) == ([], 0)


@pytest.fixture(scope="module")
def decoder():
    return port_decoder()


@pytest.fixture(scope="module")
def ref():
    ex = jax_exec()
    yield ex
    ex.drain(10)


def prompts(seeds, n=6):
    return [tokens(n, seed=s) for s in seeds]


def run_batch(loop, batch, gen=5):
    """Submit every prompt at once; (outputs, errors) keyed by index."""
    outs, errs = {}, {}

    def one(i, toks):
        try:
            outs[i] = loop.submit({"tokens": toks, "gen_tokens": gen}, timeout=120)
        except Exception as e:  # noqa: BLE001 — the test types them
            errs[i] = e

    with ThreadPoolExecutor(len(batch)) as pool:
        for f in [pool.submit(one, i, t) for i, t in enumerate(batch)]:
            f.result(timeout=120)
    return outs, errs


class TestSingleRowIsolation:
    def test_poisoned_row_retires_typed_siblings_bit_identical(self, decoder, ref):
        batch = prompts([101, 102, 103])
        metrics = Metrics()
        loop = port_exec(decoder, metrics=metrics)
        try:
            baseline, errs = run_batch(loop, batch)
            assert not errs
            quarantined_before = loop.allocator.quarantined_pages
            loop.chaos_poison_row(batch[1])
            outs, errs = run_batch(loop, batch)
            assert set(errs) == {1}
            assert isinstance(errs[1], RowFault)
            assert "quarantined" in str(errs[1])
            for i in (0, 2):
                assert outs[i]["tokens"] == baseline[i]["tokens"]
                assert outs[i]["tokens"] == greedy(ref, {"tokens": batch[i], "gen_tokens": 5})
            assert loop.allocator.quarantined_pages > quarantined_before
            assert metrics.get_counter("tfk8s_serving_rows_quarantined_total", loop.labels) == 1.0
            assert loop.fault is None
            assert loop.report_progress()["serving_ready"] == 1.0
        finally:
            loop.drain(10)

    def test_quarantined_pages_survive_allocation_churn(self, decoder):
        loop = port_exec(decoder)
        a = loop.allocator
        try:
            victim = prompts([7], n=10)[0]
            loop.chaos_poison_row(victim)
            _, errs = run_batch(loop, [victim])
            assert isinstance(errs[0], RowFault)
            held = a.quarantined_pages
            assert held > 0
            frozen = set(a._quarantined)
            outs, errs = run_batch(loop, prompts(range(8)))
            assert not errs and len(outs) == 8
            assert set(a._quarantined) == frozen
            assert a.quarantined_pages == held
            assert a.verify_quarantined() > 0
            assert a.quarantined_pages == len(a._tainted)
        finally:
            loop.drain(10)


def _inflight(loop, seed):
    """One 40-token request running on ``loop``; (thread, errors)."""
    errs = []

    def run():
        try:
            loop.submit({"tokens": prompts([seed], n=8)[0], "gen_tokens": 40}, timeout=120)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert wait_until(lambda: loop.live_slots >= 1)
    return t, errs


@pytest.fixture(scope="module")
def slow_decoder():
    return port_decoder(ThrottledDecoder)


class TestGlobalFaults:
    def test_chaos_crash_fails_everything_typed_and_goes_non_ready(self, slow_decoder):
        loop = port_exec(slow_decoder)
        t, errs = _inflight(loop, 1)
        loop.chaos_crash()
        t.join(timeout=30)
        assert len(errs) == 1 and isinstance(errs[0], ReplicaUnavailable)
        with pytest.raises(ReplicaUnavailable):
            loop.submit({"tokens": prompts([2], n=4)[0], "gen_tokens": 2}, timeout=5)
        assert loop.fault is not None
        assert loop.report_progress()["serving_ready"] == 0.0

    def test_chaos_wire_reset_fails_inflight_but_replica_keeps_serving(self, slow_decoder, ref):
        loop = port_exec(slow_decoder)
        try:
            t, errs = _inflight(loop, 3)
            loop.chaos_wire_reset()
            t.join(timeout=30)
            assert len(errs) == 1 and isinstance(errs[0], ReplicaUnavailable)
            payload = {"tokens": prompts([4], n=4)[0], "gen_tokens": 3}
            assert loop.submit(payload, timeout=60)["tokens"] == greedy(ref, payload)
            assert loop.fault is None
            assert loop.report_progress()["serving_ready"] == 1.0
        finally:
            loop.drain(10)

    def test_chaos_crash_replica_keeps_the_corpse_registered(self, slow_decoder):
        """The port's module-level chaos entry, as the reference's: the
        in-flight request fails typed, the corpse stays in the table, and
        behind ``AgentReplica`` it refuses with the agent's class."""
        key = "default/chaos-crash-replica"
        loop = port_exec(slow_decoder)
        tserver.register_replica(key, loop)
        try:
            assert tserver.chaos_crash_replica("default/not-registered") is False
            t, errs = _inflight(loop, 5)
            assert tserver.chaos_crash_replica(key, message="chaos: test kill") is True
            t.join(timeout=30)
            assert len(errs) == 1 and isinstance(errs[0], ReplicaUnavailable)
            assert "chaos: test kill" in str(errs[0])
            assert tserver.lookup_replica(key) is loop
            assert loop.report_progress()["serving_ready"] == 0.0
            with pytest.raises(jserver.ReplicaUnavailable):
                agent(loop).submit({"tokens": prompts([6], n=4)[0], "gen_tokens": 2}, timeout=5)
        finally:
            tserver.unregister_replica(key)


class SlowPrefillDecoder(PagedGptDecoder):
    """Prefill chunk rounds slowed, so a chaos hook lands mid-prefill."""

    chunk_sleep_s = 0.05

    def prefill_batch(self, batch, samp=None):
        time.sleep(self.chunk_sleep_s)
        return super().prefill_batch(batch, samp)


@pytest.fixture(scope="module")
def slow_prefill_decoder():
    return port_decoder(SlowPrefillDecoder)


class TestChaosMidPrefill:
    """F7: a 60-token prompt prefills in four throttled chunk rounds; the
    hook fires once the row is admitted, from the caller's thread."""

    def _mid_prefill(self, loop, hook):
        errs = []

        def run():
            try:
                loop.submit({"tokens": prompts([9], n=60)[0], "gen_tokens": 2}, timeout=120)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert wait_until(lambda: loop.live_slots >= 1)
        hook()
        t.join(timeout=30)
        assert len(errs) == 1 and isinstance(errs[0], ReplicaUnavailable)

    def test_wire_reset_mid_prefill_keeps_the_replica_serving(self, slow_prefill_decoder, ref):
        loop = port_exec(slow_prefill_decoder)
        try:
            self._mid_prefill(loop, loop.chaos_wire_reset)
            payload = {"tokens": prompts([10], n=4)[0], "gen_tokens": 3}
            assert loop.submit(payload, timeout=60)["tokens"] == greedy(ref, payload)
            assert loop.fault is None
            assert loop.report_progress()["serving_ready"] == 1.0
        finally:
            loop.drain(10)

    def test_crash_mid_prefill_keeps_its_own_fault(self, slow_prefill_decoder):
        loop = port_exec(slow_prefill_decoder)
        self._mid_prefill(loop, lambda: loop.chaos_crash("chaos: host died mid-prefill"))
        loop._thread.join(timeout=30)
        assert not loop._thread.is_alive()
        assert isinstance(loop.fault, ReplicaUnavailable)
        assert "mid-prefill" in str(loop.fault)
