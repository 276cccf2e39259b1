"""The port's continuous-batching decode loop, held to the reference's.

The 16 flows of ``tests/test_decode_loop.py`` on the port's
``DecodeLoopExecutor`` over its ``PagedGptDecoder`` (tiny float32 GPT on
bridged parameters, ``_torch_serving``): wherever a flow generates, its
tokens equal a JAX executor's exactly (one of the same prefill chunk and
page size, which order the sums; a pool's size or an EOS id leaves them
alone); typed errors, outcome labels and metric families are the
reference's.

- slot reuse: a short request admitted later finishes first; served
  counts and budgets; mean occupancy above one;
- an admission stall on too few pages that still serves both, and a pool
  too small for ``max_len`` refused at start;
- the typed outcomes: an over-long prompt (``invalid``, not
  ``rejected``), a budget of 0, malformed payloads (``TypeError``), the
  bounded queue shedding ``Overloaded`` (``rejected``), draining;
- EOS retiring a row before its budget;
- the per-token metric families, a prefix hit whose last chunk overflows
  ``max_len`` into the trash page, the prefix-hit counter, and
  ``report_progress``.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_serving import (
    ThrottledDecoder,
    greedy,
    jax_decoder,
    jax_exec,
    port_decoder,
    port_exec,
    tokens,
    wait_until,
)
from tfk8s_tpu_torch.runtime.server import (
    DecodeLoopExecutor,
    Draining,
    InvalidRequest,
    Overloaded,
    ServeError,
)
from tfk8s_tpu_torch.utils.logging import Metrics
import _torch_threads  # noqa: F401  (torch's threads under xdist)

# the reference's overflow case: page 16, chunk 32, 16 pages, 2 slots
OVERFLOW = dict(slots=2, page_size=16, max_pages=16, gen_tokens=4, prefill_chunk=32)


@pytest.fixture(scope="module")
def decoder():
    return port_decoder()


@pytest.fixture(scope="module")
def ref():
    """The JAX executor of the default geometry (the tokens' reference)."""
    ex = jax_exec()
    yield ex
    ex.drain(10)


class TestSlotReuse:
    def test_short_request_admitted_later_finishes_first(self):
        loop = port_exec(port_decoder(ThrottledDecoder))
        try:
            order = []
            lock = threading.Lock()

            def run(name, n, g):
                loop.submit({"tokens": tokens(n, seed=n), "gen_tokens": g}, timeout=120)
                with lock:
                    order.append(name)

            with ThreadPoolExecutor(4) as pool:
                long_f = pool.submit(run, "long", 10, 48)
                assert wait_until(lambda: loop.live_slots >= 1)
                short_f = pool.submit(run, "short", 5, 2)
                short_f.result(timeout=120)
                long_f.result(timeout=120)
            assert order == ["short", "long"]
        finally:
            loop.drain(10)

    def test_served_counts_and_budgets(self, decoder, ref):
        loop = port_exec(decoder)
        payloads = [{"tokens": tokens(4 + i, seed=i), "gen_tokens": 3 + i} for i in range(6)]
        try:
            with ThreadPoolExecutor(8) as pool:
                futs = [pool.submit(loop.submit, p, 120) for p in payloads]
                outs = [f.result(timeout=120) for f in futs]
            for i, out in enumerate(outs):
                assert len(out["tokens"]) == 3 + i
                assert out["version"] == "seed:0"
                assert out["tokens"] == greedy(ref, payloads[i])
            assert loop.served_total == 6
        finally:
            loop.drain(10)

    def test_mean_occupancy_exceeds_one_under_concurrency(self, decoder):
        loop = port_exec(decoder)
        try:
            with ThreadPoolExecutor(4) as pool:
                futs = [pool.submit(loop.submit, {"tokens": tokens(6, seed=i), "gen_tokens": 24},
                                    120) for i in range(4)]
                [f.result(timeout=120) for f in futs]
            assert loop.mean_batch_occupancy > 1.5
        finally:
            loop.drain(10)


class TestAdmissionStall:
    def test_out_of_pages_stalls_admission_but_serves_eventually(self, ref):
        # 8 usable pages: one 40 + 16 request takes 7; the pool's size
        # leaves the numbers alone, so the default geometry's executor
        # gives the reference tokens
        loop = port_exec(port_decoder(ThrottledDecoder, max_pages=9))
        first = {"tokens": tokens(40, seed=1), "gen_tokens": 16}
        second = {"tokens": tokens(40, seed=2), "gen_tokens": 16}
        try:
            with ThreadPoolExecutor(2) as pool:
                f1 = pool.submit(loop.submit, first, 120)
                assert wait_until(lambda: loop.live_slots == 1)
                f2 = pool.submit(loop.submit, second, 120)
                assert wait_until(lambda: loop.queue_depth == 1)
                assert loop.live_slots == 1
                out1 = f1.result(timeout=120)
                out2 = f2.result(timeout=120)
            assert len(out1["tokens"]) == 16 and len(out2["tokens"]) == 16
            assert loop.submit(first, timeout=120)["tokens"] == out1["tokens"]
        finally:
            loop.drain(10)
        assert [greedy(ref, p) for p in (first, second)] == [out1["tokens"], out2["tokens"]]

    def test_pool_too_small_for_max_len_is_refused_at_startup(self):
        dec = port_decoder(slots=2, max_pages=4)  # max_len 64 needs 8 pages; 3 usable
        with pytest.raises(ServeError, match="max_pages"):
            DecodeLoopExecutor(dec, metrics=Metrics())


class TestTypedOutcomes:
    def test_overlong_prompt_is_invalid_with_own_outcome_label(self, decoder):
        m = Metrics()
        loop = port_exec(decoder, metrics=m)
        try:
            with pytest.raises(InvalidRequest):
                loop.submit({"tokens": tokens(60), "gen_tokens": 30}, timeout=5)
            assert m.get_counter("tfk8s_serving_requests_total", {"outcome": "invalid"}) == 1.0
            assert not m.get_counter("tfk8s_serving_requests_total", {"outcome": "rejected"})
        finally:
            loop.drain(10)

    def test_nonpositive_budget_is_invalid(self, decoder):
        loop = port_exec(decoder)
        try:
            with pytest.raises(InvalidRequest):
                loop.submit({"tokens": tokens(4), "gen_tokens": 0}, timeout=5)
        finally:
            loop.drain(10)

    def test_malformed_payload_is_typeerror(self, decoder):
        loop = port_exec(decoder)
        try:
            with pytest.raises(TypeError):
                loop.submit({"gen_tokens": 4}, timeout=5)
            with pytest.raises(TypeError):
                loop.submit(np.zeros((2, 2), np.int32), timeout=5)
        finally:
            loop.drain(10)

    def test_bounded_queue_sheds_with_typed_overload(self, decoder):
        m = Metrics()
        loop = port_exec(decoder, queue_limit=2, metrics=m, start=False)  # the queue only fills
        payload = {"tokens": tokens(4), "gen_tokens": 2}

        def fill():
            with pytest.raises(TimeoutError):
                loop.submit(payload, timeout=0.5)

        fillers = [threading.Thread(target=fill, daemon=True) for _ in range(2)]
        for t in fillers:
            t.start()
        assert wait_until(lambda: loop.queue_depth == 2, timeout=5)
        with pytest.raises(Overloaded) as exc:
            loop.submit(payload, timeout=0.5)
        assert (exc.value.queue_depth, exc.value.queue_limit) == (2, 2)
        assert m.get_counter("tfk8s_serving_requests_total", {"outcome": "rejected"}) == 1.0
        for t in fillers:
            t.join(timeout=5)

    def test_draining_rejects_new_but_finishes_queued(self, decoder, ref):
        loop = port_exec(decoder)
        payload = {"tokens": tokens(6), "gen_tokens": 4}
        results = []
        t = threading.Thread(target=lambda: results.append(loop.submit(payload, 120)), daemon=True)
        t.start()
        assert wait_until(lambda: loop.queue_depth or loop.live_slots or results, timeout=5)
        assert loop.drain(timeout=30)
        t.join(timeout=30)
        assert results and results[0]["tokens"] == greedy(ref, payload)
        with pytest.raises(Draining):
            loop.submit({"tokens": tokens(4), "gen_tokens": 2}, timeout=1)


class TestEos:
    def test_eos_retires_before_budget(self, ref):
        payload = {"tokens": tokens(8, seed=3), "gen_tokens": 16}
        probe = greedy(ref, payload)
        eos = probe[2]  # the third generated token acts as the stop token
        loop = port_exec(port_decoder(eos_id=int(eos)))
        try:
            out = loop.submit(payload, timeout=120)["tokens"]
            assert out == probe[: probe.index(eos) + 1]
            assert out[-1] == eos and len(out) < 16
        finally:
            loop.drain(10)


class TestMetrics:
    def test_per_token_families_are_exported(self, decoder):
        m = Metrics()
        loop = port_exec(decoder, metrics=m)
        try:
            out = loop.submit({"tokens": tokens(12, seed=9), "gen_tokens": 6}, timeout=120)
            assert len(out["tokens"]) == 6
            assert m.get_counter("tfk8s_serving_tokens_total") == 6.0
            assert m.get_counter("tfk8s_serving_requests_total", {"outcome": "ok"}) == 1.0
            assert 0.0 <= m.get_gauge("tfk8s_serving_slot_occupancy") <= 1.0
            assert 0.0 <= m.get_gauge("tfk8s_serving_page_occupancy") <= 1.0
        finally:
            loop.drain(10)

    def test_prefix_hit_with_overflowing_final_chunk_stays_correct(self):
        """A prefix hit starts the last chunk at base 48 of a 49-token
        prompt: its padded positions 64..79 must land in the trash page,
        not in the row's last real page."""
        loop = port_exec(port_decoder(**OVERFLOW))
        jloop = jax_exec(jax_decoder(**OVERFLOW))
        payload = {"tokens": tokens(49, seed=21), "gen_tokens": 4}
        try:
            first = loop.submit(payload, timeout=120)
            second = loop.submit(payload, timeout=120)
            assert loop.allocator.prefix_hits == 1
            assert second["tokens"] == first["tokens"] == greedy(jloop, payload)
        finally:
            loop.drain(10)
            jloop.drain(10)

    def test_non_int_gen_tokens_is_typeerror(self, decoder):
        loop = port_exec(decoder)
        try:
            with pytest.raises(TypeError):
                loop.submit({"tokens": tokens(4), "gen_tokens": "lots"}, timeout=5)
        finally:
            loop.drain(10)

    def test_prefix_cache_hit_counter(self, decoder, ref):
        m = Metrics()
        loop = port_exec(decoder, metrics=m)
        payload = {"tokens": tokens(20, seed=11), "gen_tokens": 2}
        try:
            outs = [loop.submit(payload, timeout=120)["tokens"] for _ in range(2)]
            assert m.get_counter("tfk8s_serving_prefix_cache_hits_total") == 1.0
            assert loop.allocator.prefix_hits == 1
            assert outs == [greedy(ref, payload)] * 2
        finally:
            loop.drain(10)

    def test_report_progress_keeps_model_server_contract(self, decoder):
        loop = port_exec(decoder)
        try:
            loop.submit({"tokens": tokens(6), "gen_tokens": 2}, timeout=120)
            values = loop.report_progress()
            for key in ("serving_ready", "serving_queue_depth", "serving_qps",
                        "serving_batch_occupancy", "serving_requests"):
                assert key in values
            assert values["serving_ready"] == 1.0
            assert values["serving_tokens"] >= 2.0
        finally:
            loop.drain(10)
