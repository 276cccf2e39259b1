"""The port's slot-per-batch executor (``ModelServer``) and its served
models, against the contract and the numbers of the JAX package's.

The first half is the reference's executor contract
(``tests/test_serving_executor.py``) run on the port's ``ModelServer``:
a batch closes on size or timeout, buckets never mix, the bounded queue
sheds with the typed overload error, drain finishes what was accepted,
and the latency histograms observe every served request exactly once.
The second half holds the served models to the reference's on the same
bridged parameters (tiny config, float32, on the CPU): ``GptGenerator``
tokens and ``MlpClassifier`` labels are equal; and ``serve`` runs
``echo``, ``mlp`` and ``gpt`` with ``TFK8S_SERVE_DECODE_LOOP=0``.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.models import mlp as jmlp
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.server import (
    Draining,
    EchoModel,
    GptGenerator,
    InvalidRequest,
    ModelServer,
    Overloaded,
    RequestFailed,
    ServedModel,
)
from tfk8s_tpu_torch.utils.logging import Metrics
import _torch_threads  # noqa: F401  (torch's threads under xdist)


class RecordingModel(ServedModel):
    """Test model: records every executed batch (payloads + bucket), with
    an optional gate that blocks execution until released — which lets a
    test wedge the executor and fill the queue deterministically."""

    version = "rec"

    def __init__(self, gate: threading.Event = None):
        self.batches = []
        self.gate = gate
        self.fail_batches = 0

    def load(self):
        pass

    def bucket_of(self, payload):
        # payloads are (shape_key, value) tuples; the key is the bucket
        return payload[0]

    def forward(self, payloads):
        if self.gate is not None:
            self.gate.wait(10)
        if self.fail_batches > 0:
            self.fail_batches -= 1
            raise RuntimeError("injected model failure")
        self.batches.append(list(payloads))
        return [("ok", p) for p in payloads]


def make_server(model=None, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_timeout_s", 0.05)
    kw.setdefault("queue_limit", 8)
    kw.setdefault("metrics", Metrics())
    return ModelServer(model or RecordingModel(), **kw).start()


class TestBatchClose:
    def test_batch_closes_on_size_before_timeout(self):
        model = RecordingModel()
        # a LONG timeout: only the size bound can close the batch quickly
        s = make_server(model, max_batch_size=4, batch_timeout_s=5.0)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(s.submit, ("a", i)) for i in range(4)]
            for f in futs:
                f.result(timeout=10)
        elapsed = time.perf_counter() - t0
        assert elapsed < 2.0, "size-full batch must not wait out the timeout"
        assert s.batches_total >= 1
        # all four landed in at most two batches (the first may have
        # closed with whatever was queued when the batcher woke)
        assert s.served_total == 4
        assert s.drain()

    def test_batch_closes_on_timeout_when_underfull(self):
        model = RecordingModel()
        s = make_server(model, max_batch_size=8, batch_timeout_s=0.03)
        out = s.submit(("a", 1), timeout=5)
        assert out == ("ok", ("a", 1))
        assert s.batches_total == 1 and s.served_total == 1
        assert model.batches == [[("a", 1)]]
        assert s.drain()

    def test_zero_timeout_serves_immediately(self):
        s = make_server(RecordingModel(), batch_timeout_s=0.0)
        assert s.submit(("a", 1), timeout=5) == ("ok", ("a", 1))
        assert s.drain()


class TestBucketing:
    def test_incompatible_buckets_never_share_a_batch(self):
        model = RecordingModel()
        s = make_server(model, max_batch_size=8, batch_timeout_s=0.05,
                        queue_limit=64)
        with ThreadPoolExecutor(16) as ex:
            futs = [
                ex.submit(s.submit, (("shape-a" if i % 2 else "shape-b"), i))
                for i in range(32)
            ]
            for f in futs:
                f.result(timeout=10)
        assert s.drain()
        assert sum(len(b) for b in model.batches) == 32
        for batch in model.batches:
            kinds = {p[0] for p in batch}
            assert len(kinds) == 1, f"mixed buckets in one batch: {kinds}"

    def test_non_head_bucket_keeps_queue_position(self):
        """Requests of another bucket left behind by a batch are served by
        subsequent batches, FIFO."""
        gate = threading.Event()
        model = RecordingModel(gate)
        s = make_server(model, max_batch_size=2, batch_timeout_s=0.01,
                        queue_limit=16)
        with ThreadPoolExecutor(6) as ex:
            f_a = [ex.submit(s.submit, ("a", i)) for i in range(2)]
            time.sleep(0.05)  # wedge: the a-batch is blocked in forward()
            f_b = [ex.submit(s.submit, ("b", i)) for i in range(2)]
            f_a2 = [ex.submit(s.submit, ("a", 10 + i)) for i in range(2)]
            gate.set()
            for f in f_a + f_b + f_a2:
                f.result(timeout=10)
        assert s.drain()
        assert sum(len(b) for b in model.batches) == 6

    def test_bad_payload_rejected_at_submit(self):
        class Picky(ServedModel):
            version = "p"

            def load(self):
                pass

            def bucket_of(self, payload):
                raise TypeError("wrong shape")

            def forward(self, payloads):
                return payloads

        s = make_server(Picky())
        with pytest.raises(TypeError):
            s.submit(object())
        assert s.drain()


class TestBackpressure:
    def test_bounded_queue_sheds_with_typed_overload(self):
        gate = threading.Event()
        model = RecordingModel(gate)
        s = make_server(model, max_batch_size=1, batch_timeout_s=0.0,
                        queue_limit=4)
        # wedge the executor (its batch blocks in forward), then fill the
        # queue past the bound
        results = []
        with ThreadPoolExecutor(8) as ex:
            first = ex.submit(s.submit, ("a", 0))
            time.sleep(0.05)
            queued = [ex.submit(s.submit, ("a", 1 + i)) for i in range(4)]
            time.sleep(0.05)
            with pytest.raises(Overloaded) as exc_info:
                s.submit(("a", 99))
            assert exc_info.value.queue_limit == 4
            assert exc_info.value.queue_depth == 4
            gate.set()
            results = [f.result(timeout=10) for f in [first] + queued]
        assert len(results) == 5
        assert s.rejected_total == 1
        m = s.metrics.snapshot()
        rejected = {
            k: v for k, v in m["counters"].items()
            if "requests_total" in k and 'outcome="rejected"' in k
        }
        assert sum(rejected.values()) == 1
        assert s.drain()

    def test_draining_rejects_new_but_finishes_queued(self):
        gate = threading.Event()
        model = RecordingModel(gate)
        s = make_server(model, max_batch_size=1, batch_timeout_s=0.0,
                        queue_limit=16)
        with ThreadPoolExecutor(4) as ex:
            inflight = [ex.submit(s.submit, ("a", i)) for i in range(3)]
            time.sleep(0.05)
            drainer = ex.submit(s.drain, 10)
            time.sleep(0.05)
            with pytest.raises(Draining):
                s.submit(("a", 99))
            gate.set()
            # every ACCEPTED request completes even though drain started
            assert [f.result(timeout=10) for f in inflight]
            assert drainer.result(timeout=10) is True


class TestMetricsContract:
    def test_histograms_observe_every_served_request_exactly_once(self):
        metrics = Metrics()
        model = RecordingModel()
        s = make_server(model, max_batch_size=4, batch_timeout_s=0.01,
                        queue_limit=64, metrics=metrics,
                        labels={"serve": "t"})
        n = 23
        with ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(s.submit, ("a", i)) for i in range(n)]
            for f in futs:
                f.result(timeout=10)
        assert s.drain()
        snap = metrics.snapshot()
        for fam in ("tfk8s_serving_queue_seconds",
                    "tfk8s_serving_execute_seconds",
                    "tfk8s_serving_request_seconds"):
            counts = [
                v["count"] for k, v in snap["histograms"].items()
                if k.startswith(fam)
            ]
            assert sum(counts) == n, (fam, snap["histograms"])
        ok = [
            v for k, v in snap["counters"].items()
            if "requests_total" in k and 'outcome="ok"' in k
        ]
        assert sum(ok) == n

    def test_shed_requests_are_counted_but_never_observed(self):
        metrics = Metrics()
        gate = threading.Event()
        model = RecordingModel(gate)
        s = make_server(model, max_batch_size=1, batch_timeout_s=0.0,
                        queue_limit=1, metrics=metrics)
        with ThreadPoolExecutor(4) as ex:
            first = ex.submit(s.submit, ("a", 0))
            time.sleep(0.05)
            second = ex.submit(s.submit, ("a", 1))
            time.sleep(0.05)
            with pytest.raises(Overloaded):
                s.submit(("a", 2))
            gate.set()
            first.result(timeout=10), second.result(timeout=10)
        assert s.drain()
        snap = metrics.snapshot()
        total_observed = sum(
            v["count"] for k, v in snap["histograms"].items()
            if k.startswith("tfk8s_serving_request_seconds")
        )
        assert total_observed == 2  # the served ones; the shed one never

    def test_model_failure_fans_out_and_counts_errors(self):
        metrics = Metrics()
        model = RecordingModel()
        model.fail_batches = 1
        s = make_server(model, max_batch_size=2, batch_timeout_s=0.05,
                        metrics=metrics)
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(s.submit, ("a", i)) for i in range(2)]
            errs = 0
            for f in futs:
                try:
                    f.result(timeout=10)
                except RequestFailed:
                    errs += 1
        assert errs == 2
        snap = metrics.snapshot()
        err_counts = [
            v for k, v in snap["counters"].items()
            if "requests_total" in k and 'outcome="error"' in k
        ]
        assert sum(err_counts) == 2
        # failed requests are not observed in the latency histograms
        assert not any(
            k.startswith("tfk8s_serving_request_seconds")
            for k in snap["histograms"]
        )
        # the server survives: the next request serves normally
        assert s.submit(("a", 7), timeout=10) == ("ok", ("a", 7))
        assert s.drain()


class TestOccupancy:
    def test_mean_batch_occupancy_tracks_batches(self):
        model = EchoModel("v", delay_ms=5)
        model.load()
        s = make_server(model, max_batch_size=8, batch_timeout_s=0.02,
                        queue_limit=128)
        with ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(s.submit, float(i)) for i in range(64)]
            for f in futs:
                f.result(timeout=30)
        assert s.served_total == 64
        assert s.mean_batch_occupancy > 1.0, (
            "concurrent load against a 5ms model must batch"
        )
        report = s.report_progress()
        assert report["serving_ready"] == 1.0
        assert report["serving_batch_occupancy"] == s.mean_batch_occupancy
        assert s.drain()


class TestInvalidRequests:
    """An unservable-by-contract request (e.g. a
    prompt whose generation budget overflows max_len) is a TYPED,
    client-visible InvalidRequest with its own outcome label — not a
    bare TypeError that reads as a malformed payload."""

    class OverlongModel(ServedModel):
        version = "v"

        def load(self):
            pass

        def bucket_of(self, payload):
            
            if payload == "overlong":
                raise InvalidRequest("prompt exceeds max_len")
            if payload == "malformed":
                raise TypeError("not a token array")
            return "b"

        def forward(self, payloads):
            return [("ok", p) for p in payloads]

    def test_invalid_counts_its_own_outcome_and_reraises(self):
        
        m = Metrics()
        s = make_server(self.OverlongModel(), metrics=m)
        with pytest.raises(InvalidRequest):
            s.submit("overlong", timeout=1)
        assert m.get_counter(
            "tfk8s_serving_requests_total", {"outcome": "invalid"}
        ) == 1.0
        # malformed payloads stay TypeError and are NOT counted invalid
        with pytest.raises(TypeError):
            s.submit("malformed", timeout=1)
        assert m.get_counter(
            "tfk8s_serving_requests_total", {"outcome": "invalid"}
        ) == 1.0
        # the executor still serves after rejecting
        assert s.submit("fine", timeout=5) == ("ok", "fine")
        assert s.drain()

    def test_gpt_generator_overlong_is_invalid(self):
        """The real GptGenerator raises the typed error from bucket_of
        once prompt + gen_tokens exceeds the model's max_len."""
        g = GptGenerator("seed:0", max_batch_size=2, gen_tokens=16,
                         size="tiny", device="cpu")
        g.load()  # params only; no forward compile needed for bucket_of
        assert g.bucket_of(np.ones(8, np.int32)) == ("gpt", 8)
        with pytest.raises(InvalidRequest):
            g.bucket_of(np.ones(60, np.int32))  # 60 + 16 > max_len 64
        with pytest.raises(TypeError):
            g.bucket_of(np.ones((2, 2), np.int32))  # malformed stays TypeError


# ---------------------------------------------------------------------------
# The served models against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt_pair():
    """(reference GptGenerator, port GptGenerator) on one flax init,
    bridged, both computing in float32."""
    jcfg = jgpt.tiny_config(dtype=jnp.float32)
    params = unbox(jgpt.make_task(cfg=jcfg, seq_len=8, batch_size=1).init(jax.random.key(0)))
    params = jax.tree_util.tree_map(np.asarray, params)
    ref = jserver.GptGenerator("seed:0", max_batch_size=4, gen_tokens=6, size="tiny")
    ref.load()
    ref._params = params  # the same weights, float32 compute
    ref._cfg = jcfg
    tcfg = tgpt.tiny_config(dtype=torch.float32)
    port = GptGenerator("seed:0", max_batch_size=4, gen_tokens=6, cfg=tcfg, device="cpu")
    port.load()
    port.module.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    return ref, port


@pytest.mark.parametrize("plen,rows", [(5, 1), (9, 3), (12, 4)])
def test_gpt_generator_tokens_equal_the_reference(gpt_pair, plen, rows):
    """A bucket of ``rows`` prompts (padded to the batch with row 0): the
    same tokens and version, row for row."""
    ref, port = gpt_pair
    prompts = list(np.random.default_rng(plen).integers(1, 64, (rows, plen)).astype(np.int32))
    assert port.bucket_of(prompts[0]) == ref.bucket_of(prompts[0]) == ("gpt", plen)
    assert port.forward(prompts) == ref.forward(prompts)


def test_mlp_classifier_labels_equal_the_reference():
    ref = jserver.MlpClassifier("seed:0", max_batch_size=8, hidden=64)
    ref.load()
    params = jax.tree_util.tree_map(np.asarray, ref._params)
    port = tserver.MlpClassifier("seed:0", max_batch_size=8, hidden=64, device="cpu")
    port.load()
    port.module.load_state_dict(bridge.mlp_params_to_state_dict(params))
    x = list(jmlp.make_batch(np.random.default_rng(1), 5)["image"])
    assert port.bucket_of(x[0]) == ref.bucket_of(x[0])
    assert port.forward(x) == ref.forward(x)
    with pytest.raises(TypeError):
        port.bucket_of(np.zeros((2, 784)))


def test_make_model_builds_each_task_and_refuses_an_unknown_one():
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_GEN_TOKENS": "3",
           "TFK8S_SERVE_ECHO_DELAY_MS": "1", "TFK8S_SERVE_MLP_HIDDEN": "32"}
    echo = tserver.make_model("echo", "", 4, env)
    assert isinstance(echo, EchoModel) and echo.delay_ms == 1.0 and echo.version == "echo"
    mlp = tserver.make_model("mlp", "seed:0", 4, env)
    assert isinstance(mlp, tserver.MlpClassifier) and mlp.hidden == 32
    for task in ("gpt", "t5"):
        gen = tserver.make_model(task, "seed:0", 4, env)
        assert isinstance(gen, GptGenerator) and gen.gen_tokens == 3
    with pytest.raises(tserver.ServeError, match="unknown serve task"):
        tserver.make_model("bogus", "", 4, env)


def _serve_and_submit(env, payloads):
    """``serve(env, stop)`` on a thread; submit ``payloads`` concurrently,
    then stop it (it drains); returns the replies and the server."""
    key = f"default/{env['TFK8S_POD_NAME']}"
    stop, errors = threading.Event(), []

    def entry():
        try:
            tserver.serve(env, stop)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    thread = threading.Thread(target=entry, daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while tserver.lookup_replica(key) is None:
        assert not errors and time.monotonic() < deadline, errors
        time.sleep(0.01)
    replica = tserver.lookup_replica(key)
    try:
        with ThreadPoolExecutor(len(payloads)) as ex:
            replies = list(ex.map(lambda p: replica.submit(p, timeout=30), payloads))
    finally:
        stop.set()
        thread.join(30)
    assert not errors and not thread.is_alive(), errors
    assert tserver.lookup_replica(key) is None
    return replies, replica


def test_serve_runs_echo_mlp_and_the_legacy_gpt_executor():
    base = {"TFK8S_DEVICE": "cpu", "TFK8S_SERVE_CHECKPOINT": "seed:0",
            "TFK8S_SERVE_MAX_BATCH": "4", "TFK8S_SERVE_BATCH_TIMEOUT_MS": "20"}
    replies, replica = _serve_and_submit(
        dict(base, TFK8S_SERVE_TASK="echo", TFK8S_POD_NAME="legacy-echo"), [1.0, 2.0, 3.0])
    assert [r["echo"] for r in replies] == [1.0, 2.0, 3.0]
    assert isinstance(replica, ModelServer) and replica.served_total == 3
    x = list(jmlp.make_batch(np.random.default_rng(2), 3)["image"])
    replies, _ = _serve_and_submit(dict(base, TFK8S_SERVE_TASK="mlp", TFK8S_POD_NAME="legacy-mlp"),
                                   x)
    assert all(0 <= r["label"] < 10 and r["version"] == "seed:0" for r in replies)
    prompts = list(np.random.default_rng(3).integers(1, 64, (4, 7)).astype(np.int32))
    env = dict(base, TFK8S_SERVE_TASK="gpt", TFK8S_SERVE_DECODE_LOOP="0",
               TFK8S_SERVE_GEN_TOKENS="5", TFK8S_POD_NAME="legacy-gpt")
    replies, replica = _serve_and_submit(env, prompts)
    assert isinstance(replica.model, GptGenerator)
    # the executor's batches are the generator's: the same tokens alone
    gen = GptGenerator("seed:0", max_batch_size=4, gen_tokens=5, device="cpu")
    gen.load()
    assert [r["tokens"] for r in replies] == [o["tokens"] for o in gen.forward(prompts)]
