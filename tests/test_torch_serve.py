"""The port's serving path against the JAX package's.

The port's ``DecodeLoopExecutor`` over its torch ``PagedGptDecoder`` and
the reference's executor over the JAX decoder load the same bridged
parameters (tiny config, float32, on the CPU) and serve the same mixed
greedy and sampled requests: every stream must be token-identical. A KV
handoff crosses backends through the wire bytes in both directions and
continues token-identical, bfloat16 leaves included. Then a TPUServe that
pins the port's entrypoint runs under the reference's serve controller
and ``LocalKubelet``: it reaches Ready through ``replica_is_ready``,
serves, and drains to Drained on a reclaim notice.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfk8s_tpu.runtime.kubelet as kubelet_mod
from tfk8s_tpu.api.types import BatchingPolicy, ObjectMeta, TPUServe, TPUServeSpec
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.runtime import handoff as jhandoff
from tfk8s_tpu.runtime import server as jserver
from tfk8s_tpu.runtime.paging import prefix_digest_chain
from tfk8s_tpu.trainer import TPUServeController
from tfk8s_tpu.trainer import labels as L
from tfk8s_tpu.utils.logging import Metrics as JMetrics
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.runtime import handoff as thandoff
from tfk8s_tpu_torch.runtime import server as tserver
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
from tfk8s_tpu_torch.utils.logging import Metrics as TMetrics

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

SLOTS, PAGE, PAGES, CHUNK = 4, 8, 64, 16
VERSION = "seed:0"


@pytest.fixture(scope="module")
def decoders():
    """(reference decoder, port decoder) on the same bridged parameters."""
    jcfg = jgpt.tiny_config(dtype=jnp.float32)
    params = unbox(jgpt.make_task(cfg=jcfg, seq_len=8, batch_size=1).init(jax.random.key(0)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tgpt.tiny_config(dtype=torch.float32)
    geometry = dict(slots=SLOTS, page_size=PAGE, max_pages=PAGES, gen_tokens=8,
                    size="tiny", prefill_chunk=CHUNK)
    ref = jserver.PagedGptDecoder(VERSION, cfg=jcfg, params=params, **geometry)
    port = tserver.PagedGptDecoder(VERSION, cfg=tcfg, device="cpu",
                                   params=bridge.params_to_state_dict(params, tcfg), **geometry)
    ref.load()
    port.load()
    return ref, port


def _loops(decoders, **kw):
    ref, port = decoders
    return (jserver.DecodeLoopExecutor(ref, metrics=JMetrics(), **kw).start(),
            tserver.DecodeLoopExecutor(port, metrics=TMetrics(), **kw).start())


def _requests(n, seed=0):
    """Mixed lengths and budgets, a third sampled, a third sharing a
    16-token prefix (two full pages: prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 64, 16).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(1, 64, int(rng.integers(1, 20))).astype(np.int32)
        tokens = np.concatenate([shared, tail]) if i % 3 == 1 else tail
        payload = {"tokens": tokens, "gen_tokens": int(rng.integers(1, 14))}
        if i % 3 == 2:
            payload["sampling"] = {"temperature": [0.8, 1.2][i % 2], "top_k": [0, 20][i % 2],
                                   "top_p": [0.9, 1.0][i % 2], "seed": 1000 + i}
        out.append(payload)
    return out


def _serve_all(loop, payloads):
    with ThreadPoolExecutor(len(payloads)) as ex:
        return [f.result(timeout=180)
                for f in [ex.submit(loop.submit, p, 120) for p in payloads]]


def test_executor_streams_equal_the_reference_executor(decoders):
    jloop, tloop = _loops(decoders)
    payloads = _requests(12)
    try:
        want = _serve_all(jloop, payloads)
        got = _serve_all(tloop, payloads)
    finally:
        jloop.drain(10)
        tloop.drain(10)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["tokens"] == w["tokens"], f"request {i} diverged"
        assert len(g["tokens"]) == payloads[i]["gen_tokens"]
    assert tloop.allocator.prefix_hits >= 1


class _ThrottledDecoder(tserver.PagedGptDecoder):
    """Decode steps slowed to a floor so the admission/preemption
    interleaving is deterministic from another thread."""

    def decode(self, state, samp=None):
        time.sleep(0.004)
        return super().decode(state, samp)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preempted_row_resumes_identical_to_the_reference(decoders, sampled):
    """A pool that fits one 40-token request: a high-priority arrival
    spills the live low-priority row through ``export_kv``, and the row
    later restores through ``import_kv`` and completes with the stream
    the reference gives it unpreempted."""
    ref, port = decoders
    low = {"tokens": np.random.default_rng(1).integers(1, 64, 40).astype(np.int32),
           "gen_tokens": 16}
    if sampled:
        low["sampling"] = {"temperature": 0.9, "top_k": 10, "seed": 7}
    high = {"tokens": np.random.default_rng(2).integers(1, 64, 40).astype(np.int32),
            "gen_tokens": 16}
    jloop = jserver.DecodeLoopExecutor(ref, metrics=JMetrics()).start()
    try:
        want = jloop.submit(low, 120)["tokens"]
    finally:
        jloop.drain(10)
    small = _ThrottledDecoder(VERSION, slots=SLOTS, page_size=PAGE, max_pages=9, gen_tokens=8,
                              prefill_chunk=CHUNK, cfg=port.cfg, device="cpu",
                              params=port.module.state_dict())
    small.load()  # 8 usable pages: one 40-token request takes 7
    loop = tserver.DecodeLoopExecutor(small, metrics=TMetrics(), sched_policy="priority").start()
    try:
        with ThreadPoolExecutor(2) as ex:
            lo = ex.submit(lambda: loop.submit(low, timeout=120, priority=0))
            assert wait_for(lambda: loop.live_slots == 1, timeout=30, interval=0.001)
            hi = ex.submit(lambda: loop.submit(high, timeout=120, priority=5))
            assert len(hi.result(timeout=120)["tokens"]) == 16
            got = lo.result(timeout=120)["tokens"]
    finally:
        loop.drain(10)
    assert loop.preempted_total == 1 and loop.restored_total == 1
    assert got == want


def test_speculative_decode_with_a_torch_draft_is_token_identical(decoders):
    ref, port = decoders
    from tfk8s_tpu_torch.runtime.sched import SpeculativeEngine

    engine = SpeculativeEngine.build(port, k=3, size="tiny")
    assert isinstance(engine.draft, tserver.PagedGptDecoder)
    payloads = _requests(6, seed=4)
    plain = tserver.DecodeLoopExecutor(port, metrics=TMetrics()).start()
    spec = tserver.DecodeLoopExecutor(port, metrics=TMetrics(), speculative=engine).start()
    try:
        want = [plain.submit(p, 120)["tokens"] for p in payloads]
        got = [spec.submit(p, 120)["tokens"] for p in payloads]
    finally:
        plain.drain(10)
        spec.drain(10)
    assert got == want
    assert engine.proposed_total > 0


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_kv_handoff_crosses_backends_token_identical(decoders, direction, sampled):
    """Prefill on one backend, export the warm KV as wire bytes, import
    them on the other backend's decode replica: the continued stream
    equals a single-replica run on the importing side."""
    jloop, tloop = _loops(decoders)
    rng = np.random.default_rng(20)
    payload = {"tokens": rng.integers(1, 64, 21).astype(np.int32), "gen_tokens": 9}
    if sampled:
        payload["sampling"] = {"temperature": 0.8, "top_k": 12, "top_p": 0.95, "seed": 77}
    exporter, importer, importer_buf = (
        (jloop, tloop, thandoff.KVHandoffBuffer) if direction == "jax_to_torch"
        else (tloop, jloop, jhandoff.KVHandoffBuffer)
    )
    try:
        whole = importer.submit(payload, 60)["tokens"]
        first = exporter.submit_prefill(payload, 60)
        wire = first["handoff"].to_bytes()
        buf = importer_buf.from_bytes(wire)
        got = importer.submit_handoff(buf, 60, sampling=payload.get("sampling"))["tokens"]
    finally:
        jloop.drain(10)
        tloop.drain(10)
    assert first["tokens"] == whole[:1]
    assert got == whole


def test_bfloat16_wire_bytes_interchange():
    """The same buffer with bfloat16 leaves serializes to the same bytes
    in both packages, and each side decodes the other's."""
    tokens = list(range(1, 11))
    digests = prefix_digest_chain(tokens, 4, 2)
    vals = np.random.default_rng(21).standard_normal((3, 12, 2, 4)).astype(np.float32)
    jleaves = [np.asarray(jnp.asarray(v, jnp.bfloat16)) for v in vals]
    tleaves = [torch.from_numpy(v).to(torch.bfloat16) for v in vals]
    common = dict(version="v1", page_size=4, tokens=tokens, last_token=5, gen_budget=3,
                  digests=digests)
    jwire = jhandoff.KVHandoffBuffer(kv=jleaves, **common).to_bytes()
    twire = thandoff.KVHandoffBuffer(kv=tleaves, **common).to_bytes()
    assert jwire == twire
    back = thandoff.KVHandoffBuffer.from_bytes(jwire)
    for t, leaf in zip(tleaves, back.kv):
        assert leaf.dtype == torch.bfloat16 and torch.equal(t, leaf)
    fwd = jhandoff.KVHandoffBuffer.from_bytes(twire)
    for j, leaf in zip(jleaves, fwd.kv):
        assert str(leaf.dtype) == "bfloat16" and np.array_equal(j.view(np.int16), leaf.view(np.int16))


def test_serve_refuses_the_tasks_it_does_not_port():
    """The port serves every task the reference does (echo, mlp, gpt and
    t5, with or without the decode loop); an unknown task raises
    ``ServeError``, as the reference's ``make_model`` does."""
    for env in ({"TFK8S_SERVE_TASK": "bogus"},
                {"TFK8S_SERVE_TASK": "bogus", "TFK8S_SERVE_DECODE_LOOP": "0"}):
        with pytest.raises(tserver.ServeError, match="unknown serve task"):
            tserver.serve(dict(env, TFK8S_DEVICE="cpu"), threading.Event())
        with pytest.raises(jserver.ServeError, match="unknown serve task"):
            jserver.serve(env, threading.Event())


@pytest.fixture
def serve_cluster(monkeypatch):
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    cs = FakeClientset()
    ctrl = TPUServeController(cs)
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    yield cs, ctrl, kubelet
    stop.set()
    ctrl.controller.shutdown()


def test_port_serve_pod_reaches_ready_serves_and_drains(serve_cluster):
    """A TPUServe pinning the port's entrypoint: the replica reports
    ``serving_ready`` through the node agent's progress sink, so the
    reference's ``replica_is_ready`` passes and the serve reports one
    Ready replica; it answers a request; a reclaim notice ends the pod
    Drained (not Failed), and the controller replaces it."""
    cs, ctrl, kubelet = serve_cluster
    serve = TPUServe(
        metadata=ObjectMeta(name="torch-gpt"),
        spec=TPUServeSpec(
            task="gpt", checkpoint="seed:0", replicas=1,
            batching=BatchingPolicy(max_batch_size=4, batch_timeout_ms=2.0, queue_limit=64,
                                    page_size=8, max_pages=64),
        ),
    )
    serve.spec.template.entrypoint = "tfk8s_tpu_torch.runtime.server:serve"
    serve.spec.template.env.update({"TFK8S_SERVE_GEN_TOKENS": "5", "TFK8S_SERVE_GPT_SIZE": "tiny",
                                    "TFK8S_DEVICE": "cpu"})
    cs.tpuserves().create(serve)
    assert wait_for(lambda: cs.tpuserves().get("torch-gpt").status.ready_replicas == 1, timeout=120)
    pods, _ = cs.pods().list(label_selector=L.serve_selector("torch-gpt"))
    (pod,) = [p for p in pods if jserver.replica_is_ready(p)]
    assert pod.spec.containers[0].entrypoint == "tfk8s_tpu_torch.runtime.server:serve"
    replica = tserver.lookup_replica(pod.metadata.key)
    assert isinstance(replica, tserver.DecodeLoopExecutor)
    out = replica.submit(np.array([3, 4, 5, 6], np.int32), timeout=60)
    assert len(out["tokens"]) == 5
    assert wait_for(lambda: cs.pods().get(pod.metadata.name).status.training
                    .get("serving_requests", 0) >= 1, timeout=30)

    kubelet.deliver_reclaim(pod.metadata.key, grace_s=30.0)

    def reclaimed():
        return any(e.reason == "ReplicaReclaimed" and pod.metadata.name in e.message
                   for e in ctrl.recorder.events())

    assert wait_for(reclaimed, timeout=60)
    assert not any(e.reason == "ReplicaFailed" for e in ctrl.recorder.events())
    # the drained replica left the registry (its replacement reuses the
    # pod's name, so the key may already hold the new replica)
    assert tserver.lookup_replica(pod.metadata.key) is not replica
    # the controller brings a fresh replica up in its place
    assert wait_for(lambda: any(
        jserver.replica_is_ready(p) and p.metadata.uid != pod.metadata.uid
        for p in cs.pods().list(label_selector=L.serve_selector("torch-gpt"))[0]), timeout=120)
    cs.tpuserves().delete("torch-gpt")
    assert wait_for(lambda: not kubelet._claimed, timeout=60)


def test_decoder_loads_a_port_training_checkpoint(tmp_path):
    """A checkpoint ref that is a directory restores the model of the port's
    latest committed training step (``runtime/checkpoint.py``)."""
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
           "TFK8S_BATCH_SIZE": "4", "TFK8S_TRAIN_STEPS": "2", "TFK8S_LOG_EVERY": "1",
           "TFK8S_CHECKPOINT_DIR": str(tmp_path)}
    tgpt.train(env)
    saved = Checkpointer(str(tmp_path)).restore()["model"]
    dec = tserver.PagedGptDecoder(str(tmp_path), slots=2, page_size=8, max_pages=16,
                                  size="tiny", prefill_chunk=8, device="cpu",
                                  cfg=tgpt.tiny_config(dtype=torch.float32))
    dec.load()
    for name, value in dec.module.state_dict().items():
        assert torch.equal(value.float(), saved[name].float()), name
    assert len(dec.validate(np.array([1, 2, 3], np.int32))[0]) == 3
    with pytest.raises(tserver.ServeError, match="no saved step"):
        tserver.PagedGptDecoder(str(tmp_path / "empty"), slots=2, page_size=8, max_pages=16,
                                device="cpu").load()
