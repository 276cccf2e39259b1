"""The port's trainer under the reference's node agent (``LocalKubelet``).

The port reaches the node agent's three sinks through the stop object the
agent hands the entrypoint (``runtime/node_agent``): a reclaimed port
Worker ends Drained with backoff untouched and resumes from its drain
checkpoint; its progress (``step``, ``steps_per_sec``, ``compile_seconds``)
reaches ``pod.status.training``; its trace carries ``trainer.run``,
``trainer.startup`` and ``trainer.first_step``. Outside a node agent the
port keeps its own drain class, progress dict and tracer.
"""

import threading

import pytest

import tfk8s_tpu.runtime.kubelet as kubelet_mod
from tfk8s_tpu.api import helpers
from tfk8s_tpu.api.types import (
    ContainerSpec,
    JobConditionType,
    ObjectMeta,
    ReplicaSpec,
    ReplicaType,
    RunPolicy,
    SchedulingPolicy,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
)
from tfk8s_tpu.client import FakeClientset, NotFound
from tfk8s_tpu.obs import trace as obstrace
from tfk8s_tpu.obs.trace import Tracer
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.runtime.kubelet import PodStopSignal
from tfk8s_tpu.runtime.registry import PodDrained as ReferencePodDrained
from tfk8s_tpu.trainer import TPUJobController
from tfk8s_tpu.trainer.replicas import CHECKPOINT_DIR_ANNOTATION
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.obs import trace as ttrace
from tfk8s_tpu_torch.runtime import node_agent, progress
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

ENTRY = "tfk8s_tpu_torch.models.gpt:train"


def _env(**extra):
    env = {
        "TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
        "TFK8S_BATCH_SIZE": "4", "TFK8S_TRAIN_STEPS": "4", "TFK8S_LOG_EVERY": "1",
    }
    env.update(extra)
    return env


def _job(name, env, ckpt_dir=None):
    annotations = {CHECKPOINT_DIR_ANNOTATION: ckpt_dir} if ckpt_dir else {}
    return TPUJob(
        metadata=ObjectMeta(name=name, annotations=annotations),
        spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1, template=ContainerSpec(entrypoint=ENTRY, env=env))},
            tpu=TPUSpec(accelerator="cpu-1"),
            run_policy=RunPolicy(backoff_limit=3, scheduling=SchedulingPolicy(gang=True)),
        ),
    )


@pytest.fixture
def cluster(monkeypatch):
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    yield cs, ctrl, kubelet
    try:
        for j in cs.tpujobs().list()[0]:
            try:
                cs.tpujobs().delete(j.metadata.name)
            except NotFound:
                pass
        wait_for(lambda: not kubelet._claimed, timeout=60)
    except Exception:  # noqa: BLE001 — teardown is best-effort
        pass
    stop.set()
    ctrl.controller.shutdown()


def _status(cs, name):
    try:
        return cs.tpujobs().get(name).status
    except NotFound:
        return None


def _worker(cs, name):
    try:
        return cs.pods().get(f"{name}-worker-0")
    except NotFound:
        return None


def test_node_agent_is_found_from_the_kubelet_stop_signal():
    agent = node_agent.find(PodStopSignal())
    assert agent is not None
    assert agent.pod_drained is ReferencePodDrained
    assert agent.progress is kubelet_mod._progress
    assert agent.get_tracer() is obstrace.get_tracer()
    with node_agent.attach(PodStopSignal()) as bound:
        assert bound is not None and node_agent.bound() is bound
        assert ttrace.get_tracer() is obstrace.get_tracer()
    assert node_agent.bound() is None
    for outside in (None, threading.Event(), object()):
        assert node_agent.find(outside) is None
        assert node_agent.pod_drained_class(outside) is node_agent.PodDrained


def test_reclaimed_port_worker_ends_drained_and_resumes(cluster, tmp_path):
    """F1: a reclaim notice to a port Worker drains it to the Drained
    phase, which the controller answers with a reclaim restart (no
    backoff burnt); the relaunched Worker resumes from the drain
    checkpoint."""
    cs, ctrl, kubelet = cluster
    name = "torch-reclaim"
    ckpt = str(tmp_path / "ckpt")
    cs.tpujobs().create(_job(name, _env(TFK8S_TRAIN_STEPS="100000"), ckpt))
    assert wait_for(lambda: (_worker(cs, name) is not None
                             and _worker(cs, name).status.training.get("step", 0) >= 3),
                    timeout=120)
    first = _worker(cs, name)
    kubelet.deliver_reclaim(first.metadata.key, grace_s=30.0)

    assert wait_for(lambda: (_status(cs, name) is not None
                             and _status(cs, name).preemptions == 1), timeout=60)
    st = _status(cs, name)
    assert st.gang_restarts == 0, "a drained pod must not burn backoff_limit"
    assert not helpers.has_condition(st, JobConditionType.FAILED)
    assert any(e.reason == "ReclaimRestart" for e in ctrl.recorder.events())
    drain_step = Checkpointer(ckpt).latest_step()
    assert drain_step and drain_step >= 3

    def resumed():
        pod = _worker(cs, name)
        return (pod is not None and pod.metadata.uid != first.metadata.uid
                and any(f"resumed at step {drain_step}" in line for line in pod.status.log_tail))

    assert wait_for(resumed, timeout=120)
    assert wait_for(lambda: _worker(cs, name).status.training.get("step", 0) > drain_step,
                    timeout=60)


def test_pod_status_carries_port_progress_and_compile_seconds(cluster):
    """F2 and F3: the Worker's progress reaches ``status.training``, with
    the first step's time under ``compile_seconds`` (the key the
    controller mirrors) as well as ``first_step_seconds``."""
    cs, _ctrl, _kubelet = cluster
    name = "torch-progress"
    cs.tpujobs().create(_job(name, _env()))
    assert wait_for(lambda: _status(cs, name) is not None
                    and helpers.has_condition(_status(cs, name), JobConditionType.SUCCEEDED),
                    timeout=120)
    pod = _worker(cs, name)
    training = pod.status.training
    assert training["step"] == 4
    assert training["steps_per_sec"] > 0
    assert training["compile_seconds"] > 0
    assert training["compile_seconds"] == training["first_step_seconds"]


def test_job_trace_holds_the_trainer_spans(cluster):
    """F4: ``run_task`` continues the pod's trace with the trainer spans,
    nested under the kubelet's launch span."""
    cs, _ctrl, _kubelet = cluster
    prev = obstrace.set_tracer(Tracer(capacity=16384))
    try:
        name = "torch-trace"
        cs.tpujobs().create(_job(name, _env()))
        assert wait_for(lambda: _status(cs, name) is not None
                        and helpers.has_condition(_status(cs, name), JobConditionType.SUCCEEDED),
                        timeout=120)
        tracer = obstrace.get_tracer()
        (run,) = tracer.find_spans("trainer.run")
        (startup,) = tracer.find_spans("trainer.startup")
        (first,) = tracer.find_spans("trainer.first_step")
        (launch,) = [s for s in tracer.find_spans("kubelet.launch")
                     if s.attributes.get("pod") == f"default/{name}-worker-0"]
        assert run.trace_id == launch.trace_id == startup.trace_id == first.trace_id
        assert run.parent_id == launch.span_id
        assert startup.parent_id == run.span_id and first.parent_id == run.span_id
        assert first.attributes["task"] == "gpt-lm"
    finally:
        obstrace.set_tracer(prev)


class _Drain:
    drain_requested = True

    def is_set(self):
        return False


def test_outside_a_node_agent_the_port_keeps_its_own_sinks(tmp_path):
    """No node agent: progress lands in the port's own dict, a drain
    raises the port's ``PodDrained``, and the tracer is a no-op."""
    progress.clear()
    history = tgpt.train(_env(), stop=threading.Event())
    assert history[-1]["step"] == 4
    snap = progress.snapshot()
    assert snap["step"] == 4 and snap["compile_seconds"] == snap["first_step_seconds"]
    with pytest.raises(ttrain.PodDrained) as info:
        tgpt.train(_env(TFK8S_CHECKPOINT_DIR=str(tmp_path)), stop=_Drain())
    assert not isinstance(info.value, ReferencePodDrained)
    progress.clear()
