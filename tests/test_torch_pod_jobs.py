"""The reference's job shapes on the port, a pod running one rank process
per device (``tfk8s_tpu_torch/runtime/pod_ranks.py``), on the CPU over
gloo:

- through the reference control plane (``FakeClientset``,
  ``TPUJobController`` and ``LocalKubelet``) with the port's entry points:
  ``tests/test_t5_job_e2e.py``'s T5 on ``cpu-4``, one Worker, ``{"data":
  2, "tensor": 2}`` (``manifests/examples/t5-tensor-torch.yaml``), and
  ``tests/test_sp_job_e2e.py``'s BERT on ``{"sequence": 4}``, each
  ``Succeeded`` with its training progress in pod status;
- that T5 shape as one pod of four ranks against one process at rtol 1e-5
  (the reference's bound, ``tests/test_distributed.py``), and its first
  loss against the reference's T5 ``Trainer`` on four of conftest's virtual
  devices, atol 1e-4.

``tests/test_torch_pod_ranks.py`` holds the pods of two ranks, the input
split and the relay.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.api import (
    ContainerSpec,
    JobConditionType,
    ObjectMeta,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
    defaults,
    helpers,
    validation,
)
from tfk8s_tpu.api.types import MeshSpec
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.cmd.main import load_manifest
from tfk8s_tpu.models import t5 as jt5
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu.trainer import SliceAllocator, TPUJobController
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.runtime import train as ttrain

import _torch_pod_entry as entry
from conftest import wait_for
from test_torch_pod_ranks import ATOL, CPU, RTOL, STEPS, _gone, _joined, _run_all, _trajectory
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the reference's job shapes through the reference control plane ----------


def _manifest():
    return load_manifest(os.path.join(REPO, "manifests", "examples", "t5-tensor-torch.yaml"))


def test_the_t5_manifest_is_the_reference_job_shape():
    """``manifests/examples/t5-tensor-torch.yaml``: the reference's T5 job
    with the port's entry point, as the controller test below runs it."""
    job = _manifest()
    defaults.set_defaults(job)
    assert validation.validate(job) == []
    (worker,) = job.spec.replica_specs.values()
    assert (worker.replicas, worker.template.entrypoint) == (1, "tfk8s_tpu_torch.models.t5:train")
    assert job.spec.tpu.accelerator == "cpu-4"
    assert job.spec.mesh.axes == {"data": 2, "tensor": 2}
    assert worker.template.env["TFK8S_DEVICE"] == "cpu"


def _job(name, entrypoint, env, mesh):
    return TPUJob(
        metadata=ObjectMeta(name=name),
        spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1, template=ContainerSpec(entrypoint=entrypoint, env=env))},
            tpu=TPUSpec(accelerator="cpu-4"),
            mesh=MeshSpec(axes=mesh),
        ),
    )


def _reference_jobs():
    """Both jobs at once on two ``cpu-4`` slices: ``{name: (its final
    status, its pods)}``."""
    cs = FakeClientset()
    ctrl = TPUJobController(cs, allocator=SliceAllocator({"cpu-4": 2}))
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    jobs = {
        # tests/test_t5_job_e2e.py's job, on the port's entry point
        "t5-tensor-torch": _manifest(),
        # tests/test_sp_job_e2e.py's {"sequence": 4} job
        "sp-bert": _job("sp-bert", "tfk8s_tpu_torch.models.bert:train", {
            "TFK8S_MODEL_PRESET": "tiny", "TFK8S_TRAIN_STEPS": "8", "TFK8S_SEQ_LEN": "32",
            "TFK8S_BATCH_SIZE": "8", "TFK8S_DEVICE": "cpu"}, {"sequence": 4}),
    }
    try:
        for job in jobs.values():
            cs.tpujobs("default").create(job)

        def ended(name):
            status = cs.tpujobs("default").get(name).status
            return any(helpers.has_condition(status, c)
                       for c in (JobConditionType.SUCCEEDED, JobConditionType.FAILED))

        wait_for(lambda: all(ended(n) for n in jobs), timeout=180)
        pods, _ = cs.pods("default").list()
        return {n: (cs.tpujobs("default").get(n).status,
                    [p for p in pods if n in p.metadata.name]) for n in jobs}
    finally:
        stop.set()
        ctrl.controller.shutdown()


def _reference_first_loss():
    """The reference's T5 ``Trainer``, one process over four devices on
    ``{"data": 2, "tensor": 2}``, from the port's initial parameters
    bridged, on the replicated batch stream: its first loss."""
    tcfg = tt5.tiny_config(dtype=torch.float32)
    ttask = tt5.make_task(tcfg, seq_len=16, batch_size=8)
    state = ttrain.Trainer(ttask, ttrain.TrainConfig(), torch.device("cpu")).init_state()
    params = jax.tree_util.tree_map(
        jnp.asarray, bridge.t5_state_dict_to_params(state.model.state_dict(), tcfg))
    mesh = make_mesh(data=2, tensor=2)
    jtask = jt5.task_for_mesh(mesh, cfg=jt5.tiny_config(dtype=jnp.float32), seq_len=16,
                              batch_size=8)
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(steps=1, learning_rate=1e-2, log_every=1),
                         mesh)
    jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                              opt_state=jtr.optimizer.init(params)),
                            jtr.state_shardings)
    _, jh = jtr.fit(state=jstate)
    return jh[0]["loss"]


@pytest.fixture(scope="module")
def jobs():
    """The two controller jobs and the four-rank T5 pod at once, each on a
    thread of its own (their rank processes' start-up is most of their
    time), the reference's run and one process's meanwhile on this thread."""
    runs = {
        "jobs": _reference_jobs,
        "t5": lambda: entry.t5_f32(dict(CPU, TFK8S_MESH=json.dumps({"data": 2, "tensor": 2}))),
    }
    out = _run_all(runs)
    out["reference_first_loss"] = _reference_first_loss()
    out["one_t5"] = entry.t5_f32(CPU)
    return _joined(out)


@pytest.mark.parametrize("name", ["t5-tensor-torch", "sp-bert"])
def test_the_reference_job_shapes_succeed_through_the_controller(jobs, name):
    status, job_pods = jobs["jobs"][0][name]
    assert helpers.has_condition(status, JobConditionType.SUCCEEDED), status
    assert len(job_pods) == 1
    # rank 0's progress reached pod status through the pod's process
    assert job_pods[0].status.training.get("step") == 8.0, job_pods[0].status.training


def test_one_pod_of_four_ranks_equals_one_process(jobs):
    (pod, run), one = jobs["t5"], jobs["one_t5"]
    assert run.ranks == 4 and run.world == 4 and run.first_rank == 0
    assert [h["step"] for h in pod] == list(range(1, STEPS + 1))
    np.testing.assert_allclose(_trajectory(pod), _trajectory(one), rtol=RTOL)
    # every rank ran the same steps: the tensor ranks' and data ranks' means agree
    for rec in run.records:
        np.testing.assert_allclose(_trajectory(rec["result"]), _trajectory(pod), rtol=RTOL)
    assert all(_gone(pid) for pid in run.pids)


def test_one_pod_first_loss_equals_the_reference_on_four_devices(jobs):
    pod, _ = jobs["t5"]
    np.testing.assert_allclose(pod[0]["loss"], jobs["reference_first_loss"], atol=ATOL)


