"""Checkpoint locations in the port against the JAX package's
``resolve_directory``, and a gs://-shaped checkpoint annotation through
the reference control plane.

Plain paths become absolute and ``gs://bucket/path`` maps under
``TFK8S_GCS_FAKE_ROOT`` exactly as the reference maps them. Where the
reference hands a URI to orbax's remote store (``gs://`` without a fake
root, ``file://``, any other scheme), the port has no object-store
client: ``file://`` names a local directory, the path of the URI, and
the rest raise ``NotImplementedError`` naming the scheme. The flow of
``tests/test_gang_resume_e2e.py`` then runs with the port's MLP: a job
annotated ``gs://...`` checkpoints, misses its target, is gang-restarted,
resumes at the first attempt's last checkpoint and succeeds, its bucket
directory under the fake root; ``run_eval`` reads the same location.
"""

import os
import threading
from urllib.parse import urlparse

import pytest
import torch

from tfk8s_tpu.api import (
    ContainerSpec, JobConditionType, ObjectMeta, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec,
    TPUSpec, helpers,
)
from tfk8s_tpu.api.types import RunPolicy, SchedulingPolicy
from tfk8s_tpu.client import FakeClientset, NotFound
from tfk8s_tpu.runtime import LocalKubelet, registry
from tfk8s_tpu.runtime.checkpoint import resolve_directory as reference_resolve
from tfk8s_tpu.trainer import SliceAllocator, TPUJobController
from tfk8s_tpu.trainer.replicas import CHECKPOINT_DIR_ANNOTATION
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer, resolve_directory
from tfk8s_tpu_torch.runtime.launcher import ProcessContext

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

FIRST_ATTEMPT_STEPS, FULL_STEPS = 25, 300  # the reference test's
OBS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The MLP's small products run fastest on one thread; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("location", [
    "ckpt/run", "./a/../b", "/abs/ckpt", "gs://bucket/ckpt/job", "gs://bucket", "gs://b/deep/er/",
])
def test_plain_paths_and_gs_under_the_fake_root_resolve_as_the_reference(location, tmp_path,
                                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TFK8S_GCS_FAKE_ROOT", "gcs-root")  # relative: made absolute
    assert resolve_directory(location) == reference_resolve(location)


@pytest.mark.parametrize("location", ["file:///abs/ckpt/run", "file:///tmp/x/"])
def test_file_uris_name_the_local_directory_the_reference_hands_to_orbax(location):
    assert reference_resolve(location) == location  # passed through to orbax
    assert resolve_directory(location) == os.path.abspath(urlparse(location).path)


@pytest.mark.parametrize("location,fake_root", [
    ("gs://bucket/run", None), ("s3://bucket/run", "root"), ("hdfs://nn/run", None),
    ("https://host/run", None), ("az://c/run", "root"),
])
def test_other_uris_raise_naming_their_scheme(location, fake_root, monkeypatch):
    if fake_root:
        monkeypatch.setenv("TFK8S_GCS_FAKE_ROOT", fake_root)
    else:
        monkeypatch.delenv("TFK8S_GCS_FAKE_ROOT", raising=False)
    # the reference passes each to orbax's remote store
    assert reference_resolve(location) == location
    scheme = location.split("://")[0]
    with pytest.raises(NotImplementedError, match=rf"no object-store client for {scheme}://"):
        resolve_directory(location)


def test_the_fake_root_is_read_at_call_time(tmp_path, monkeypatch):
    for root in ("one", "two"):
        monkeypatch.setenv("TFK8S_GCS_FAKE_ROOT", str(tmp_path / root))
        assert Checkpointer("gs://b/k").directory == str(tmp_path / root / "b" / "k")


def test_run_eval_reads_the_gs_location_training_wrote(tmp_path, monkeypatch):
    monkeypatch.setenv("TFK8S_GCS_FAKE_ROOT", str(tmp_path / "gcs"))
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_CHECKPOINT_DIR": "gs://bkt/eval-job",
           "TFK8S_TRAIN_STEPS": "2", "TFK8S_EVAL_TIMEOUT": "30"}
    config = ttrain.config_from_env(env, ProcessContext.from_env(env))
    ttrain.Trainer(tmlp.make_task(), config, torch.device("cpu")).fit()
    assert Checkpointer(str(tmp_path / "gcs" / "bkt" / "eval-job")).latest_step() == 2
    assert tmlp.evaluate(env)["step"] == 2.0


@registry.register("torch-resume-e2e.train")
def _resume_train(env, stop):
    """The reference test's entrypoint on the port: the first attempt
    trains 25 steps, checkpointing, and misses its accuracy target; the
    restarted one resumes through ``run_task``'s ordinary path."""
    env = dict(env)
    ctx = ProcessContext.from_env(env)
    obs = OBS.setdefault(ctx.job_name, {"attempts": []})
    ckpt = Checkpointer(ctx.checkpoint_dir) if ctx.checkpoint_dir else None
    obs["attempts"].append({
        "gang_restarts": ctx.gang_restarts, "resuming": ctx.resuming,
        "ckpt_step_at_start": ckpt.latest_step() if ckpt else None,
    })
    env["TFK8S_TRAIN_STEPS"] = str(FIRST_ATTEMPT_STEPS if ctx.gang_restarts == 0 else FULL_STEPS)
    obs["history"] = ttrain.run_task(tmlp.make_task(), env, stop)  # raises on a missed target


def test_gang_restart_resumes_a_port_job_from_its_gs_checkpoint(tmp_path, monkeypatch):
    cs = FakeClientset()
    ctrl = TPUJobController(cs, allocator=SliceAllocator({"cpu-1": 2}))
    stop = threading.Event()
    LocalKubelet(cs).run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    name = "torch-resume-e2e"
    monkeypatch.setenv("TFK8S_GCS_FAKE_ROOT", str(tmp_path / "gcs"))
    try:
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name=name, annotations={
                CHECKPOINT_DIR_ANNOTATION: f"gs://tfk8s-test-bucket/ckpt/{name}"}),
            spec=TPUJobSpec(
                replica_specs={ReplicaType.WORKER: ReplicaSpec(
                    replicas=1, template=ContainerSpec(
                        entrypoint="torch-resume-e2e.train",
                        env={"TFK8S_CHECKPOINT_EVERY": "10", "TFK8S_DEVICE": "cpu",
                             "TFK8S_LOG_EVERY": "25"}))},
                tpu=TPUSpec(accelerator="cpu-1"),
                run_policy=RunPolicy(scheduling=SchedulingPolicy(gang=True), backoff_limit=2),
            ),
        ))

        def succeeded():
            try:
                return helpers.has_condition(cs.tpujobs().get(name).status,
                                             JobConditionType.SUCCEEDED)
            except NotFound:
                return False

        assert wait_for(succeeded), f"job never succeeded; {cs.tpujobs().get(name).status}"
        assert cs.tpujobs().get(name).status.gang_restarts == 1
    finally:
        stop.set()
        ctrl.controller.shutdown()

    attempts = OBS[name]["attempts"]
    assert attempts == [
        {"gang_restarts": 0, "resuming": False, "ckpt_step_at_start": None},
        {"gang_restarts": 1, "resuming": True, "ckpt_step_at_start": FIRST_ATTEMPT_STEPS},
    ]
    final = OBS[name]["history"][-1]
    assert final["step"] == FULL_STEPS and final["accuracy"] >= 0.9
    bucket = tmp_path / "gcs" / "tfk8s-test-bucket" / "ckpt" / name
    assert bucket.is_dir()
    assert Checkpointer(str(bucket)).latest_step() == FULL_STEPS
