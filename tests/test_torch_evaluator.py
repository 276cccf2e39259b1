"""The port's Evaluator (``runtime.train.run_eval``) against the JAX
package's, and port jobs under the reference control plane.

``run_eval`` scores the final checkpoint of the same bridged parameters
as the reference's ``run_eval`` does, on the held-out stream and on
record shards, within 1e-4; it times out without checkpoints. Under the
reference controller and ``LocalKubelet``: a Worker + Evaluator TPUJob of
the port's ``mlp:train``/``mlp:evaluate`` succeeds, and a port
``gpt:train`` job with ``TFK8S_INPUT_FILES`` succeeds, while one whose
files are missing fails.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.models import mlp as jmlp
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import LocalKubelet, registry
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from tfk8s_tpu.trainer import SliceAllocator, TPUJobController
from tfk8s_tpu.trainer.replicas import CHECKPOINT_DIR_ANNOTATION
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.data import example
from tfk8s_tpu_torch.data.recordio import RecordWriter
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.models.bert import make_chain_tokens
from tfk8s_tpu_torch.ops import flash_attention as tfa
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

from conftest import wait_for

ATOL = 1e-4
FINAL = 5
CPU = torch.device("cpu")


def _checkpoint_both(tmp_path, jtask, ttask, to_state_dict):
    """The reference's initial state saved at step FINAL by the reference
    Checkpointer, and the same parameters, bridged, by the port's."""
    jstate = jtrain.Trainer(jtask, jtrain.TrainConfig(steps=0), make_mesh(data=1)).init_state()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JCheckpointer(jdir).save(FINAL, jstate, wait=True)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = ttrain.Trainer(ttask, ttrain.TrainConfig(), CPU).init_state()
    tstate.model.load_state_dict(to_state_dict(params))
    tstate.step = FINAL
    Checkpointer(tdir).save(FINAL, tstate.state_dict(), wait=True)
    return jdir, tdir


def _env(ckpt, **kw):
    return {"TFK8S_DEVICE": "cpu", "TFK8S_CHECKPOINT_DIR": ckpt, "TFK8S_TRAIN_STEPS": str(FINAL),
            "TFK8S_EVAL_TIMEOUT": "30", **kw}


def _assert_metrics_close(got, want):
    assert set(got) == set(want), (got, want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_run_eval_evaluates_the_final_checkpoint_as_the_reference_does(tmp_path):
    jdir, tdir = _checkpoint_both(tmp_path, jmlp.make_task(), tmlp.make_task(),
                                  bridge.mlp_params_to_state_dict)
    want = jtrain.run_eval(jmlp.make_task(), _env(jdir), mesh=make_mesh(data=1))
    got = tmlp.evaluate(_env(tdir))
    assert got["step"] == want["step"] == float(FINAL)
    _assert_metrics_close(got, want)


def test_run_eval_times_out_without_checkpoints(tmp_path):
    with pytest.raises(RuntimeError, match="no new checkpoint"):
        ttrain.run_eval(tmlp.make_task(), _env(str(tmp_path / "empty"), TFK8S_EVAL_TIMEOUT="1"))


def test_run_eval_stops_when_asked(tmp_path):
    stop = threading.Event()
    stop.set()
    assert ttrain.run_eval(tmlp.make_task(), _env(str(tmp_path / "empty")), stop) == {}


def test_run_eval_from_record_shards_matches_the_reference(tmp_path):
    seq, batch = 16, 4
    vocab = tgpt.tiny_config().vocab_size
    rng = np.random.default_rng(0)
    path = str(tmp_path / "eval-0.rio")
    with RecordWriter(path) as w:
        for _ in range(10):  # two whole batches and a remainder
            toks = make_chain_tokens(rng, 1, seq, vocab)[0]
            w.write(example.encode({"input": toks.astype(np.int32)}))
    jtask = jgpt.make_task(jgpt.tiny_config(dtype=jnp.float32), seq_len=seq, batch_size=batch)
    tcfg = tgpt.tiny_config(dtype=torch.float32)
    ttask = tgpt.make_task(tcfg, seq_len=seq, batch_size=batch, attn_fn=tfa.flash_attention)
    jdir, tdir = _checkpoint_both(tmp_path, jtask, ttask,
                                  lambda p: bridge.params_to_state_dict(p, tcfg))
    env = dict(TFK8S_EVAL_INPUT_FILES=str(tmp_path / "eval-*.rio"))
    want = jtrain.run_eval(jtask, _env(jdir, **env), mesh=make_mesh(data=1))
    got = ttrain.run_eval(ttask, _env(tdir, **env))
    _assert_metrics_close(got, want)
    # the same batches every time: a second evaluation reads the same
    assert ttrain.run_eval(ttask, _env(tdir, **env)) == got


# -- port jobs under the reference control plane --------------------------------


@pytest.fixture
def cluster():
    cs = FakeClientset()
    ctrl = TPUJobController(cs, allocator=SliceAllocator({"cpu-1": 2}))
    stop = threading.Event()
    LocalKubelet(cs).run(stop)
    assert ctrl.run(workers=2, stop=stop, block=False)
    yield cs
    stop.set()
    ctrl.controller.shutdown()


def _status(cs, name):
    try:
        return cs.tpujobs().get(name).status
    except NotFound:
        return None


def _finished(cs, name):
    def done():
        status = _status(cs, name)
        return status is not None and (
            helpers.has_condition(status, JobConditionType.SUCCEEDED)
            or helpers.has_condition(status, JobConditionType.FAILED))
    return done


EVAL_RESULTS = {}


@registry.register("test.torch-eval-capture")
def _eval_capture(env, stop):
    EVAL_RESULTS["metrics"] = tmlp.evaluate(env, stop)


def test_worker_plus_evaluator_job_succeeds(cluster, tmp_path):
    cs = cluster
    name = "torch-train-and-eval"
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_TRAIN_STEPS": "300", "TFK8S_LOG_EVERY": "100"}
    cs.tpujobs().create(TPUJob(
        metadata=ObjectMeta(name=name,
                            annotations={CHECKPOINT_DIR_ANNOTATION: str(tmp_path / "ckpt")}),
        spec=TPUJobSpec(
            replica_specs={
                ReplicaType.WORKER: ReplicaSpec(replicas=1, template=ContainerSpec(
                    entrypoint="tfk8s_tpu_torch.models.mlp:train",
                    env=dict(env, TFK8S_CHECKPOINT_EVERY="100"))),
                ReplicaType.EVALUATOR: ReplicaSpec(replicas=1, template=ContainerSpec(
                    # the port's mlp:evaluate, its result kept for the test
                    entrypoint="test.torch-eval-capture",
                    env=dict(env, TFK8S_EVAL_TIMEOUT="90"))),
            },
            # one device for each process: the port's layout
            tpu=TPUSpec(accelerator="cpu-1"),
            run_policy=RunPolicy(scheduling=SchedulingPolicy(gang=True)),
        ),
    ))
    EVAL_RESULTS.clear()
    assert wait_for(_finished(cs, name), timeout=120)
    status = _status(cs, name)
    assert helpers.has_condition(status, JobConditionType.SUCCEEDED), status
    # success keys off the worker; the evaluator scored a real checkpoint
    assert wait_for(lambda: "metrics" in EVAL_RESULTS, timeout=30)
    metrics = EVAL_RESULTS["metrics"]
    assert metrics.get("step", 0) >= 100 and "accuracy" in metrics, metrics


def _gpt_files_job(name, files):
    return TPUJob(
        metadata=ObjectMeta(name=name),
        spec=TPUJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1, max_restarts=0, template=ContainerSpec(
                    entrypoint="tfk8s_tpu_torch.models.gpt:train",
                    env={"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny",
                         "TFK8S_TRAIN_STEPS": "8", "TFK8S_LEARNING_RATE": "3e-3",
                         "TFK8S_SEQ_LEN": "16", "TFK8S_BATCH_SIZE": "8", "TFK8S_LOG_EVERY": "4",
                         "TFK8S_INPUT_FILES": files}))},
            tpu=TPUSpec(accelerator="cpu-1"),
            run_policy=RunPolicy(backoff_limit=0),
        ),
    )


def test_gpt_job_trains_from_record_shards(cluster, tmp_path):
    cs = cluster
    rng = np.random.default_rng(0)
    for fi in range(2):
        with RecordWriter(str(tmp_path / f"part-{fi}.rio")) as w:
            for _ in range(32):
                toks = make_chain_tokens(rng, 1, 16, tgpt.tiny_config().vocab_size)[0]
                w.write(example.encode({"input": toks.astype(np.int32)}))
    cs.tpujobs().create(_gpt_files_job("torch-gpt-files", str(tmp_path / "part-*.rio")))
    assert wait_for(_finished(cs, "torch-gpt-files"), timeout=120)
    status = _status(cs, "torch-gpt-files")
    assert helpers.has_condition(status, JobConditionType.SUCCEEDED), status


def test_gpt_job_fails_on_missing_input_files(cluster, tmp_path):
    cs = cluster
    cs.tpujobs().create(_gpt_files_job("torch-gpt-nofiles", str(tmp_path / "none-*.rio")))
    assert wait_for(_finished(cs, "torch-gpt-nofiles"), timeout=120)
    status = _status(cs, "torch-gpt-nofiles")
    assert helpers.has_condition(status, JobConditionType.FAILED), status
