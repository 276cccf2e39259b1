"""The port's training runtime against the JAX package's.

A 3-step float32 trajectory of the port's ``Trainer`` (its plain flash
path on the CPU) against the reference ``loss_fn`` stepped by the
reference ``TrainConfig.make_optimizer()`` from the same bridged initial
parameters and the same ``default_rng(seed + step)`` batch stream: losses
and gradient norms agree to rtol 1e-4. The rest covers the env contract,
the learning-rate schedules, the checkpoint commit-marker gate and the
device rule (the card unless the caller asks for the CPU).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.ops import flash_attention as tfa
from tfk8s_tpu_torch.parallel.mesh import MeshConfig
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
import _torch_threads  # noqa: F401  (torch's threads under xdist)

SEQ, BATCH, STEPS = 16, 4, 3
RTOL = 1e-4


def _reference_trajectory(params, accum, **train_kw):
    """Per-step (loss, grad_norm) of the reference loss_fn under the
    reference optimizer, batches from the reference stream."""
    task = jgpt.make_task(jgpt.tiny_config(dtype=jnp.float32), seq_len=SEQ, batch_size=BATCH)
    cfg = jtrain.TrainConfig(steps=STEPS, **train_kw)
    opt = cfg.make_optimizer()
    grad_fn = jax.value_and_grad(lambda p, b: task.loss_fn(p, b, jax.random.key(0)),
                                 has_aux=True)

    @jax.jit
    def step(params, opt_state, micro):
        outs = [grad_fn(params, {"input": m}) for m in micro]
        loss = sum(o[0][0] for o in outs) / accum
        grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum, *(o[1] for o in outs))
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, optax.global_norm(grads)

    rng = np.random.default_rng(cfg.seed)
    opt_state, out = opt.init(params), []
    for _ in range(STEPS):
        ids = task.make_batch(rng, BATCH)["input"]
        params, opt_state, loss, gnorm = step(params, opt_state, np.split(ids, accum))
        out.append((float(loss), float(gnorm)))
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_three_step_trajectory_matches_reference(accum):
    train_kw = dict(learning_rate=3e-3, warmup_steps=1, lr_schedule="cosine")
    jcfg = jgpt.tiny_config(dtype=jnp.float32)
    ids = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = unbox(jax.jit(jgpt.GPTLM(jcfg).init)(jax.random.key(0), ids)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    want = _reference_trajectory(params, accum, **train_kw)

    tcfg = tgpt.tiny_config(dtype=torch.float32)
    task = tgpt.make_task(tcfg, seq_len=SEQ, batch_size=BATCH, attn_fn=tfa.flash_attention)
    config = ttrain.TrainConfig(steps=STEPS, log_every=1, grad_accum_steps=accum, **train_kw)
    trainer = ttrain.Trainer(task, config, torch.device("cpu"))
    state = trainer.init_state()
    state.model.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    _, history = trainer.fit(state=state)
    got = [(h["loss"], h["grad_norm"]) for h in history]
    assert [h["step"] for h in history] == [1, 2, 3]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(schedule, warmup):
    kw = dict(steps=12, learning_rate=2e-3, warmup_steps=warmup, lr_schedule=schedule,
              min_lr_ratio=0.1)
    want = jtrain.TrainConfig(**kw).make_schedule()
    got = ttrain.TrainConfig(**kw).make_schedule()
    for step in range(16):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0  # optax reads the count before the update


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        ttrain.TrainConfig(lr_schedule="step").make_schedule()


def _state(value):
    return {"w": torch.full((3,), float(value)), "step": value}


def test_checkpoint_marker_gate(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, _state(step), wait=True)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    # a write killed before its marker: the directory exists, unmarked
    torn = tmp_path / "4"
    torn.mkdir()
    torch.save(_state(4), torn / "state.pt")
    assert ckpt.latest_step() == 3
    assert float(ckpt.restore()["w"][0]) == 3.0
    # a fresh handle trusts the markers, not the directories
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 3]


def test_checkpoint_without_marker_registry_is_trusted(tmp_path):
    for step in (5, 7):
        (tmp_path / str(step)).mkdir()
        torch.save(_state(step), tmp_path / str(step) / "state.pt")
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.all_steps() == [5, 7]
    ckpt.save(8, _state(8), wait=True)  # switches the gate on, marking 5 and 7
    assert ckpt.all_steps() == [5, 7, 8]
    assert sorted(os.listdir(tmp_path / ".tfk8s_commits")) == ["5", "7", "8"]


def _env(tmp_path=None, **kw):
    env = {
        "TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
        "TFK8S_BATCH_SIZE": str(BATCH), "TFK8S_TRAIN_STEPS": "4", "TFK8S_LOG_EVERY": "2",
        "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_ATTENTION_IMPL": "flash",
    }
    if tmp_path is not None:
        env["TFK8S_CHECKPOINT_DIR"] = str(tmp_path)
    env.update(kw)
    return env


def test_train_entrypoint_runs_on_cpu_and_resumes(tmp_path):
    history = tgpt.train(_env(tmp_path, TFK8S_CHECKPOINT_EVERY="2"))
    assert [h["step"] for h in history] == [2, 4]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    # a gang restart resumes from the committed step and trains on
    history = tgpt.train(_env(tmp_path, TFK8S_TRAIN_STEPS="6", TFK8S_GANG_RESTARTS="1"))
    assert [h["step"] for h in history] == [6]
    assert Checkpointer(str(tmp_path)).latest_step() == 6


def test_train_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = _env()
    del env["TFK8S_DEVICE"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.train(env)


class _Drain:
    drain_requested = True

    def is_set(self):
        return False


def test_drain_commits_a_checkpoint_and_raises_pod_drained(tmp_path):
    with pytest.raises(ttrain.PodDrained):
        tgpt.train(_env(tmp_path), stop=_Drain())
    assert Checkpointer(str(tmp_path)).latest_step() == 0


@pytest.mark.parametrize("extra,outcome", [
    # multislice runs (tests/test_torch_multislice.py), and pipeline beside
    # tensor in a gang (tests/test_torch_pipeline_axes.py); one of four
    # processes outside a process group holds one device of the four
    ({"TFK8S_NUM_PROCESSES": "4", "TFK8S_MESH": '{"pipeline": 2, "tensor": 2}'},
     (ValueError, r"needs 4 devices; 1 available")),
    # more devices than processes: the pod's ranks, started by the entry
    # point on itself (tests/test_torch_pod_ranks.py runs them)
    ({"TFK8S_MESH": '{"data": 2}'}, 2),
    # image input runs (tests/test_torch_image_job.py), a pod of four too
    ({"TFK8S_INPUT_FILES": "part-*.rio", "TFK8S_INPUT_FORMAT": "image",
      "TFK8S_MESH": '{"data": 4}'}, 4),
    # two pods of two ranks need a process group across the pods
    ({"TFK8S_NUM_PROCESSES": "2", "TFK8S_MESH": '{"data": 2, "tensor": 2}'},
     (RuntimeError, r"needs TFK8S_DISTRIBUTED=1")),
])
def test_unported_features_raise(extra, outcome, monkeypatch):
    from tfk8s_tpu_torch.runtime import pod_ranks

    if "TFK8S_MESH" in extra:  # every layout passes the mesh rules
        MeshConfig.from_env(extra).require_ported()
    if isinstance(outcome, int):
        pods = []
        monkeypatch.setattr(pod_ranks, "run", lambda *args: pods.append(args) or [])
        assert tgpt.train(_env(**extra)) == []
        assert pods == [("tfk8s_tpu_torch.models.gpt:train", _env(**extra), None, outcome)]
        return
    # raised before any rank process starts
    with pytest.raises(outcome[0], match=outcome[1]):
        tgpt.train(_env(**extra))


@pytest.mark.parametrize("extra", [
    {"TFK8S_NUM_EXPERTS": "2"},
    {"TFK8S_ATTENTION_IMPL": "ring"},
    {"TFK8S_ATTENTION_IMPL": "ulysses"},
])
def test_item_9_features_train_as_the_reference(extra, tmp_path, monkeypatch):
    """MoE layers and the ring and Ulysses pins, once refused, run through
    ``gpt.train`` in one process (a ring of one is exact attention) and
    follow the reference ``Trainer`` (full attention) to rtol 1e-4."""
    from _torch_parity import trajectories

    monkeypatch.setattr(tgpt, "tiny_config",
                        functools.partial(tgpt.tiny_config, dtype=torch.float32))
    experts = int(extra.get("TFK8S_NUM_EXPERTS", "0"))
    jtask = jgpt.make_task(jgpt.tiny_config(dtype=jnp.float32, num_experts=experts),
                           seq_len=SEQ, batch_size=BATCH)
    tcfg = tgpt.tiny_config(num_experts=experts)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
           "TFK8S_BATCH_SIZE": str(BATCH), "TFK8S_LEARNING_RATE": "3e-3", **extra}
    want, got = trajectories(jtask, tgpt.make_task(tcfg, seq_len=SEQ, batch_size=BATCH),
                             lambda sd: bridge.state_dict_to_params(sd, tcfg), tgpt.train, env,
                             str(tmp_path / "ckpt"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


def test_remat_raises():
    """(Named for the refusal it replaced.) ``remat=True`` now recomputes
    each layer in the backward: the same loss and gradients as without."""
    task_kw = dict(seq_len=SEQ, batch_size=BATCH)
    batch = {"input": torch.from_numpy(
        tgpt.make_task(tgpt.tiny_config(), **task_kw).make_batch(np.random.default_rng(0), BATCH)
        ["input"])}
    grads = []
    for remat in (False, True):
        task = tgpt.make_task(tgpt.tiny_config(dtype=torch.float32, remat=remat), **task_kw)
        model = task.init(torch.Generator().manual_seed(0))
        loss, _ = task.loss_fn(model, batch)
        loss.backward()
        grads.append((loss.item(), [p.grad for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def test_next_token_loss_falls_and_predicts_chain():
    """The reference's learning check, on the port: the affine-chain data
    is deterministic except at restarts, so a tiny model learns the
    transition table."""
    task = tgpt.make_task(tgpt.tiny_config(), seq_len=32, batch_size=16,
                          attn_fn=tfa.flash_attention)
    config = ttrain.TrainConfig(steps=80, learning_rate=3e-3, log_every=40)
    _, history = ttrain.Trainer(task, config, torch.device("cpu")).fit()
    assert history[0]["loss"] > history[-1]["loss"]
    assert history[-1]["next_token_accuracy"] > 0.5, history[-1]


def test_tpujob_runs_the_port_entrypoint_through_the_reference_control_plane():
    """The reference controller and kubelet resolve the port's entrypoint
    string like any other and drive it to Succeeded."""
    import threading

    from conftest import wait_for
    from tfk8s_tpu.api import (
        ContainerSpec, ObjectMeta, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, helpers,
    )
    from tfk8s_tpu.client import FakeClientset
    from tfk8s_tpu.runtime import LocalKubelet
    from tfk8s_tpu.trainer import TPUJobController

    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    stop = threading.Event()
    LocalKubelet(cs).run(stop)
    try:
        assert ctrl.run(workers=2, stop=stop, block=False)
        worker = ReplicaSpec(replicas=1, template=ContainerSpec(
            entrypoint="tfk8s_tpu_torch.models.gpt:train", env=_env()))
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name="gpt-torch"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: worker})))

        def finished():
            status = cs.tpujobs().get("gpt-torch").status
            return helpers.is_succeeded(status) or helpers.is_failed(status)

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get("gpt-torch").status
        assert helpers.is_succeeded(status), [c.message for c in status.conditions]
    finally:
        stop.set()
        ctrl.controller.shutdown()


def test_checkpoint_uris_are_refused(monkeypatch):
    """``gs://`` without a fake root and every scheme but ``gs`` and
    ``file`` raise, naming the scheme (tests/test_torch_checkpoint_uri.py
    holds the ones that map)."""
    monkeypatch.delenv("TFK8S_GCS_FAKE_ROOT", raising=False)
    for uri, scheme in (("gs://bucket/run", "gs"), ("s3://bucket/run", "s3")):
        with pytest.raises(NotImplementedError,
                           match=rf"local directories and has no object-store client "
                                 rf"for {scheme}://"):
            Checkpointer(uri)
