"""The port's MLP classifier (``tfk8s_tpu_torch.models.mlp``) against the
JAX package's, on the CPU in float32: the same numpy batches, the same
bridged parameters, logits, loss and every gradient within 1e-4; the
initializer's scale; and ``mlp:train`` through the reference's
``LocalKubelet`` to a succeeded TPUJob that met its accuracy target.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tfk8s_tpu.runtime.kubelet as kubelet_mod
from tfk8s_tpu.api.types import (
    ContainerSpec,
    JobConditionType,
    ObjectMeta,
    ReplicaSpec,
    ReplicaType,
    TPUJob,
    TPUJobSpec,
    TPUSpec,
)
from tfk8s_tpu.api import helpers
from tfk8s_tpu.client import FakeClientset
from tfk8s_tpu.models import mlp as jmlp
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import LocalKubelet
from tfk8s_tpu.trainer import TPUJobController
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.runtime import train as ttrain

from conftest import wait_for
import _torch_threads  # noqa: F401  (torch's threads under xdist)

ATOL = 1e-4


def _params(hidden, seed=0):
    model = jmlp.MLP(hidden=hidden)
    params = unbox(model.init(jax.random.key(seed), jnp.zeros((1, jmlp.IMAGE_DIM)))["params"])
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_batches_are_the_reference_batches():
    for seed in (0, 7):
        want = jmlp.make_batch(np.random.default_rng(seed), 32)
        got = tmlp.make_batch(np.random.default_rng(seed), 32)
        assert np.array_equal(got["image"], want["image"])
        assert np.array_equal(got["label"], want["label"])


@pytest.mark.parametrize("hidden", [64, 256])
def test_logits_loss_and_grads_match_the_reference(hidden):
    jmodel, params = _params(hidden)
    batch = jmlp.make_batch(np.random.default_rng(3), 16)

    def jloss(p):
        logits = jmodel.apply({"params": p}, batch["image"])
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]))
        return loss, logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = tmlp.MLP(hidden=hidden)
    model.load_state_dict(bridge.mlp_params_to_state_dict(params))
    logits = model(torch.from_numpy(batch["image"]))
    loss, metrics = tmlp.loss_and_metrics(logits, torch.from_numpy(batch["label"]))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    want_acc = float(np.mean(np.asarray(want_logits).argmax(-1) == batch["label"]))
    assert metrics["accuracy"].item() == pytest.approx(want_acc)
    for name in ("fc1", "fc2"):
        np.testing.assert_allclose(getattr(model, name).weight.grad.numpy(),
                                   np.asarray(want_grads[name]["kernel"]).T, atol=ATOL)
        np.testing.assert_allclose(getattr(model, name).bias.grad.numpy(),
                                   np.asarray(want_grads[name]["bias"]), atol=ATOL)


def test_init_is_lecun_normal_with_zero_biases():
    """flax's ``lecun_normal``: variance 1/fan_in after truncation at two
    standard deviations of the untruncated normal."""
    model = tmlp.init_params(tmlp.MLP(hidden=256), torch.Generator().manual_seed(0))
    w = model.fc1.weight.detach()
    std = (1.0 / tmlp.IMAGE_DIM) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 * std / tmlp._TRUNC_STD
    assert not model.fc1.bias.any() and not model.fc2.bias.any()
    _, params = _params(256)
    flax_std = float(np.std(params["fc1"]["kernel"]))
    assert abs(w.std().item() / flax_std - 1.0) < 0.02


def test_evaluate_is_a_later_item(tmp_path):
    """``mlp:evaluate`` is the Evaluator's entrypoint now: it needs a
    checkpoint directory, and scores the final checkpoint in it."""
    with pytest.raises(RuntimeError, match="TFK8S_CHECKPOINT_DIR"):
        tmlp.evaluate({"TFK8S_DEVICE": "cpu"})
    config = ttrain.TrainConfig(steps=2, checkpoint_dir=str(tmp_path))
    ttrain.Trainer(tmlp.make_task(), config, torch.device("cpu")).fit()
    metrics = tmlp.evaluate({"TFK8S_DEVICE": "cpu", "TFK8S_CHECKPOINT_DIR": str(tmp_path),
                             "TFK8S_TRAIN_STEPS": "2", "TFK8S_EVAL_TIMEOUT": "30"})
    assert metrics["step"] == 2.0
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0


def test_mlp_train_succeeds_under_the_reference_kubelet(monkeypatch):
    """``tfk8s_tpu_torch.models.mlp:train`` as a TPUJob's entrypoint: the
    reference controller and ``LocalKubelet`` run it to Succeeded, which
    needs the run to reach its accuracy target (0.9 at 300 steps)."""
    monkeypatch.setattr(kubelet_mod, "LOG_FLUSH_SECONDS", 0.05)
    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    kubelet = LocalKubelet(cs)
    stop = threading.Event()
    kubelet.run(stop)
    assert ctrl.run(workers=1, stop=stop, block=False)
    try:
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name="torch-mlp"),
            spec=TPUJobSpec(
                replica_specs={ReplicaType.WORKER: ReplicaSpec(
                    replicas=1, template=ContainerSpec(
                        entrypoint="tfk8s_tpu_torch.models.mlp:train",
                        env={"TFK8S_DEVICE": "cpu", "TFK8S_LOG_EVERY": "50"}))},
                tpu=TPUSpec(accelerator="cpu-1"),
            ),
        ))

        def finished():
            status = cs.tpujobs().get("torch-mlp").status
            return (helpers.has_condition(status, JobConditionType.SUCCEEDED)
                    or helpers.has_condition(status, JobConditionType.FAILED))

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get("torch-mlp").status
        assert helpers.has_condition(status, JobConditionType.SUCCEEDED), status
    finally:
        stop.set()
        ctrl.controller.shutdown()
