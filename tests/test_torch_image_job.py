"""Training and evaluating the port's vision families from packed image
shards (``TFK8S_INPUT_FORMAT=image``), against the JAX package.

- A TPUJob through the reference control plane (``TPUJobController``,
  ``LocalKubelet`` on ``cpu-1``) runs ``tfk8s_tpu_torch.models.resnet:train``
  from JPEG shards to Succeeded and leaves no ``img-decode`` thread. One
  worker: under ``LocalKubelet`` pods are threads of one process, and a
  port process trains on one device (a ``{"data": n}`` gang is one process
  a rank).
- Three ``vit:train`` steps (tiny preset, float32) from the shards follow
  the reference ``Trainer`` on the same shards from the same (bridged)
  initial parameters: loss and gradient norm to rtol 1e-4, the families'
  trajectory tolerance. ViT, not ResNet: the reference's jitted ResNet
  gradients on the CPU are no parity oracle.
- ``run_eval`` on the deterministic eval view of held-out image shards,
  scoring each package's final checkpoint of that run: within atol 1e-4.
- Image shards fed without the format fail loudly with the schema error.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import vit as jvit
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.data.images import pack
from tfk8s_tpu_torch.models import resnet as tresnet
from tfk8s_tpu_torch.models import vit as tvit
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
import _torch_threads  # noqa: F401  (torch's threads under xdist)

RTOL, EVAL_ATOL = 1e-4, 1e-4
CLASSES, IMAGE, PATCH, BATCH, STEPS = 8, 16, 4, 8, 3


@pytest.fixture(scope="module")
def image_shards(tmp_path_factory):
    """96 synthetic JPEGs of 28 px over 8 classes in two training shards,
    and 32 more (another seed) as the held-out set."""
    d = tmp_path_factory.mktemp("imgshards")
    pack.pack_synthetic(str(d / "train"), 96, classes=CLASSES, image_size=28, num_shards=2,
                        seed=1)
    pack.pack_synthetic(str(d / "eval"), 32, classes=CLASSES, image_size=28, num_shards=1,
                        seed=2)
    return str(d / "train" / "images-*.rio"), str(d / "eval" / "images-*.rio")


def _no_decode_threads():
    return not any(t.name.startswith("img-decode") for t in threading.enumerate())


def test_resnet_tpujob_trains_from_image_shards(image_shards):
    from conftest import wait_for
    from tfk8s_tpu.api import (
        ContainerSpec, ObjectMeta, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, TPUSpec,
        helpers,
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
        env = {"TFK8S_DEVICE": "cpu", "TFK8S_TRAIN_STEPS": "6", "TFK8S_LOG_EVERY": "3",
               "TFK8S_BATCH_SIZE": "8", "TFK8S_IMAGE_SIZE": "24", "TFK8S_NUM_CLASSES": "8",
               "TFK8S_RESNET_DEPTH": "18", "TFK8S_RESNET_WIDTH": "8",
               "TFK8S_INPUT_FILES": image_shards[0], "TFK8S_INPUT_FORMAT": "image",
               "TFK8S_DECODE_WORKERS": "2"}
        worker = ReplicaSpec(replicas=1, template=ContainerSpec(
            entrypoint="tfk8s_tpu_torch.models.resnet:train", env=env))
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name="resnet-images-torch"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: worker},
                            tpu=TPUSpec(accelerator="cpu-1"))))

        def finished():
            status = cs.tpujobs().get("resnet-images-torch").status
            return helpers.is_succeeded(status) or helpers.is_failed(status)

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get("resnet-images-torch").status
        assert helpers.is_succeeded(status), [c.message for c in status.conditions]
    finally:
        stop.set()
        ctrl.controller.shutdown()
    # the decode pool died with the job
    assert _no_decode_threads(), [t.name for t in threading.enumerate()]


@pytest.fixture(scope="module")
def vit_runs(image_shards, tmp_path_factory):
    """Three steps of the reference ViT ``Trainer`` and of the port's
    ``vit:train`` from the training shards, both from the port's initial
    parameters (bridged to the reference's tree), each saving its final
    checkpoint: (reference history, port history, reference checkpoint
    dir, port checkpoint dir)."""
    d = tmp_path_factory.mktemp("vitruns")
    jdir, tdir = str(d / "jax"), str(d / "torch")
    kw = dict(num_classes=CLASSES, image_size=IMAGE, patch_size=PATCH, batch_size=BATCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvit, "tiny_config", functools.partial(tvit.tiny_config, dtype=torch.float32))
        tcfg = tvit.tiny_config()
        trainer = ttrain.Trainer(tvit.make_task(tcfg, **kw), ttrain.TrainConfig(),
                                 torch.device("cpu"))
        state = trainer.init_state()
        Checkpointer(tdir).save(0, state.state_dict(), wait=True)
        params = jax.tree_util.tree_map(
            jnp.asarray, bridge.vit_state_dict_to_params(state.model.state_dict(), tcfg))
        jtask = jvit.make_task(jvit.tiny_config(dtype=jnp.float32), **kw)
        jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(
            steps=STEPS, learning_rate=1e-3, log_every=1, checkpoint_dir=jdir,
            input_files=image_shards[0], input_format="image", decode_workers=2),
            make_mesh(data=1))
        jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                                  opt_state=jtr.optimizer.init(params)),
                                jtr.state_shardings)
        _, jh = jtr.fit(state=jstate)
        th = tvit.train({
            "TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny",
            "TFK8S_NUM_CLASSES": str(CLASSES), "TFK8S_IMAGE_SIZE": str(IMAGE),
            "TFK8S_PATCH_SIZE": str(PATCH), "TFK8S_BATCH_SIZE": str(BATCH),
            "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_TRAIN_STEPS": str(STEPS),
            "TFK8S_LOG_EVERY": "1", "TFK8S_CHECKPOINT_DIR": tdir, "TFK8S_WORLD_VERSION": "1",
            "TFK8S_INPUT_FILES": image_shards[0], "TFK8S_INPUT_FORMAT": "image",
            "TFK8S_DECODE_WORKERS": "2"})
    return jh, th, jdir, tdir


def test_vit_image_trajectory_follows_the_reference_trainer(vit_runs):
    jh, th, _, _ = vit_runs
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(1, STEPS + 1))
    want = np.array([(h["loss"], h["grad_norm"]) for h in jh])
    got = np.array([(h["loss"], h["grad_norm"]) for h in th])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert _no_decode_threads()


def test_run_eval_on_image_eval_shards_matches_the_reference(vit_runs, image_shards):
    """Each package's evaluator scores its own step-3 checkpoint of the
    trajectory above on the first two batches of the held-out eval view."""
    _, _, jdir, tdir = vit_runs
    kw = dict(num_classes=CLASSES, image_size=IMAGE, patch_size=PATCH, batch_size=BATCH)
    env = {"TFK8S_TRAIN_STEPS": str(STEPS), "TFK8S_EVAL_TIMEOUT": "30",
           "TFK8S_EVAL_BATCHES": "2", "TFK8S_EVAL_INPUT_FILES": image_shards[1],
           "TFK8S_INPUT_FORMAT": "image", "TFK8S_DECODE_WORKERS": "2"}
    want = jtrain.run_eval(jvit.make_task(jvit.tiny_config(dtype=jnp.float32), **kw),
                           dict(env, TFK8S_CHECKPOINT_DIR=jdir))
    got = ttrain.run_eval(tvit.make_task(tvit.tiny_config(dtype=torch.float32), **kw),
                          dict(env, TFK8S_CHECKPOINT_DIR=tdir, TFK8S_DEVICE="cpu"))
    assert got["step"] == want["step"] == STEPS
    for k in ("loss", "accuracy"):
        assert abs(got[k] - want[k]) <= EVAL_ATOL, (k, got, want)
    assert _no_decode_threads()


@pytest.mark.parametrize("fmt", [None, "array"])
def test_image_shards_without_the_format_fail_loudly(image_shards, fmt):
    """The array codec sees ``image/*`` keys of ragged lengths: the run
    stops on the first batch, naming the format to set."""
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_TRAIN_STEPS": "2", "TFK8S_BATCH_SIZE": "8",
           "TFK8S_IMAGE_SIZE": "24", "TFK8S_NUM_CLASSES": "8", "TFK8S_RESNET_DEPTH": "18",
           "TFK8S_RESNET_WIDTH": "8", "TFK8S_INPUT_FILES": image_shards[0]}
    if fmt is not None:
        env["TFK8S_INPUT_FORMAT"] = fmt
    with pytest.raises(ValueError, match="input_format"):
        tresnet.train(env)


def test_unknown_format_is_refused(image_shards):
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_TRAIN_STEPS": "1", "TFK8S_BATCH_SIZE": "8",
           "TFK8S_IMAGE_SIZE": "24", "TFK8S_RESNET_DEPTH": "18", "TFK8S_RESNET_WIDTH": "8",
           "TFK8S_INPUT_FILES": image_shards[0], "TFK8S_INPUT_FORMAT": "tfrecord"}
    with pytest.raises(ValueError, match=r"unknown input_format 'tfrecord' \(array \| image\)"):
        tresnet.train(env)
