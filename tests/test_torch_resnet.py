"""The port's ResNet against the JAX package's.

- The parameter bridge round-trips the reference's ``unbox(init)`` tree.
- ``_conv`` and ``max_pool`` pad as JAX's "SAME" does (asymmetric where
  the total is odd), checked in float32 against ``flax.linen.Conv`` and
  ``flax.linen.max_pool`` built here, at odd and even sizes: atol 1e-5.
- The whole model in bfloat16, from the same bridged parameters and the
  same numpy batch, with a random classifier and random last-norm scales
  (the reference zero-inits both, which makes every gradient but the
  classifier's zero). Tolerances and their reason: logits atol 2e-2 and
  loss atol 1e-2; gradients within 5e-2 relative L2 error over all
  parameters together. Both sides round activations to bfloat16 at the
  same places, but their convolutions sum in different orders (oneDNN
  here, XLA there) and flip about one bfloat16 rounding in 10^4 conv
  outputs; GroupNorm over groups of 2-8 values (the 1x1 and 2x2 maps of
  stage 4 at image 32) amplifies such flips in the backward. Measured:
  logits within 1e-6, gradients 1.2% (depth 18) and 1.5% (depth 50). The
  JAX side is compiled with ``xla_allow_excess_precision`` off, so that
  XLA rounds to bfloat16 where the program says it does, as eager JAX and
  the port do; with excess precision on, the jitted reference's
  gradients differ from eager JAX's own by ~900x relative at this size.
- ``ablate_norm``, the loss falling over CPU steps, the env contract, and a
  TPUJob naming ``tfk8s_tpu_torch.models.resnet:train`` running to
  Succeeded through the reference controller and kubelet.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from tfk8s_tpu.models import resnet as jres
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import resnet as tres
from tfk8s_tpu_torch.ops import group_norm as tgn
from tfk8s_tpu_torch.parallel.mesh import MeshConfig
from tfk8s_tpu_torch.runtime import train as ttrain

PAD_ATOL = 1e-5
LOGIT_ATOL, LOSS_ATOL, GRAD_REL = 2e-2, 1e-2, 5e-2
CLASSES, IMAGE, WIDTH = 8, 32, 8


@functools.lru_cache(maxsize=None)
def _jax_init(depth):
    model = jres.ResNet(depth=depth, num_classes=CLASSES, width=WIDTH)
    params = unbox(jax.jit(model.init)(jax.random.key(0),
                                       jnp.zeros((1, IMAGE, IMAGE, 3)))["params"])
    return model, params


def _jax_params(depth):
    """The reference model and a fresh numpy copy of its initial params."""
    model, params = _jax_init(depth)
    return model, jax.tree_util.tree_map(np.array, params)


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("depth", [18, 50])
def test_bridge_round_trip(depth):
    _, params = _jax_params(depth)
    sd = bridge.resnet_params_to_state_dict(params)
    model = tres.ResNet(depth, CLASSES, WIDTH)
    model.load_state_dict(sd, strict=True)  # every name and shape lines up
    back = _leaves(bridge.resnet_state_dict_to_params(model.state_dict()))
    want = _leaves(params)
    assert back.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)
    assert sd["stem.weight"].shape == (WIDTH, 3, 7, 7)  # OIHW
    assert sd["classifier.weight"].shape == (CLASSES, model.classifier.in_features)


@pytest.mark.parametrize("size", [15, 16, 31, 32])
@pytest.mark.parametrize("kernel,strides", [(7, 2), (3, 2), (3, 1), (1, 2), (1, 1)])
def test_conv_same_padding_matches_flax(size, kernel, strides):
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    conv = nn.Conv(6, (kernel, kernel), strides=(strides, strides), padding="SAME",
                   use_bias=False, dtype=jnp.float32)
    p = conv.init(jax.random.key(0), x)
    want = np.asarray(conv.apply(p, x))
    port = tres._conv(5, 6, kernel, strides, dtype=torch.float32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=PAD_ATOL, rtol=0)


@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_max_pool_same_padding_matches_flax(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    x -= 5.0  # all negative: a zero-padded pool would show at the edges
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = tres.max_pool(torch.from_numpy(x), 3, 2).numpy()
    np.testing.assert_allclose(got, want, atol=PAD_ATOL, rtol=0)


@pytest.mark.parametrize("size,kernel,strides,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)), (57, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)),
])
def test_same_padding_amounts(size, kernel, strides, want):
    assert tres.same_padding(size, kernel, strides) == want


def _randomize(params, depth, seed=1):
    """Random classifier and last-norm scales (zero at the reference's init)."""
    rng = np.random.default_rng(seed)
    k = params["classifier"]["kernel"]
    params["classifier"]["kernel"] = (rng.standard_normal(k.shape) * 0.1).astype(np.float32)
    last = "norm3" if depth in jres.BOTTLENECK else "norm2"
    for name, block in params.items():
        if name.startswith("stage"):
            s = block[last]["scale"]
            block[last]["scale"] = rng.standard_normal(s.shape).astype(np.float32)
    return params


@pytest.mark.parametrize("depth", [18, 50])
def test_bf16_model_matches_reference(depth):
    model, params = _jax_params(depth)
    params = _randomize(params, depth)
    batch = jres.make_batch_fn(CLASSES, IMAGE)(np.random.default_rng(2), 4)

    def loss_fn(p):
        logits = model.apply({"params": p}, batch["image"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"])
        return jnp.mean(loss), logits

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (want_loss, want_logits), want_grads = step(params)

    port = tres.ResNet(depth, CLASSES, WIDTH)
    port.load_state_dict(bridge.resnet_params_to_state_dict(params))
    logits = port(torch.from_numpy(batch["image"]))
    loss, _ = tres.loss_and_metrics(logits, torch.from_numpy(batch["label"]))
    loss.backward()
    assert logits.dtype == torch.float32 and logits.shape == (4, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=LOGIT_ATOL, rtol=0)
    assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL
    got = _leaves(bridge.resnet_state_dict_to_params(
        {n: p.grad for n, p in port.named_parameters()}))
    want = _leaves(want_grads)
    assert got.keys() == want.keys()
    err = sum(float(np.sum((got[n] - want[n]) ** 2)) for n in want)
    norm = sum(float(np.sum(want[n] ** 2)) for n in want)
    assert np.sqrt(err / norm) <= GRAD_REL, np.sqrt(err / norm)
    assert all(np.any(g != 0) for g in got.values())  # no vacuous zero gradient


def test_every_norm_site_goes_through_the_fused_kernel_path(monkeypatch):
    calls = []
    real = tres.fused_group_norm
    monkeypatch.setattr(tres, "fused_group_norm",
                        lambda x, *a: calls.append(a[-1]) or real(x, *a))
    port = tres.ResNet(50, CLASSES, WIDTH)
    tres.init_params(port, torch.Generator().manual_seed(0))
    with torch.no_grad():
        port(torch.zeros(1, IMAGE, IMAGE, 3))
    assert len(calls) == 53  # stem + 16 blocks x 3 + 4 projections
    assert sum(calls) == 33  # ReLU fused at stem_norm, norm1 and norm2


def test_ablate_norm_builds_identity_norms():
    with tres.ablate_norm():
        task = tres.make_task(depth=18, num_classes=CLASSES, image_size=IMAGE, width=WIDTH,
                              batch_size=2)
        ablated = tres.ResNet(18, CLASSES, WIDTH)
    normal = tres.ResNet(18, CLASSES, WIDTH)
    assert not any(isinstance(m, tres.GroupNorm) for m in ablated.modules())
    assert isinstance(ablated.stem_norm, torch.nn.ReLU)  # a fused ReLU stays a ReLU
    assert isinstance(ablated.stage1_block1.norm2, torch.nn.Identity)
    assert sum(isinstance(m, tres.GroupNorm) for m in normal.modules()) == 20
    # the task remembers the scope it was built in
    built = task.init(torch.Generator().manual_seed(0))
    assert not any(isinstance(m, tres.GroupNorm) for m in built.modules())


def test_init_follows_the_reference():
    port = tres.init_params(tres.ResNet(50, CLASSES, 16), torch.Generator().manual_seed(0))
    assert not port.classifier.weight.any() and not port.classifier.bias.any()
    assert not port.stage1_block1.norm3.weight.any()
    assert bool((port.stage1_block1.norm1.weight == 1).all())
    w = port.stage3_block2.conv2.weight.detach()  # fan_out = 64 * 3 * 3
    assert abs(float(w.std()) - (2.0 / (64 * 9)) ** 0.5) < 0.05 * (2.0 / (64 * 9)) ** 0.5


def test_batches_are_the_references_byte_for_byte():
    want = jres.make_batch_fn(CLASSES, IMAGE)(np.random.default_rng(7), 3)
    got = tres.make_batch_fn(CLASSES, IMAGE)(np.random.default_rng(7), 3)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_loss_falls_over_cpu_steps():
    task = tres.make_task(depth=18, num_classes=CLASSES, image_size=IMAGE, width=WIDTH,
                          batch_size=16)
    config = ttrain.TrainConfig(steps=30, learning_rate=3e-3, log_every=5)
    _, history = ttrain.Trainer(task, config, torch.device("cpu")).fit()
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["loss"] < history[0]["loss"], [h["loss"] for h in history]


def _env(**kw):
    env = {
        "TFK8S_DEVICE": "cpu", "TFK8S_RESNET_DEPTH": "18", "TFK8S_RESNET_WIDTH": str(WIDTH),
        "TFK8S_IMAGE_SIZE": str(IMAGE), "TFK8S_NUM_CLASSES": str(CLASSES),
        "TFK8S_BATCH_SIZE": "4", "TFK8S_TRAIN_STEPS": "2", "TFK8S_LOG_EVERY": "1",
    }
    env.update(kw)
    return env


def test_train_entrypoint_checkpoints_and_counts_no_card_launch(tmp_path):
    from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

    tgn.reset_launches()
    history = tres.train(_env(TFK8S_CHECKPOINT_DIR=str(tmp_path)))
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and "accuracy" in h for h in history)
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    assert tgn.LAUNCHES == dict.fromkeys(tgn.KERNELS, 0)  # the CPU runs the plain path


@pytest.mark.parametrize("extra,ranks", [
    # image input runs (tests/test_torch_image_job.py); its four-device
    # layout in one process runs as the pod's four ranks, which the entry
    # point starts on itself (tests/test_torch_pod_ranks.py runs them)
    ({"TFK8S_INPUT_FILES": "shards/*.rio", "TFK8S_INPUT_FORMAT": "image",
      "TFK8S_NUM_PROCESSES": "1", "TFK8S_MESH": '{"data": 4}'}, 4),
    # multislice runs (tests/test_torch_multislice.py), and pipeline beside
    # expert in a gang (tests/test_torch_pipeline_axes.py); one of four
    # processes outside a process group holds one device of the four
    ({"TFK8S_NUM_PROCESSES": "4", "TFK8S_MESH": '{"pipeline": 2, "expert": 2}'}, 1),
])
def test_unported_input_raises(extra, ranks, monkeypatch):
    from tfk8s_tpu_torch.runtime import pod_ranks

    MeshConfig.from_env(extra).require_ported()  # the layout passes the mesh rules
    pods = []
    monkeypatch.setattr(pod_ranks, "run", lambda *args: pods.append(args) or [])
    if ranks > 1:
        assert tres.train(_env(**extra)) == []
        assert pods == [("tfk8s_tpu_torch.models.resnet:train", _env(**extra), None, ranks)]
    else:
        with pytest.raises(ValueError, match=r"needs 4 devices; 1 available"):
            tres.train(_env(**extra))
        assert pods == []


def test_tpujob_runs_the_resnet_entrypoint_through_the_reference_control_plane():
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
            entrypoint="tfk8s_tpu_torch.models.resnet:train", env=_env()))
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name="resnet-torch"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: worker})))

        def finished():
            status = cs.tpujobs().get("resnet-torch").status
            return helpers.is_succeeded(status) or helpers.is_failed(status)

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get("resnet-torch").status
        assert helpers.is_succeeded(status), [c.message for c in status.conditions]
    finally:
        stop.set()
        ctrl.controller.shutdown()
