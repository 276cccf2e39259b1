"""The port's ViT against the JAX package's, on the same parameters.

The reference's ``ViT`` is initialised in JAX, its tree goes through
``bridge.vit_params_to_state_dict``, and the same numpy template batch
(``resnet.make_batch_fn``, shared by both vision families) goes to both.
Tiny config in float32: logits, loss, accuracy and every gradient agree
to atol 1e-4, with plain attention and with flash (the Pallas kernels in
interpret mode on the reference's side, the kernels' plain versions on
the port's), at 64 patches and at 49 (a length that is not a multiple of
8, as ViT-B/16's 196 is not of the card kernels' tiles). In bfloat16 the
mean-pool reduces in float32 and rounds back to bfloat16, as ``jnp.mean``
does, so the logits agree with the reference's. A three-step ``vit:train``
run at the tiny preset follows the reference ``Trainer`` to rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfk8s_tpu.models import vit as jvit
from tfk8s_tpu.ops.flash_attention import flash_attention as jax_flash
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import resnet as tresnet
from tfk8s_tpu_torch.models import vit as tvit
from tfk8s_tpu_torch.ops import flash_attention as tfa

from _torch_parity import assert_trees_close, assert_trees_equal, numpy_tree, trajectories
import _torch_threads  # noqa: F401  (torch's threads under xdist)

ATOL, RTOL = 1e-4, 1e-4
CLASSES, PATCH, BATCH = 8, 4, 2


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, image, seed=0):
    model = jvit.ViT(jcfg, num_classes=CLASSES, patch_size=PATCH)
    x = jnp.zeros((BATCH, image, image, 3), jnp.float32)
    return numpy_tree(unbox(jax.jit(model.init)(jax.random.key(seed), x)["params"]))


def _port_model(tcfg, params, image, attn_fn=None):
    model = tvit.ViT(tcfg, CLASSES, PATCH, image, attn_fn=attn_fn)
    model.load_state_dict(bridge.vit_params_to_state_dict(params, tcfg))
    return model


def _batch(image, seed):
    return tresnet.make_batch_fn(CLASSES, image)(np.random.default_rng(seed), BATCH)


def test_bridge_round_trips():
    jcfg, tcfg = jvit.tiny_config(dtype=jnp.float32), tvit.tiny_config(dtype=torch.float32)
    params = _jax_params(jcfg, 32, seed=1)
    model = _port_model(tcfg, params, 32)
    assert set(model.state_dict()) == set(bridge.vit_params_to_state_dict(params, tcfg))
    assert_trees_equal(bridge.vit_state_dict_to_params(model.state_dict(), tcfg), params)


@pytest.mark.parametrize("image", [32, 28])
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_loss_and_grads_match_jax(impl, image):
    jcfg, tcfg = jvit.tiny_config(dtype=jnp.float32), tvit.tiny_config(dtype=torch.float32)
    params = _jax_params(jcfg, image, seed=2)
    batch = _batch(image, seed=2)
    jattn = jax_flash if impl == "flash" else None
    model = jvit.ViT(jcfg, num_classes=CLASSES, patch_size=PATCH, attn_fn=jattn)

    def jloss(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["image"]))
        labels = jnp.asarray(batch["label"])
        loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, labels))
        acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
        return loss, (acc, logits)

    (want_loss, (want_acc, want_logits)), want_g = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    tmodel = _port_model(tcfg, params, image, tfa.flash_attention if impl == "flash" else None)
    logits = tmodel(torch.from_numpy(batch["image"]))
    loss, aux = tresnet.loss_and_metrics(logits, torch.from_numpy(batch["label"]))
    loss.backward()
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(float(aux["accuracy"]), float(want_acc))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert_trees_close(bridge.vit_state_dict_to_params(grads, tcfg), numpy_tree(want_g), ATOL)


def test_bf16_pool_rounds_as_the_reference():
    """The mean-pool of bfloat16 tokens equals ``jnp.mean``'s bit for bit
    (float32 sum, bfloat16 mean); a float32 mean left unrounded does not.
    The whole bfloat16 model then stays within bfloat16 noise of the
    reference's logits."""
    x = np.random.default_rng(0).standard_normal((4, 196, 768)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jnp.mean(jnp.asarray(x).astype(jnp.bfloat16), axis=1).astype(jnp.float32))
    got = tvit.mean_pool(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = xb.mean(dim=1, dtype=torch.float32).numpy()
    assert (unrounded != want).mean() > 0.5

    jcfg, tcfg = jvit.tiny_config(), tvit.tiny_config()
    params = _jax_params(jcfg, 32, seed=3)
    batch = _batch(32, seed=3)
    ref = np.asarray(jax.jit(jvit.ViT(jcfg, num_classes=CLASSES, patch_size=PATCH).apply)(
        {"params": params}, jnp.asarray(batch["image"])))
    with torch.no_grad():
        out = _port_model(tcfg, params, 32)(torch.from_numpy(batch["image"])).numpy()
    assert out.dtype == np.float32 and ref.dtype == np.float32
    assert np.abs(out - ref).max() <= 2e-2 * max(1.0, np.abs(ref).max())


def test_patches_in_the_reference_order(monkeypatch):
    """Patch t of image b holds pixels (grid row, grid col, patch row,
    patch col, channel) in that order."""
    cfg = tvit.tiny_config(dtype=torch.float32, num_layers=0)
    model = tvit.ViT(cfg, CLASSES, PATCH, 8)
    captured, real = {}, tvit._dense

    def spy(layer, x, dtype):
        if layer is model.patch_embed:
            captured["x"] = x
        return real(layer, x, dtype)

    monkeypatch.setattr(tvit, "_dense", spy)
    images = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    model(images)
    x = captured["x"]
    assert x.shape == (2, 4, PATCH * PATCH * 3)
    # patch 2 of image 1 is (grid row 1, grid col 0): rows 4-7, cols 0-3
    torch.testing.assert_close(x[1, 2], images[1, 4:8, 0:4, :].reshape(-1))


def test_three_step_train_matches_the_reference_trainer(tmp_path, monkeypatch):
    """``vit:train`` at the tiny preset (float32) against the reference
    Trainer, with flash pinned on both sides."""
    monkeypatch.setattr(tvit, "tiny_config",
                        functools.partial(tvit.tiny_config, dtype=torch.float32))
    kw = dict(num_classes=CLASSES, image_size=16, patch_size=PATCH, batch_size=4)
    jtask = jvit.make_task(jvit.tiny_config(dtype=jnp.float32, attention_impl="flash"),
                           attn_fn=jax_flash, **kw)
    tcfg = tvit.tiny_config(attention_impl="flash")
    ttask = tvit.make_task(tcfg, **kw)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_NUM_CLASSES": "8",
           "TFK8S_IMAGE_SIZE": "16", "TFK8S_PATCH_SIZE": str(PATCH), "TFK8S_BATCH_SIZE": "4",
           "TFK8S_LEARNING_RATE": "1e-3", "TFK8S_ATTENTION_IMPL": "flash"}
    want, got = trajectories(jtask, ttask, lambda sd: bridge.vit_state_dict_to_params(sd, tcfg),
                             tvit.train, env, str(tmp_path / "ckpt"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


def test_presets_keep_the_reference_shapes():
    for name in ("base_config", "tiny_config"):
        j, t = getattr(jvit, name)(), getattr(tvit, name)()
        for field in ("embed_dim", "num_heads", "head_dim", "mlp_dim", "num_layers", "ln_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)


def test_image_not_divisible_by_the_patch_raises():
    with pytest.raises(ValueError, match="not divisible"):
        tvit.ViT(tvit.tiny_config(), CLASSES, 5, 32)
