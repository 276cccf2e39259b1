"""The port's BERT MLM against the JAX package's, on the same parameters.

The reference's ``BertWithHead`` is initialised in JAX, its parameter tree
goes through ``tfk8s_tpu_torch.bridge`` into the port's non-causal stack,
and the same numpy MLM batch goes to both. Tiny config in float32: logits,
loss, ``mlm_accuracy`` and every gradient agree to atol 1e-4, with plain
attention on both sides and with flash (the Pallas kernels in interpret
mode on the reference's side, the kernels' plain versions on the port's).
A three-step ``bert:train`` run at the tiny preset follows the reference
``Trainer`` to rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import bert as jbert
from tfk8s_tpu.ops.flash_attention import flash_attention as jax_flash
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.ops import flash_attention as tfa

from _torch_parity import assert_trees_close, assert_trees_equal, numpy_tree, trajectories

ATOL, RTOL = 1e-4, 1e-4
SEQ, BATCH = 16, 2


def _configs(**kw):
    return (jbert.tiny_config(dtype=jnp.float32, **kw),
            tbert.tiny_config(dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed=0):
    ids = jnp.zeros((BATCH, SEQ), jnp.int32)
    return numpy_tree(unbox(jax.jit(jbert.BertWithHead(jcfg).init)(jax.random.key(seed),
                                                                   ids)["params"]))


def _port_model(tcfg, params, attn_fn=None):
    model = tbert.BertWithHead(tcfg, attn_fn=attn_fn)
    model.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    return model


@pytest.mark.parametrize("vocab,seq,batch,seed", [(64, 16, 2, 0), (30522, 40, 3, 7)])
def test_batches_equal_the_reference(vocab, seq, batch, seed):
    want = jbert.make_batch_fn(vocab, seq)(np.random.default_rng(seed), batch)
    got = tbert.make_batch_fn(vocab, seq)(np.random.default_rng(seed), batch)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["mlm_mask"].any() and (got["input"][got["mlm_mask"]] == tbert.MASK_ID).all()


def test_bridge_carries_the_non_causal_stack_unchanged():
    """The GPT bridge maps BERT's tree: same names, round trip exact."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=1)
    model = _port_model(tcfg, params)
    assert set(model.state_dict()) == set(bridge.params_to_state_dict(params, tcfg))
    assert_trees_equal(bridge.state_dict_to_params(model.state_dict(), tcfg), params)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_loss_and_grads_match_jax(impl):
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=2)
    batch = tbert.make_batch_fn(jcfg.vocab_size, SEQ)(np.random.default_rng(2), BATCH)
    model = jbert.BertWithHead(jcfg, attn_fn=jax_flash if impl == "flash" else None)

    def jloss(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["input"]))
        loss, aux = jbert.mlm_loss_and_metrics(logits, jax.tree_util.tree_map(jnp.asarray, batch))
        return loss, (aux, logits)

    (want_loss, (want_aux, want_logits)), want_g = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    tmodel = _port_model(tcfg, params, tfa.flash_attention if impl == "flash" else None)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tmodel(tbatch["input"])
    loss, aux = tbert.mlm_loss_and_metrics(logits, tbatch)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(float(aux["mlm_accuracy"]), float(want_aux["mlm_accuracy"]))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert_trees_close(bridge.state_dict_to_params(grads, tcfg), numpy_tree(want_g), ATOL)


def test_mlm_loss_ignores_unmasked_positions_and_empty_masks():
    logits = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(0))
    target = torch.randint(0, 7, (2, 5), generator=torch.Generator().manual_seed(1))
    none = torch.zeros(2, 5, dtype=torch.bool)
    loss, aux = tbert.mlm_loss_and_metrics(logits, {"target": target, "mlm_mask": none})
    assert loss.item() == 0.0 and aux["mlm_accuracy"].item() == 0.0
    one = none.clone()
    one[1, 3] = True
    loss, _ = tbert.mlm_loss_and_metrics(logits, {"target": target, "mlm_mask": one})
    want = torch.nn.functional.cross_entropy(logits[1, 3][None], target[1, 3][None])
    torch.testing.assert_close(loss, want)


def test_presets_keep_the_reference_shapes():
    for name in ("base_config", "tiny_config"):
        j, t = getattr(jbert, name)(), getattr(tbert, name)()
        for field in ("vocab_size", "embed_dim", "num_heads", "head_dim",
                      "mlp_dim", "num_layers", "max_len", "ln_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert tbert.MASK_RATE == jbert.MASK_RATE and tbert.MASK_ID == jbert.MASK_ID


def test_three_step_train_matches_the_reference_trainer(tmp_path, monkeypatch):
    """``bert:train`` at the tiny preset (float32) against the reference
    Trainer, with flash pinned on both sides."""
    monkeypatch.setattr(tbert, "tiny_config",
                        functools.partial(tbert.tiny_config, dtype=torch.float32))
    jtask = jbert.make_task(jbert.tiny_config(dtype=jnp.float32, attention_impl="flash"),
                            seq_len=SEQ, batch_size=4, attn_fn=jax_flash)
    tcfg = tbert.tiny_config(attention_impl="flash")
    ttask = tbert.make_task(tcfg, seq_len=SEQ, batch_size=4)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
           "TFK8S_BATCH_SIZE": "4", "TFK8S_LEARNING_RATE": "3e-3",
           "TFK8S_ATTENTION_IMPL": "flash"}
    want, got = trajectories(jtask, ttask, lambda sd: bridge.state_dict_to_params(sd, tcfg),
                             tbert.train, env, str(tmp_path / "ckpt"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)

