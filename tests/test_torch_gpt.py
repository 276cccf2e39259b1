"""The port's GPT against the JAX package's, on the same parameters.

The reference's ``GPTLM`` is initialised in JAX, its parameter tree goes
through ``tfk8s_tpu_torch.bridge`` into the port's ``state_dict``, and the
same numpy token batch goes to both. Tiny config in float32: logits, loss
and every gradient agree to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.ops.flash_attention import flash_attention as jax_flash
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-4
SEQ, BATCH = 16, 2


def _configs(**kw):
    return (jgpt.tiny_config(dtype=jnp.float32, **kw),
            tgpt.tiny_config(dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    ids = jnp.zeros((BATCH, SEQ), jnp.int32)
    params = unbox(jax.jit(jgpt.GPTLM(jcfg).init)(jax.random.key(seed), ids)["params"])
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(tcfg, params, attn_fn=None):
    model = tgpt.GPTLM(tcfg, attn_fn=attn_fn)
    model.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    return model


def _ids(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return tgpt.make_batch_fn(vocab, SEQ)(rng, BATCH)["input"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_bridge_round_trips():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=1)
    model = _port_model(tcfg, params)
    back = _flat(bridge.state_dict_to_params(model.state_dict(), tcfg))
    want = _flat(params)
    assert back.keys() == want.keys()
    for name, arr in want.items():
        assert back[name].shape == arr.shape, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # and every port parameter is named by the mapping
    assert set(model.state_dict()) == set(bridge.params_to_state_dict(params, tcfg))


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_match_jax(impl):
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    ids = _ids(jcfg.vocab_size)
    jattn = jax_flash if impl == "flash" else None
    want = jgpt.GPTLM(jcfg, attn_fn=jattn).apply({"params": params}, jnp.asarray(ids))
    tattn = tfa.flash_attention if impl == "flash" else None
    got = _port_model(tcfg, params, tattn)(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, jcfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_loss_and_grads_match_jax_grad():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=2)
    ids = _ids(jcfg.vocab_size, seed=2)
    # the JAX side takes plain attention (causal rows are never dead, so
    # it is the flash kernels' function); the port takes its flash path
    model = jgpt.GPTLM(jcfg)

    def jloss(p):
        return jgpt.lm_loss_and_metrics(model.apply({"params": p}, jnp.asarray(ids)),
                                        jnp.asarray(ids))

    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tmodel = _port_model(tcfg, params, tfa.flash_attention)
    tid = torch.from_numpy(ids)
    loss, aux = tgpt.lm_loss_and_metrics(tmodel(tid), tid)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(float(aux["next_token_accuracy"]),
                               float(want_aux["next_token_accuracy"]))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    got = _flat(bridge.state_dict_to_params(grads, tcfg))
    want = _flat(jax.tree_util.tree_map(np.asarray, want_g))
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, atol=ATOL, err_msg=name)


def test_flash_equals_full_in_the_port():
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    full = tgpt.make_task(tcfg, seq_len=SEQ, batch_size=BATCH).init(gen)
    flash = tgpt.GPTLM(tcfg, attn_fn=tfa.flash_attention)
    flash.load_state_dict(full.state_dict())
    tid = torch.from_numpy(_ids(tcfg.vocab_size, seed=3))
    outs = []
    for model in (full, flash):
        loss, _ = tgpt.lm_loss_and_metrics(model(tid), tid)
        loss.backward()
        outs.append((model(tid).detach(), {n: p.grad for n, p in model.named_parameters()}))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-5, rtol=0)
    for name, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][name], g, atol=ATOL, rtol=0, msg=name)


def test_chain_tokens_equal_the_reference_stream():
    from tfk8s_tpu.models.bert import make_chain_tokens as jax_chain
    from tfk8s_tpu_torch.models.bert import make_chain_tokens as port_chain

    want = jax_chain(np.random.default_rng(5), 3, 40, 97)
    got = port_chain(np.random.default_rng(5), 3, 40, 97)
    np.testing.assert_array_equal(got, want)


def test_presets_keep_the_reference_shapes():
    for name in ("base_config", "tiny_config", "mid_config"):
        j, t = getattr(jgpt, name)(), getattr(tgpt, name)()
        for field in ("vocab_size", "embed_dim", "num_heads", "head_dim",
                      "mlp_dim", "num_layers", "max_len", "ln_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert tgpt.base_config().dtype == torch.bfloat16


def test_initial_weights_have_the_reference_scales():
    """Draws differ between the frameworks; the initialisers' spreads may
    not: xavier-uniform over (fan_in=E, fan_out=H*D), normal(0.02)
    embeddings, zero biases, unit norms."""
    cfg = tgpt.mid_config(dtype=torch.float32)
    model = tgpt.make_task(cfg).init(torch.Generator().manual_seed(0))
    e, hd = cfg.embed_dim, cfg.num_heads * cfg.head_dim
    bound = np.sqrt(6.0 / (e + hd))
    w = model.layers[0].attn.q.weight.detach().numpy()
    assert w.shape == (hd, e) and np.abs(w).max() <= bound
    np.testing.assert_allclose(w.std(), bound / np.sqrt(3.0), rtol=0.05)
    np.testing.assert_allclose(model.embed.tok.weight.std().item(), 0.02, rtol=0.05)
    assert model.layers[0].attn.q.bias.abs().max().item() == 0.0
    assert (model.ln_final.weight - 1).abs().max().item() == 0.0
