"""The port's Mixture-of-Experts against the JAX package's, on the same
parameters and batches.

- ``compute_dispatch`` equals the reference's exactly, top-1 and top-2,
  with capacity overflow and with exact ties (both argmaxes take the first
  maximum);
- ``SwitchMoeBlock`` output and aux loss within atol 1e-5, and identical
  experts with ample capacity equal the gate-weighted dense MLP;
- the MoE GPT, BERT, T5 (encoder MoE) and ViT: logits, loss, ``moe_aux``
  and every gradient within atol 1e-4, flax parameters bridged;
- three-step ``train(env)`` runs at ``TFK8S_NUM_EXPERTS=2`` (top-1 and
  top-2) follow the reference ``Trainer`` to rtol 1e-4;
- greedy ``generate`` of an MoE GPT gives the reference's tokens;
- ``remat`` leaves the loss and every gradient within atol 1e-6.

Tiny float32 configs throughout (the presets are bf16: the trajectory
tests patch ``tiny_config`` to float32, as the family tests do).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import bert as jbert
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.models import t5 as jt5
from tfk8s_tpu.models import vit as jvit
from tfk8s_tpu.models.transformer import apply_with_aux as japply_with_aux
from tfk8s_tpu.parallel import moe as jmoe
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.models import vit as tvit
from tfk8s_tpu_torch.models.transformer import MlpBlock, apply_with_aux
from tfk8s_tpu_torch.parallel import moe as tmoe

from _torch_parity import assert_trees_close, numpy_tree, trajectories

ATOL, RTOL = 1e-4, 1e-4
BLOCK_ATOL = 1e-5
REMAT_ATOL = 1e-6
SEQ, BATCH, EXPERTS = 16, 2, 2
CLASSES, IMAGE, PATCH = 8, 16, 4


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("top_k,capacity", [(1, 2), (1, 16), (2, 2), (2, 16)])
def test_compute_dispatch_equals_the_reference(top_k, capacity):
    rng = np.random.default_rng(10 * top_k + capacity)
    logits = rng.standard_normal((3, 16, 4)).astype(np.float32)
    logits[0, :4] = 0.0  # exact ties among all experts
    logits[1, :3, 1:3] = 5.0  # a tie between two experts
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jmoe.compute_dispatch(jnp.asarray(probs), top_k, capacity))
    got = tmoe.compute_dispatch(torch.from_numpy(probs.copy()), top_k, capacity).numpy()
    np.testing.assert_array_equal(got, want)
    routed = (got > 0).sum(axis=(2, 3))
    if capacity == 2:
        assert (routed == 0).any()  # overflow dropped some tokens to the residual
    else:
        assert (routed == top_k).all()


def test_argmax_ties_take_the_first_maximum():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 1.0, 1.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)).tolist()
    assert torch.argmax(torch.from_numpy(x), dim=-1).tolist() == want == [1, 0, 2]


def _block_cfgs(**kw):
    base = dict(vocab_size=32, embed_dim=16, num_heads=2, head_dim=8, mlp_dim=32,
                num_layers=1, max_len=32)
    base.update(kw)
    from tfk8s_tpu.models.transformer import TransformerConfig as JCfg
    from tfk8s_tpu_torch.models.transformer import TransformerConfig as TCfg

    return JCfg(dtype=jnp.float32, **base), TCfg(dtype=torch.float32, **base)


@pytest.mark.parametrize("top_k", [1, 2])
def test_switch_block_output_and_aux_match_jax(top_k):
    jcfg, tcfg = _block_cfgs()
    x = np.random.default_rng(top_k).standard_normal((2, 8, 16)).astype(np.float32)
    jblock = jmoe.SwitchMoeBlock(jcfg, num_experts=4, capacity_factor=0.5, top_k=top_k)
    params = numpy_tree(unbox(jblock.init(jax.random.key(top_k), jnp.asarray(x))["params"]))
    want_y, want_aux = jblock.apply({"params": params}, jnp.asarray(x))

    tblock = tmoe.SwitchMoeBlock(tcfg, 4, 0.5, top_k)
    tblock.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    y, aux = tblock(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=BLOCK_ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=BLOCK_ATOL)
    # c = top_k slots an expert: some tokens drop to the residual
    assert y.dtype == torch.float32 and (y.detach().abs().sum(-1) == 0).any()


def test_identical_experts_equal_the_dense_mlp():
    """Every expert holding the dense MLP's weights, with ample capacity:
    the block is the gate-weighted MLP, whatever the routing."""
    _, tcfg = _block_cfgs()
    gen = torch.Generator().manual_seed(0)
    dense = MlpBlock(tcfg)
    with torch.no_grad():
        for lin in (dense.wi, dense.wo):
            lin.weight.normal_(0.0, 0.3, generator=gen)
            lin.bias.zero_()
    block = tmoe.SwitchMoeBlock(tcfg, 4, capacity_factor=4.0)
    block.init_weights(gen)
    with torch.no_grad():
        block.wi.copy_(dense.wi.weight.t().expand_as(block.wi))
        block.wo.copy_(dense.wo.weight.t().expand_as(block.wo))
    x = torch.randn(2, 8, 16, generator=gen)
    y, aux = block(x)
    gate = torch.softmax(x @ block.router, dim=-1).max(dim=-1).values
    torch.testing.assert_close(y, dense(x) * gate[..., None], atol=BLOCK_ATOL, rtol=0)
    assert torch.isfinite(aux)


def test_init_slices_the_whole_draw_for_an_expert_rank():
    """An expert rank's block starts from its rows of the one-process
    draw, so every layout trains from the same parameters."""
    _, tcfg = _block_cfgs()
    whole = tmoe.SwitchMoeBlock(tcfg, 4)
    whole.init_weights(torch.Generator().manual_seed(3))
    part = tmoe.SwitchMoeBlock(tcfg, 4, experts=tmoe.ExpertShard(None, 1, 2))
    part.init_weights(torch.Generator().manual_seed(3))
    assert part.expert_range == (2, 4) and part.wi.shape[0] == 2
    assert torch.equal(part.wi, whole.wi[2:]) and torch.equal(part.wo, whole.wo[2:])
    assert torch.equal(part.router, whole.router)


# -- the families --------------------------------------------------------------


def _inputs(family, batch):
    if family == "t5":
        return batch["src"], batch["tgt_in"]
    return (batch["image"],) if family == "vit" else (batch["input"],)


FAMILIES = {
    # family: (reference module, port module, to port, to reference, task kw)
    "gpt": (jgpt, tgpt, bridge.params_to_state_dict, bridge.state_dict_to_params,
            dict(seq_len=SEQ)),
    "bert": (jbert, tbert, bridge.params_to_state_dict, bridge.state_dict_to_params,
             dict(seq_len=SEQ)),
    "t5": (jt5, tt5, bridge.t5_params_to_state_dict, bridge.t5_state_dict_to_params,
           dict(seq_len=SEQ)),
    "vit": (jvit, tvit, bridge.vit_params_to_state_dict, bridge.vit_state_dict_to_params,
            dict(num_classes=CLASSES, image_size=IMAGE, patch_size=PATCH)),
}


def _jmodel(family, jcfg):
    if family == "gpt":
        return jgpt.GPTLM(jcfg)
    if family == "bert":
        return jbert.BertWithHead(jcfg)
    if family == "t5":
        return jt5.T5(jcfg)
    return jvit.ViT(jcfg, num_classes=CLASSES, patch_size=PATCH)


@functools.lru_cache(maxsize=None)
def _jax_params(family, jcfg, seed):
    jmod, _, _, _, kw = FAMILIES[family]
    return numpy_tree(unbox(jmod.make_task(cfg=jcfg, batch_size=BATCH, **kw).init(
        jax.random.key(seed))))


@pytest.mark.parametrize("family,top_k", [("gpt", 1), ("gpt", 2), ("bert", 1), ("t5", 2),
                                          ("vit", 1)])
def test_moe_family_logits_loss_aux_and_grads_match_jax(family, top_k):
    jmod, tmod, to_sd, to_params, kw = FAMILIES[family]
    ckw = dict(num_experts=EXPERTS, moe_top_k=top_k)
    jcfg = jmod.tiny_config(dtype=jnp.float32, **ckw)
    tcfg = tmod.tiny_config(dtype=torch.float32, **ckw)
    params = _jax_params(family, jcfg, 5)
    jtask = jmod.make_task(cfg=jcfg, batch_size=BATCH, **kw)
    batch = jtask.make_batch(np.random.default_rng(5), BATCH)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    key = jax.random.key(0)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, jbatch, key), has_aux=True))(params)
    want_logits, want_aux = jax.jit(lambda p: japply_with_aux(
        _jmodel(family, jcfg), jcfg, p, *_inputs(family, jbatch)))(params)

    ttask = tmod.make_task(cfg=tcfg, batch_size=BATCH, **kw)
    model = ttask.init(torch.Generator().manual_seed(0))
    model.load_state_dict(to_sd(params, tcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = ttask.loss_fn(model, tbatch)
    loss.backward()
    with torch.no_grad():
        logits, aux = apply_with_aux(model, tcfg, *_inputs(family, tbatch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    assert metrics.keys() == want_m.keys()
    for name in want_m:
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), atol=ATOL,
                                   err_msg=name)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert_trees_close(to_params(grads, tcfg), numpy_tree(want_g), ATOL)


def test_t5_moe_sits_in_the_encoder_only():
    model = tt5.T5(tt5.tiny_config(num_experts=2, num_layers=4))
    moe = [n for n, _ in model.named_modules() if n.endswith(".moe") or n.endswith("moe")]
    assert moe == ["enc1.moe", "enc3.moe"]


def test_bridge_round_trips_the_moe_layers_and_slices_an_expert_share():
    jcfg = jgpt.tiny_config(dtype=jnp.float32, num_experts=4)
    tcfg = tgpt.tiny_config(dtype=torch.float32, num_experts=4)
    params = _jax_params("gpt", jcfg, 1)
    sd = bridge.params_to_state_dict(params, tcfg)
    assert {"layers.1.moe.router", "layers.1.moe.wi", "layers.1.moe.wo"} <= set(sd)
    assert not any(k.startswith("layers.1.mlp") for k in sd)
    back = bridge.state_dict_to_params(sd, tcfg)
    for name in ("router", "wi", "wo"):
        np.testing.assert_array_equal(back["layer1"]["moe"][name], params["layer1"]["moe"][name])
    half = bridge.params_to_state_dict(params, tcfg, experts=(2, 4))
    np.testing.assert_array_equal(half["layers.1.moe.wi"].numpy(),
                                  params["layer1"]["moe"]["wi"][2:4])
    shard = tmoe.ExpertShard(None, 1, 2)
    model = tgpt.BertWithHead(tcfg, causal=True)
    model.layers[1].moe = tmoe.SwitchMoeBlock(tcfg, 4, experts=shard)
    model.load_state_dict(half)


_TRAJ = [("gpt", 1), ("gpt", 2), ("bert", 1), ("bert", 2), ("t5", 1), ("t5", 2), ("vit", 1),
         ("vit", 2)]


@pytest.mark.parametrize("family,top_k", _TRAJ)
def test_three_step_moe_train_matches_the_reference_trainer(family, top_k, tmp_path,
                                                            monkeypatch):
    jmod, tmod, _, to_params, kw = FAMILIES[family]
    monkeypatch.setattr(tmod, "tiny_config",
                        functools.partial(tmod.tiny_config, dtype=torch.float32))
    ckw = dict(num_experts=EXPERTS, moe_top_k=top_k)
    jtask = jmod.make_task(cfg=jmod.tiny_config(dtype=jnp.float32, **ckw), batch_size=4, **kw)
    tcfg = tmod.tiny_config(**ckw)
    ttask = tmod.make_task(cfg=tcfg, batch_size=4, **kw)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_BATCH_SIZE": "4",
           "TFK8S_LEARNING_RATE": "3e-3", "TFK8S_NUM_EXPERTS": str(EXPERTS),
           "TFK8S_MOE_TOP_K": str(top_k), "TFK8S_ATTENTION_IMPL": "full"}
    if family == "vit":
        env.update(TFK8S_NUM_CLASSES=str(CLASSES), TFK8S_IMAGE_SIZE=str(IMAGE),
                   TFK8S_PATCH_SIZE=str(PATCH))
    else:
        env["TFK8S_SEQ_LEN"] = str(SEQ)
    want, got = trajectories(jtask, ttask, lambda sd: to_params(sd, tcfg), tmod.train, env,
                             str(tmp_path / "ckpt"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


# GPT with 8 experts at a reduced width (float32), as the card's MoE run
# takes it: every other layer MoE, top-1, lr 3e-4, ten steps
REDUCED = dict(vocab_size=512, embed_dim=128, num_heads=4, head_dim=32, mlp_dim=512,
               num_layers=4, max_len=64)


def test_ten_moe_gpt_steps_at_a_reduced_width_follow_the_reference(tmp_path, monkeypatch):
    """Loss, ``moe_aux`` and grad norm of ten ``gpt:train`` steps with 8
    experts against the reference Trainer's, rtol 1e-4: the logged loss
    is the LM loss plus ``moe_aux_weight * moe_aux``, and how the router's
    balance moves over the first steps is the reference's own.
    ``pytest -s`` prints both trajectories and the LM part."""
    monkeypatch.setattr(tgpt, "tiny_config", functools.partial(
        tgpt.tiny_config, dtype=torch.float32, **REDUCED))
    ckw = dict(num_experts=8, **REDUCED)
    jtask = jgpt.make_task(cfg=jgpt.tiny_config(dtype=jnp.float32, **ckw), seq_len=64,
                           batch_size=8)
    tcfg = tgpt.tiny_config(num_experts=8)
    ttask = tgpt.make_task(cfg=tcfg, seq_len=64, batch_size=8)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_BATCH_SIZE": "8",
           "TFK8S_SEQ_LEN": "64", "TFK8S_LEARNING_RATE": "3e-4", "TFK8S_NUM_EXPERTS": "8",
           "TFK8S_ATTENTION_IMPL": "full"}
    want, got = trajectories(jtask, ttask, lambda sd: bridge.state_dict_to_params(sd, tcfg),
                             tgpt.train, env, str(tmp_path / "ckpt"), steps=10,
                             keys=("loss", "moe_aux", "grad_norm"))
    for name, rows in (("reference", want), ("port", got)):
        print(name, [{"loss": l, "moe_aux": a, "lm_loss": l - tcfg.moe_aux_weight * a,
                      "grad_norm": g} for l, a, g in rows])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


def test_moe_gpt_greedy_generate_gives_the_reference_tokens():
    jcfg = jgpt.tiny_config(dtype=jnp.float32, num_experts=EXPERTS)
    tcfg = tgpt.tiny_config(dtype=torch.float32, num_experts=EXPERTS)
    params = _jax_params("gpt", jcfg, 9)
    prompt = np.random.default_rng(9).integers(1, jcfg.vocab_size, size=(2, 6)).astype(np.int32)
    want = np.asarray(jgpt.greedy_generate(jcfg, params, jnp.asarray(prompt), 8))
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(bridge.params_to_state_dict(params, tcfg))
    got = tgpt.greedy_generate(tcfg, model, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["gpt", "t5"])
def test_remat_gives_the_same_loss_and_gradients(family):
    _, tmod, _, _, kw = FAMILIES[family]
    cfg = tmod.tiny_config(dtype=torch.float32, num_experts=EXPERTS)
    runs = []
    for remat in (False, True):
        task = tmod.make_task(cfg=dataclasses.replace(cfg, remat=remat), batch_size=BATCH, **kw)
        model = task.init(torch.Generator().manual_seed(4))
        batch = {k: torch.from_numpy(v)
                 for k, v in task.make_batch(np.random.default_rng(4), BATCH).items()}
        loss, metrics = task.loss_fn(model, batch)
        loss.backward()
        runs.append((loss.item(), float(metrics["moe_aux"]),
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, a0, g0), (l1, a1, g1) = runs
    assert abs(l0 - l1) <= REMAT_ATOL and abs(a0 - a1) <= REMAT_ATOL
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=REMAT_ATOL, rtol=0, msg=name)
