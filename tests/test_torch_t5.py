"""The port's T5 against the JAX package's, on the same parameters.

The reference's ``T5`` is initialised in JAX, its tree goes through
``bridge.t5_params_to_state_dict``, and the same numpy batches go to both.
Tiny config in float32:
- logits, loss, ``token_accuracy`` and every gradient within atol 1e-4,
  with plain attention and with flash (the Pallas kernels in interpret
  mode on the reference's side, the kernels' plain versions on the
  port's), on the reversal batch and on one whose sources end in
  ``PAD_ID`` tails (a quarter to a half of each row), so the encoder's and
  the cross-attention's key masks matter;
- incremental decoding against teacher forcing (atol 1e-4), and its cache
  against the reference's through the bridge;
- ``generate`` greedy, sampled under the same key and with EOS: tokens
  exact; ``beam_generate``: tokens exact, scores within atol 1e-5;
- a three-step ``t5:train`` run at the tiny preset against the reference
  ``Trainer`` (rtol 1e-4);
- ``t5:train`` and ``bert:train`` as TPUJobs under the reference
  controller and ``LocalKubelet``, to Succeeded with their progress in
  ``pod.status.training``.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import t5 as jt5
from tfk8s_tpu.ops.flash_attention import flash_attention as jax_flash
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.ops import flash_attention as tfa

from _torch_parity import assert_trees_close, assert_trees_equal, numpy_tree, trajectories

ATOL, RTOL, SCORE_ATOL = 1e-4, 1e-4, 1e-5
SEQ, BATCH = 16, 2


def _configs(**kw):
    return jt5.tiny_config(dtype=jnp.float32, **kw), tt5.tiny_config(dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed=0):
    z = jnp.zeros((BATCH, SEQ), jnp.int32)
    return numpy_tree(unbox(jax.jit(jt5.T5(jcfg).init)(jax.random.key(seed), z, z)["params"]))


def _port_model(tcfg, params, attn_fn=None):
    model = tt5.T5(tcfg, attn_fn=attn_fn)
    model.load_state_dict(bridge.t5_params_to_state_dict(params, tcfg))
    return model


def _batch(vocab, seed, padded=False):
    batch = tt5.make_batch_fn(vocab, SEQ)(np.random.default_rng(seed), BATCH)
    if padded:
        rng = np.random.default_rng(seed + 100)
        src = batch["src"].copy()
        for row in src:
            row[SEQ - rng.integers(SEQ // 4, SEQ // 2 + 1):] = tt5.PAD_ID
        tgt = src[:, ::-1]
        tgt_in = np.concatenate([np.full((BATCH, 1), tt5.BOS_ID, np.int32), tgt[:, :-1]], 1)
        batch = {"src": src, "tgt_in": tgt_in.astype(np.int32),
                 "tgt_out": np.ascontiguousarray(tgt)}
    return batch


@pytest.mark.parametrize("vocab,seq,batch,seed", [(64, 16, 2, 0), (32128, 33, 3, 7)])
def test_batches_equal_the_reference(vocab, seq, batch, seed):
    want = jt5.make_batch_fn(vocab, seq)(np.random.default_rng(seed), batch)
    got = tt5.make_batch_fn(vocab, seq)(np.random.default_rng(seed), batch)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bridge_round_trips():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=1)
    model = _port_model(tcfg, params)
    assert set(model.state_dict()) == set(bridge.t5_params_to_state_dict(params, tcfg))
    back = bridge.t5_state_dict_to_params(model.state_dict(), tcfg)
    assert_trees_equal(back, params)
    assert {"self_attn", "cross_attn", "ln_self", "ln_cross", "ln_mlp", "mlp"} <= set(back["dec0"])


@pytest.mark.parametrize("padded", [False, True], ids=["reversal", "padded"])
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_loss_and_grads_match_jax(impl, padded):
    # one encoder and one decoder layer: still every attention site (the
    # encoder's masked, the decoder's causal, the masked cross-attention)
    jcfg, tcfg = _configs(num_layers=1)
    params = _jax_params(jcfg, seed=2)
    batch = _batch(jcfg.vocab_size, seed=2, padded=padded)
    assert padded == bool((batch["src"] == tt5.PAD_ID).any())
    jattn = jax_flash if impl == "flash" else None
    task = jt5.make_task(jcfg, seq_len=SEQ, batch_size=BATCH, attn_fn=jattn)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (want_loss, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: task.loss_fn(p, jb, jax.random.key(0)), has_aux=True))(params)
    want_logits = jax.jit(jt5.T5(jcfg, attn_fn=jattn).apply)(
        {"params": params}, jb["src"], jb["tgt_in"])

    tmodel = _port_model(tcfg, params, tfa.flash_attention if impl == "flash" else None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tmodel(tb["src"], tb["tgt_in"])
    loss, aux = tt5.loss_and_metrics(logits, tb["tgt_out"])
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    np.testing.assert_allclose(float(aux["token_accuracy"]), float(want_aux["token_accuracy"]))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert_trees_close(bridge.t5_state_dict_to_params(grads, tcfg), numpy_tree(want_g), ATOL)


def _decode_inputs(jcfg):
    rng = np.random.default_rng(0)
    src = rng.integers(2, jcfg.vocab_size, (2, 10)).astype(np.int32)
    src[1, 7:] = tt5.PAD_ID
    tgt_in = np.concatenate([np.full((2, 1), tt5.BOS_ID),
                             rng.integers(2, jcfg.vocab_size, (2, 7))], 1).astype(np.int32)
    return src, tgt_in


def _port_decode(model, cfg, src, tgt_in, steps):
    """``steps`` single-token decoder steps: (logits of each, the cache)."""
    with torch.no_grad():
        enc, mask = model.encode(torch.from_numpy(src))
        cache = tt5.init_decode_cache(cfg, src.shape[0])
        out = []
        for i in range(steps):
            logits, cache = model.decode(torch.from_numpy(tgt_in[:, i:i + 1]), enc, mask,
                                         pos_offset=i, cache=cache)
            out.append(logits[:, 0])
    return out, cache


def test_incremental_decode_matches_teacher_forced():
    """Single-token decoder steps over the KV cache reproduce the
    teacher-forced logits at every target position (the reference's
    ``test_t5_incremental_decode_matches_teacher_forced``)."""
    jcfg, tcfg = _configs(max_len=32)
    src, tgt_in = _decode_inputs(jcfg)
    model = _port_model(tcfg, _jax_params(jcfg))
    with torch.no_grad():
        full = model(torch.from_numpy(src), torch.from_numpy(tgt_in))
    steps, _ = _port_decode(model, dataclasses.replace(tcfg, decode_cache_len=8), src, tgt_in,
                            tgt_in.shape[1])
    for i, logits in enumerate(steps):
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(), atol=ATOL,
                                   err_msg=f"target position {i}")


def test_decode_cache_equals_the_reference_through_the_bridge():
    """Three decoder steps leave the reference's cache
    (``cache_from_torch`` with the decoder's scope, atol 1e-5), and the
    bridge carries the reference's cache over and back exactly."""
    jcfg, tcfg = _configs(max_len=32)
    dj, dt = (dataclasses.replace(c, decode_cache_len=8) for c in (jcfg, tcfg))
    src, tgt_in = _decode_inputs(jcfg)
    params = _jax_params(jcfg)
    _, cache = _port_decode(_port_model(tcfg, params), dt, src, tgt_in, 3)
    jd = jt5.T5(dj, decode_mode=True)
    jenc, jmask = jd.apply({"params": params}, jnp.asarray(src), method=jt5.T5.encode)

    @jax.jit
    def step(jcache, tok, i):
        return jd.apply({"params": params, "cache": jcache}, tok, jenc, jmask, pos_offset=i,
                        method=jt5.T5.decode, mutable=["cache"])[1]["cache"]

    jcache = jt5.init_decode_cache(dj, 2)
    for i in range(3):
        jcache = step(jcache, jnp.asarray(tgt_in[:, i:i + 1]), jnp.asarray(i, jnp.int32))
    scope = ("dec", "self_attn")
    want = numpy_tree(jcache)
    assert_trees_close(bridge.cache_from_torch(cache, scope), want, 1e-5)
    back = bridge.cache_from_torch(bridge.cache_to_torch(want, dt, scope=scope), scope)
    assert_trees_equal(back, want)


def _decode_pair(seed=0, padded=False):
    """Configs, the (cached, seed-0) parameters, a source batch drawn from
    ``seed`` (rows 1 and 2 padded when asked) and the port's model, flash."""
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg)
    rng = np.random.default_rng(seed)
    src = rng.integers(2, jcfg.vocab_size, (3, 8)).astype(np.int32)
    if padded:
        src[1, 5:] = tt5.PAD_ID
        src[2, 6:] = tt5.PAD_ID
    return jcfg, tcfg, params, src, _port_model(tcfg, params, tfa.flash_attention)


@pytest.mark.parametrize("padded", [False, True], ids=["full_rows", "padded"])
def test_greedy_and_eos_tokens_equal_the_reference(padded):
    """Greedy and EOS streams: the port's tokens are the reference's
    exactly. The port encodes through its flash path (the plain versions
    on the CPU)."""
    jcfg, tcfg, params, src, model = _decode_pair(seed=3, padded=padded)
    n = 6
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    greedy = np.asarray(jt5.generate(jcfg, params, jsrc, n))
    np.testing.assert_array_equal(tt5.generate(tcfg, model, tsrc, n).numpy(), greedy)
    np.testing.assert_array_equal(tt5.greedy_generate(tcfg, model, tsrc, n).numpy(), greedy)
    eos = int(greedy[0, 2])
    want = np.asarray(jt5.generate(jcfg, params, jsrc, n, eos_id=eos))
    got = tt5.generate(tcfg, model, tsrc, n, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 3:] == tt5.PAD_ID).all()


def test_sampled_tokens_equal_the_reference():
    """Sampled streams under one key (temperature / top-k / top-p, and
    temperature alone), the key given as a seed or as its two words:
    the reference's tokens exactly; top_k=1 is greedy."""
    jcfg, tcfg, params, src, model = _decode_pair(seed=5, padded=True)
    n = 6
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    samp = dict(temperature=0.8, top_k=8, top_p=0.9)
    want = np.asarray(jt5.generate(jcfg, params, jsrc, n, rng=jax.random.key(42), **samp))
    np.testing.assert_array_equal(tt5.generate(tcfg, model, tsrc, n, rng=42, **samp).numpy(),
                                  want)
    words = np.asarray(jax.random.key_data(jax.random.key(42)))
    np.testing.assert_array_equal(tt5.generate(tcfg, model, tsrc, n, rng=words, **samp).numpy(),
                                  want)
    hot = np.asarray(jt5.generate(jcfg, params, jsrc, n, rng=jax.random.key(7), temperature=3.0))
    np.testing.assert_array_equal(
        tt5.generate(tcfg, model, tsrc, n, rng=7, temperature=3.0).numpy(), hot)
    np.testing.assert_array_equal(
        tt5.generate(tcfg, model, tsrc, n, rng=7, temperature=2.0, top_k=1).numpy(),
        tt5.greedy_generate(tcfg, model, tsrc, n).numpy())


def test_beam_generate_equals_the_reference():
    jcfg, tcfg, params, src, model = _decode_pair(seed=4, padded=True)
    jsrc, tsrc = jnp.asarray(src), torch.from_numpy(src)
    want_seqs, want_scores = jt5.beam_generate(jcfg, params, jsrc, 6, num_beams=3,
                                               return_all=True)
    seqs, scores = tt5.beam_generate(tcfg, model, tsrc, 6, num_beams=3, return_all=True)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=SCORE_ATOL)
    np.testing.assert_array_equal(tt5.beam_generate(tcfg, model, tsrc, 6, num_beams=1).numpy(),
                                  tt5.greedy_generate(tcfg, model, tsrc, 6).numpy())
    with pytest.raises(ValueError, match="num_beams"):
        tt5.beam_generate(tcfg, model, tsrc, 4, num_beams=0)
    with pytest.raises(ValueError, match="max_len"):
        tt5.generate(tcfg, model, tsrc, tcfg.max_len + 1)


def test_three_step_train_matches_the_reference_trainer(tmp_path, monkeypatch):
    """``t5:train`` at the tiny preset (float32, flash: its plain versions
    on the CPU) against the reference Trainer with plain attention: no row
    of the reversal task is fully masked, where alone the two differ."""
    monkeypatch.setattr(tt5, "tiny_config", functools.partial(tt5.tiny_config, dtype=torch.float32))
    jtask = jt5.make_task(jt5.tiny_config(dtype=jnp.float32), seq_len=SEQ, batch_size=4)
    tcfg = tt5.tiny_config(attention_impl="flash")
    ttask = tt5.make_task(tcfg, seq_len=SEQ, batch_size=4)
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
           "TFK8S_BATCH_SIZE": "4", "TFK8S_LEARNING_RATE": "3e-3",
           "TFK8S_ATTENTION_IMPL": "flash"}
    want, got = trajectories(jtask, ttask, lambda sd: bridge.t5_state_dict_to_params(sd, tcfg),
                             tt5.train, env, str(tmp_path / "ckpt"))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)


def test_presets_keep_the_reference_shapes():
    for name in ("base_config", "tiny_config"):
        j, t = getattr(jt5, name)(), getattr(tt5, name)()
        for field in ("vocab_size", "embed_dim", "num_heads", "head_dim",
                      "mlp_dim", "num_layers", "max_len", "ln_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    assert (tt5.PAD_ID, tt5.BOS_ID) == (jt5.PAD_ID, jt5.BOS_ID)


@pytest.mark.parametrize("family", ["bert", "vit", "t5"])
def test_family_entrypoints_need_the_card_unless_the_cpu_is_asked_for(family, monkeypatch):
    """No entry point falls back to the CPU: without a card it raises
    unless ``TFK8S_DEVICE=cpu``, a pod of several ranks before it starts
    one; a layout of more devices than processes (image input included,
    tests/test_torch_image_job.py) runs as the pod's ranks, which the entry
    point starts on itself (tests/test_torch_pod_ranks.py runs them); MoE
    and ring attention (item 1.9's first half) run."""
    import importlib

    from tfk8s_tpu_torch.runtime import pod_ranks

    module = importlib.import_module(f"tfk8s_tpu_torch.models.{family}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = {"TFK8S_MODEL_PRESET": "tiny", "TFK8S_TRAIN_STEPS": "1", "TFK8S_SEQ_LEN": "16",
           "TFK8S_BATCH_SIZE": "2"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.train(env)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.train(dict(env, TFK8S_MESH='{"data": 4}'))
    pods = []
    monkeypatch.setattr(pod_ranks, "run", lambda *args: pods.append(args) or [{"step": 1}])
    image = dict(env, TFK8S_DEVICE="cpu", TFK8S_INPUT_FILES="x-*.rio",
                 TFK8S_INPUT_FORMAT="image", TFK8S_MESH='{"data": 4}')
    assert module.train(image) == [{"step": 1}]
    assert pods == [(f"tfk8s_tpu_torch.models.{family}:train", image, None, 4)]
    # MoE and the ring pin (once refusals naming item 1.9) run on the CPU
    for extra in ({"TFK8S_NUM_EXPERTS": "2"}, {"TFK8S_ATTENTION_IMPL": "ring"}):
        final = module.train(dict(env, TFK8S_DEVICE="cpu", **extra))[-1]
        assert np.isfinite(final["loss"]) and ("moe_aux" in final) == ("TFK8S_NUM_EXPERTS" in extra)


@pytest.mark.parametrize("family", ["t5", "bert"])
def test_tpujob_runs_the_family_entrypoint_to_succeeded(family):
    """A ``cpu-1`` TPUJob naming the port's ``t5:train`` (``bert:train``)
    at the tiny preset, under the reference controller and kubelet: the
    job Succeeds and the Worker's progress reaches ``pod.status.training``."""
    from conftest import wait_for
    from tfk8s_tpu.api import (
        ContainerSpec, ObjectMeta, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, TPUSpec, helpers,
    )
    from tfk8s_tpu.client import FakeClientset
    from tfk8s_tpu.runtime import LocalKubelet
    from tfk8s_tpu.trainer import TPUJobController

    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    stop = threading.Event()
    LocalKubelet(cs).run(stop)
    name = f"{family}-torch"
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
           "TFK8S_BATCH_SIZE": "4", "TFK8S_TRAIN_STEPS": "4", "TFK8S_LOG_EVERY": "2",
           "TFK8S_ATTENTION_IMPL": "flash"}
    try:
        assert ctrl.run(workers=2, stop=stop, block=False)
        worker = ReplicaSpec(replicas=1, template=ContainerSpec(
            entrypoint=f"tfk8s_tpu_torch.models.{family}:train", env=env))
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name=name),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: worker},
                            tpu=TPUSpec(accelerator="cpu-1"))))

        def finished():
            status = cs.tpujobs().get(name).status
            return helpers.is_succeeded(status) or helpers.is_failed(status)

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get(name).status
        assert helpers.is_succeeded(status), [c.message for c in status.conditions]
        training = cs.pods().get(f"{name}-worker-0").status.training
        assert training["step"] == 4 and training["steps_per_sec"] > 0
    finally:
        stop.set()
        ctrl.controller.shutdown()
