"""The port's ``tensor`` mesh axis against one process and the JAX package.

Gangs of real processes over gloo on the CPU (the launcher's env contract,
as ``test_torch_sequence_parallel.py``), each run once per module:

- ``{"tensor": 2}``: three steps of each family's training path (GPT,
  BERT with a vocabulary of 63 rows that does not divide, T5, ViT, the
  MLP, and DLRM with uneven tables, in float32 and in its bfloat16),
  against one process on the same global batch, rtol 1e-5 (the
  reference's bound, ``tests/test_distributed.py``; DLRM's bfloat16 run
  within the bf16 bounds); the vocab-parallel lookup, cross-entropy and
  argmax (its ties) against the whole-table ones; the tiny GPT and the
  uneven-vocab BERT on bridged JAX parameters, their blocks put together,
  against the reference at atol 1e-4;
- ``{"data": 2, "tensor": 2}`` T5, the reference's job
  (``tests/test_t5_job_e2e.py``), against one process; and checkpoints
  across layouts: the ``{"tensor": 2}`` gang's T5 checkpoint resumed by
  one process and by the ``{"data": 2, "tensor": 2}`` gang, and one
  process's by that gang, each continuing the uninterrupted run.

And the mesh rules: which layouts build a tensor mesh, and the uneven
row blocks.
"""

import collections
import dataclasses
import json
import os
import shutil
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import bert as jbert
from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.models import dlrm as tdlrm
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.models import vit as tvit
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.parallel.tensor_parallel import TensorShard
from tfk8s_tpu_torch.runtime import train as ttrain

from _torch_parity import assert_trees_close, numpy_tree
from test_torch_distributed import _lines
from test_torch_sequence_parallel import _gang

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-4
# DLRM's bfloat16 gang against one process: the bf16 bounds in force for
# models (loss atol 2e-2, gradients 5e-2 relative L2, read here on the norm)
BF16_LOSS_ATOL, BF16_GRAD_RTOL = 2e-2, 5e-2
STEPS = 3
FAMILIES = {"gpt": tgpt, "bert": tbert, "t5": tt5, "vit": tvit, "mlp": tmlp, "dlrm": tdlrm}
# each run: its family, config overrides, task arguments and metric
RUNS = {
    "gpt": dict(family="gpt", cfg={}, task=dict(seq_len=16, batch_size=4),
                metric="next_token_accuracy"),
    "bert": dict(family="bert", cfg={"vocab_size": 63}, task=dict(seq_len=16, batch_size=4),
                 metric="mlm_accuracy"),
    "t5": dict(family="t5", cfg={}, task=dict(seq_len=16, batch_size=4),
               metric="token_accuracy"),
    "vit": dict(family="vit", cfg={}, task=dict(image_size=16, patch_size=4, batch_size=4),
                metric="accuracy"),
    "mlp": dict(family="mlp", task=dict(batch_size=16, hidden=64), metric="accuracy"),
    # DLRM at its entry point's learning rate (1e-3)
    "dlrm": dict(family="dlrm", dtype="float32", metric="click_accuracy",
                 task=dict(vocab_sizes=(101, 64, 37), embed_dim=16, batch_size=32),
                 env={"TFK8S_LEARNING_RATE": "1e-3"}),
    "dlrm_bf16": dict(family="dlrm", dtype="bfloat16", metric="click_accuracy",
                      task=dict(vocab_sizes=(101, 64, 37), embed_dim=16, batch_size=32),
                      env={"TFK8S_LEARNING_RATE": "1e-3"}),
}
TRAIN_ENV = {"TFK8S_LEARNING_RATE": "1e-2", "TFK8S_INPUT_MODE": "per_host",
             "TFK8S_INPUT_SHARDS": "2", "TFK8S_LOG_EVERY": "1",
             "TFK8S_TRAIN_STEPS": str(STEPS)}

WORKER = textwrap.dedent(
    """
    import dataclasses, importlib, json, os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np, torch
    from tfk8s_tpu_torch.models import dlrm
    from tfk8s_tpu_torch.parallel import collectives as col
    from tfk8s_tpu_torch.parallel.tensor_parallel import (
        TensorShard, shard_state_dict, tensor_splits, vocab_split)
    from tfk8s_tpu_torch.runtime import train as ttrain

    env = dict(os.environ)
    ctx, dev, mesh = ttrain.join_mesh(env)
    tp = TensorShard.of(mesh)


    def task_of(run, mesh):
        family = importlib.import_module("tfk8s_tpu_torch.models." + run["family"])
        if run["family"] == "mlp":  # three steps: no convergence target
            return dataclasses.replace(family.make_task(mesh=mesh, **run["task"]), targets={})
        if run["family"] == "dlrm":
            return family.task_for_mesh(mesh, **run["task"])
        cfg = family.tiny_config(dtype=torch.float32, **run["cfg"])
        return family.task_for_mesh(mesh, cfg=cfg, **run["task"])


    def collectives(run):
        # the vocab-parallel ops on one rank's columns of whole tensors
        full = torch.from_numpy(np.load(run["arrays"])["logits"]).requires_grad_()
        target = torch.from_numpy(np.load(run["arrays"])["target"])
        table = torch.from_numpy(np.load(run["arrays"])["table"])
        lo, hi = tp.rows(full.shape[-1])
        mine = full[:, lo:hi]
        per_tok = col.vocab_parallel_cross_entropy(mine, target, lo, tp.group)
        per_tok.sum().backward()
        rows = col.vocab_parallel_lookup(table[lo:hi], target, lo, tp.group)
        top = col.vocab_parallel_argmax(full.detach()[:, lo:hi], lo, tp.group)
        torch.save({"ce": per_tok.detach(), "grad": full.grad, "argmax": top, "rows": rows},
                   run["out"] + "-%%d.pt" %% ctx.process_id)


    def parity(run):
        family = importlib.import_module("tfk8s_tpu_torch.models." + run["family"])
        cfg = family.tiny_config(dtype=torch.float32, **run["cfg"])
        model = family.BertWithHead(cfg, causal=run["family"] == "gpt", mesh=mesh)
        splits = tensor_splits(model)
        model.load_state_dict(shard_state_dict(torch.load(run["params"]), splits))
        batch = {k: torch.from_numpy(v) for k, v in np.load(run["batch"]).items()}
        logits, vocab = model(batch["input"]), vocab_split(mesh, cfg.vocab_size)
        if run["family"] == "gpt":
            loss, metrics = family.lm_loss_and_metrics(logits, batch["input"], vocab)
        else:
            loss, metrics = family.mlm_loss_and_metrics(logits, batch, None, vocab)
        loss.backward()
        torch.save({"logits": logits.detach(), "loss": loss.item(),
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {n: p.grad for n, p in model.named_parameters()},
                    "splits": {n: tuple(s) for n, s in splits.items()}},
                   run["out"] + "-%%d.pt" %% ctx.process_id)


    for run in json.loads(env["RUNS"]):
        if run.get("kind") == "collectives":
            collectives(run)
            continue
        if run.get("kind") == "parity":
            parity(run)
            continue
        dlrm.DTYPE = getattr(torch, run.get("dtype", "bfloat16"))
        for h in ttrain.run_task(task_of(run, mesh), {**env, **run.get("env", {})}, mesh=mesh):
            print("LOSS %%s %%d %%.17g %%.17g %%.17g" %% (
                run["tag"], h["step"], h["loss"], h["grad_norm"], h[run["metric"]]), flush=True)
    print("DONE", flush=True)
    """
)


def _history(out, tag):
    return [tuple(float(x) for x in line.split()[3:]) for line in _lines(out, "LOSS")
            if line.split()[1] == tag]


def _task(run, mesh):
    family = FAMILIES[run["family"]]
    if run["family"] == "mlp":  # three steps: no convergence target
        return dataclasses.replace(family.make_task(mesh=mesh, **run["task"]), targets={})
    if run["family"] == "dlrm":
        return family.task_for_mesh(mesh, **run["task"])
    return family.task_for_mesh(mesh, cfg=family.tiny_config(dtype=torch.float32, **run["cfg"]),
                                **run["task"])


def _one_process(name, steps=STEPS, ckpt="", resume=False):
    run = RUNS[name]
    env = dict(TRAIN_ENV, TFK8S_DEVICE="cpu", TFK8S_TRAIN_STEPS=str(steps),
               TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_CHECKPOINT_EVERY=str(STEPS),
               **run.get("env", {}))
    if resume:
        env["TFK8S_WORLD_VERSION"] = "1"
    old = tdlrm.DTYPE
    tdlrm.DTYPE = getattr(torch, run.get("dtype", "bfloat16"))
    try:
        history = ttrain.run_task(_task(run, torch.device("cpu")), env)
    finally:
        tdlrm.DTYPE = old
    return [(h["loss"], h["grad_norm"], h[run["metric"]]) for h in history]


def _resumable(src, dst, keep):
    """A copy of checkpoint dir ``src`` holding its steps up to ``keep``."""
    shutil.copytree(src, dst)
    for step in os.listdir(dst):
        if step.isdigit() and int(step) > keep:
            shutil.rmtree(os.path.join(dst, step))
    shutil.rmtree(os.path.join(dst, ".tfk8s_commits"))
    return dst


# -- the vocab-parallel head's collectives ------------------------------------


def _collective_arrays():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    # ties: within a rank's columns (0, 1), across ranks (2, 5), and all
    logits[1, [0, 1]] = 9.0
    logits[2, [2, 5]] = 9.0
    logits[3, :] = 1.5
    return dict(logits=logits, target=np.array([0, 6, 3, 4, 2, 5]),
                table=rng.standard_normal((7, 3)).astype(np.float32))


# -- the JAX package's tiny models on bridged parameters -----------------------


PARITY = {"gpt": (jgpt, tgpt, {}), "bert": (jbert, tbert, {"vocab_size": 63})}
SEQ, BATCH = 16, 2


def _parity_inputs(name):
    jmod, tmod, kw = PARITY[name]
    jcfg = jmod.tiny_config(dtype=jnp.float32, **kw)
    init_model = jgpt.GPTLM(jcfg) if name == "gpt" else jbert.BertWithHead(jcfg)
    params = numpy_tree(unbox(jax.jit(init_model.init)(
        jax.random.key(3), jnp.zeros((BATCH, SEQ), jnp.int32))["params"]))
    batch = tmod.make_batch_fn(jcfg.vocab_size, SEQ)(np.random.default_rng(4), BATCH)
    return jcfg, params, batch


# -- the gangs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process_t5(tmp_path_factory):
    """T5 for STEPS + 2 steps in one process, its checkpoint at STEPS."""
    ckpt = str(tmp_path_factory.mktemp("t5one") / "ckpt")
    return _one_process("t5", STEPS + 2, ckpt=ckpt), ckpt


@pytest.fixture(scope="module")
def tensor_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    runs = [dict(RUNS[name], tag=name) for name in RUNS]
    runs[2]["env"] = {"TFK8S_CHECKPOINT_DIR": os.path.join(tmp, "t5ckpt"),
                      "TFK8S_CHECKPOINT_EVERY": str(STEPS)}
    np.savez(os.path.join(tmp, "coll.npz"), **_collective_arrays())
    runs.append(dict(kind="collectives", arrays=os.path.join(tmp, "coll.npz"),
                     out=os.path.join(tmp, "coll")))
    ref = {}
    for name in PARITY:
        jcfg, params, batch = _parity_inputs(name)
        ref[name] = (jcfg, params, batch)
        tcfg = PARITY[name][1].tiny_config(dtype=torch.float32, **PARITY[name][2])
        torch.save(bridge.params_to_state_dict(params, tcfg), os.path.join(tmp, f"{name}.pt"))
        np.savez(os.path.join(tmp, f"{name}.npz"), **batch)
        runs.append(dict(kind="parity", family=name, cfg=PARITY[name][2],
                         params=os.path.join(tmp, f"{name}.pt"),
                         batch=os.path.join(tmp, f"{name}.npz"), out=os.path.join(tmp, name)))
    outs = _gang(tmp, WORKER, 2, '{"tensor": 2}', {**TRAIN_ENV, "RUNS": json.dumps(runs)})
    return outs, tmp, ref


@pytest.fixture(scope="module")
def data_tensor_gang(tensor_gang, one_process_t5, tmp_path_factory):
    """T5 on ``{"data": 2, "tensor": 2}``: fresh, then resuming the tensor
    gang's checkpoint and the one process's."""
    _, tp_tmp, _ = tensor_gang
    _, one_ckpt = one_process_t5
    tmp = str(tmp_path_factory.mktemp("dt"))
    resume = {"TFK8S_WORLD_VERSION": "1", "TFK8S_TRAIN_STEPS": str(STEPS + 2)}
    runs = [dict(RUNS["t5"], tag="t5"),
            dict(RUNS["t5"], tag="from_tensor", env=dict(resume, TFK8S_CHECKPOINT_DIR=_resumable(
                os.path.join(tp_tmp, "t5ckpt"), os.path.join(tmp, "a"), STEPS))),
            dict(RUNS["t5"], tag="from_one", env=dict(resume, TFK8S_CHECKPOINT_DIR=_resumable(
                one_ckpt, os.path.join(tmp, "b"), STEPS)))]
    return _gang(tmp, WORKER, 4, '{"data": 2, "tensor": 2}', {**TRAIN_ENV, "RUNS": json.dumps(runs)})


@pytest.mark.parametrize("name", ["gpt", "bert", "t5", "vit", "mlp", "dlrm"])
def test_tensor_gang_equals_one_process(name, tensor_gang):
    """Each family's column and row splits, vocab-parallel table and head
    (BERT's 63 rows split 32 + 31; DLRM's tables of 101 and 37 rows
    unevenly), gradient reduction and norm: loss, grad norm and accuracy
    per step equal one process's."""
    outs, _, _ = tensor_gang
    want = _one_process(name)
    for out in outs:
        got = _history(out, name)
        assert len(got) == STEPS
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_dlrm_bf16_tensor_gang_is_within_the_bf16_bounds(tensor_gang):
    """DLRM's own bfloat16 compute: the column blocks and gathered widths
    give one process's forward, but the blocks' input gradients are
    rounded before their sum, so the gang holds the bf16 bounds."""
    outs, _, _ = tensor_gang
    want = np.array(_one_process("dlrm_bf16"))
    for out in outs:
        got = np.array(_history(out, "dlrm_bf16"))
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=BF16_LOSS_ATOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=BF16_GRAD_RTOL)
        assert np.isfinite(got).all()


def test_vocab_parallel_collectives_match_the_whole_table(tensor_gang):
    _, tmp, _ = tensor_gang
    a = _collective_arrays()
    parts = [torch.load(os.path.join(tmp, f"coll-{r}.pt")) for r in range(2)]
    logits = torch.from_numpy(a["logits"]).requires_grad_()
    target = torch.from_numpy(a["target"])
    want = torch.nn.functional.cross_entropy(logits, target, reduction="none")
    want.sum().backward()
    want_top = np.argmax(a["logits"], axis=-1)  # ties to the lowest index
    assert list(want_top[1:4]) == [0, 2, 0]
    for p in parts:
        torch.testing.assert_close(p["ce"], want.detach(), atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(p["argmax"].numpy(), want_top)
        np.testing.assert_array_equal(p["rows"].numpy(), a["table"][a["target"]])
    # each rank's gradient reaches its columns only: 4 + 3 of 7
    grad = torch.cat([parts[0]["grad"][:, :4], parts[1]["grad"][:, 4:]], dim=1)
    torch.testing.assert_close(grad, logits.grad, atol=1e-6, rtol=1e-6)
    assert not parts[0]["grad"][:, 4:].any() and not parts[1]["grad"][:, :4].any()


@pytest.mark.parametrize("name", ["gpt", "bert"])
def test_reassembled_tensor_model_matches_jax(name, tensor_gang):
    """The tensor gang's blocks of bridged reference parameters, put
    together: logits, loss, accuracy and every gradient match the JAX
    package's (BERT's uneven vocabulary included)."""
    _, tmp, ref = tensor_gang
    jcfg, params, batch = ref[name]
    jmod, tmod, kw = PARITY[name]
    tcfg = tmod.tiny_config(dtype=torch.float32, **kw)
    model = jgpt.GPTLM(jcfg) if name == "gpt" else jbert.BertWithHead(jcfg)

    def jloss(p):
        logits = model.apply({"params": p}, jnp.asarray(batch["input"]))
        if name == "gpt":
            loss, aux = jgpt.lm_loss_and_metrics(logits, jnp.asarray(batch["input"]))
        else:
            loss, aux = jbert.mlm_loss_and_metrics(
                logits, jax.tree_util.tree_map(jnp.asarray, batch))
        return loss, (aux, logits)

    (want_loss, (want_aux, want_logits)), want_g = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    parts = [torch.load(os.path.join(tmp, f"{name}-{r}.pt")) for r in range(2)]
    logits = torch.cat([p["logits"] for p in parts], dim=-1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=ATOL)
    grads = {}
    for n, g in parts[0]["grads"].items():
        if n in parts[0]["splits"]:
            grads[n] = torch.cat([p["grads"][n] for p in parts], dim=parts[0]["splits"][n][0])
        else:
            torch.testing.assert_close(parts[1]["grads"][n], g, rtol=0, atol=0)
            grads[n] = g
    assert_trees_close(bridge.state_dict_to_params(grads, tcfg), numpy_tree(want_g), ATOL)
    for p in parts:
        np.testing.assert_allclose(p["loss"], float(want_loss), atol=ATOL)
        for k, v in want_aux.items():
            np.testing.assert_allclose(p["metrics"][k], float(v))


def test_data_tensor_gang_equals_one_process(data_tensor_gang, one_process_t5):
    """``BASELINE.json`` configs[3]'s layout: T5 on ``{"data": 2,
    "tensor": 2}``, the batch over data, the model over tensor."""
    want, _ = one_process_t5
    for out in data_tensor_gang:
        np.testing.assert_allclose(_history(out, "t5"), want[:STEPS], rtol=RTOL)


def test_tensor_checkpoints_resume_in_every_layout(tensor_gang, data_tensor_gang,
                                                   one_process_t5, tmp_path):
    """The ``{"tensor": 2}`` gang's T5 checkpoint holds whole tensors; it
    resumes in one process and in the ``{"data": 2, "tensor": 2}`` gang,
    and so does one process's, each continuing the uninterrupted run."""
    _, tp_tmp, _ = tensor_gang
    want, _ = one_process_t5
    saved = torch.load(os.path.join(tp_tmp, "t5ckpt", str(STEPS), "state.pt"))
    assert saved["model"]["embed.tok.weight"].shape[0] == tt5.tiny_config().vocab_size
    assert saved["model"]["enc0.attn.q.weight"].shape[0] == 32
    assert saved["optimizer"]["state"]["dec0.mlp.wo.weight"]["exp_avg"].shape == (32, 64)
    ckpt = _resumable(os.path.join(tp_tmp, "t5ckpt"), str(tmp_path / "one"), STEPS)
    rest = _one_process("t5", STEPS + 2, ckpt=ckpt, resume=True)
    np.testing.assert_allclose(rest, want[STEPS:], rtol=RTOL)
    for out in data_tensor_gang:
        for tag in ("from_tensor", "from_one"):
            np.testing.assert_allclose(_history(out, tag), want[STEPS:], rtol=RTOL)


# -- the mesh rules -----------------------------------------------------------


def _mesh(**axes):
    cfg = MeshConfig.create(**axes)
    return Mesh(cfg, torch.device("cpu"), 0, cfg.coords(0), collections.defaultdict(object))


@pytest.mark.parametrize("axes", [{"tensor": 2}, {"data": 2, "tensor": 2}])
def test_tensor_layouts_build_a_mesh(axes):
    cfg = MeshConfig.from_dict(axes)
    cfg.require_ported()
    mesh = _mesh(**axes)
    tp = TensorShard.of(mesh)
    assert (tp.index, tp.size) == (0, 2) and mesh.batch_size == axes.get("data", 1)
    assert [cfg.coords(r)["tensor"] for r in range(cfg.size())] == [0, 1] * (cfg.size() // 2)


def test_uneven_rows_split_without_padding():
    blocks = [TensorShard(None, r, 4).rows(30522) for r in range(4)]
    assert blocks == [(0, 7631), (7631, 15262), (15262, 22892), (22892, 30522)]
    with pytest.raises(ValueError, match="does not divide over tensor=4"):
        TensorShard(None, 0, 4).block(6, "num_heads")
    # an MoE layer on a tensor mesh splits each expert's hidden width
    moe = tgpt.GPTLM(tgpt.tiny_config(num_experts=2), mesh=_mesh(tensor=2)).layers[1].moe
    assert moe.wi.shape == (2, 32, 32) and moe.wo.shape == (2, 32, 32)
    assert moe.tensor_splits == {"wi": (2, 0, 32, 64), "wo": (1, 0, 32, 64)}
