"""Shared helpers of the port's combined-axes tests
(``test_torch_masked_mean.py``, ``test_torch_axes_tensor.py``,
``test_torch_axes_fsdp.py``, ``test_torch_generate_tensor.py``,
``test_torch_pipeline_axes.py``, ``test_torch_dlrm_axes.py``).

A gang is ``n`` real processes over gloo on the CPU (the launcher's env
contract; ``test_torch_sequence_parallel._gang`` starts them), each
running :data:`WORKER`: it joins the job and builds the
mesh once, then runs a list of jobs in order (a job with a ``mesh`` of
its own builds that layout of the same ranks first). A ``train`` job is one
family's ``run_task`` over the mesh (tiny float32 config, per_host input
of :data:`SHARDS` shards, so one process sees the same global batch) and
prints a ``LOSS`` line a step; the other jobs (``attention``,
``moe_parity``, ``generate``) are functions of this module that save
their tensors for the test to put together. This module imports no JAX:
the workers import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import textwrap

import numpy as np
import torch

from tfk8s_tpu_torch.runtime import train as ttrain

STEPS = 3
RTOL = 1e-5
SHARDS = 4
TRAIN_ENV = {"TFK8S_LEARNING_RATE": "1e-2", "TFK8S_INPUT_MODE": "per_host",
             "TFK8S_INPUT_SHARDS": str(SHARDS), "TFK8S_LOG_EVERY": "1",
             "TFK8S_TRAIN_STEPS": str(STEPS)}

_SEQ = dict(seq_len=16, batch_size=8)
# each run: its family, config overrides, task arguments, logged metric,
# and for T5 targets padded at random lengths
RUNS = {
    "gpt": dict(family="gpt", task=_SEQ, metric="next_token_accuracy"),
    "bert": dict(family="bert", task=_SEQ, metric="mlm_accuracy"),
    "bert63": dict(family="bert", cfg={"vocab_size": 63}, task=_SEQ, metric="mlm_accuracy"),
    "t5": dict(family="t5", task=_SEQ, metric="token_accuracy", pad=True),
    "vit": dict(family="vit", task=dict(image_size=16, patch_size=4, batch_size=8),
                metric="accuracy"),
    "mlp": dict(family="mlp", task=dict(batch_size=16, hidden=64), metric="accuracy"),
    "gpt_moe": dict(family="gpt", cfg={"num_experts": 4}, task=_SEQ,
                    metric="next_token_accuracy"),
    "bert_moe": dict(family="bert", cfg={"num_experts": 4, "vocab_size": 63}, task=_SEQ,
                     metric="mlm_accuracy"),
    "t5_moe": dict(family="t5", cfg={"num_experts": 4, "moe_top_k": 2}, task=_SEQ,
                   metric="token_accuracy", pad=True),
    "gpt_ring": dict(family="gpt", cfg={"attention_impl": "ring"}, task=_SEQ,
                     metric="next_token_accuracy"),
    "bert_ring": dict(family="bert", cfg={"attention_impl": "ring", "vocab_size": 63},
                      task=_SEQ, metric="mlm_accuracy"),
    # the pipelined BERT: 4 layers, 2 a stage on two stages, 4 microbatches;
    # the reference's tensor split needs a vocabulary that divides
    "pipelined": dict(family="pipelined", cfg={"num_layers": 4}, task=_SEQ,
                      metric="mlm_accuracy"),
    "pipelined63": dict(family="pipelined", cfg={"vocab_size": 63, "num_layers": 4},
                        task=_SEQ, metric="mlm_accuracy"),
    "pipelined_b4": dict(family="pipelined", cfg={"num_layers": 4},
                         task=dict(seq_len=16, batch_size=4, num_micro=4),
                         metric="mlm_accuracy"),
    # DLRM in float32 and in its own bfloat16, at its entry point's lr
    "dlrm": dict(family="dlrm", dtype="float32", metric="click_accuracy",
                 task=dict(vocab_sizes=(101, 64, 37), embed_dim=16, batch_size=32),
                 env={"TFK8S_LEARNING_RATE": "1e-3"}),
    "dlrm_bf16": dict(family="dlrm", dtype="bfloat16", metric="click_accuracy",
                      task=dict(vocab_sizes=(101, 64, 37), embed_dim=16, batch_size=32),
                      env={"TFK8S_LEARNING_RATE": "1e-3"}),
}

WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path[:0] = [%(repo)r, os.path.join(%(repo)r, "tests")]
    import _torch_gangs as tg
    from tfk8s_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from tfk8s_tpu_torch.runtime import train as ttrain

    env = dict(os.environ)
    ctx, dev, job_mesh = ttrain.join_mesh(env)
    for run in json.loads(env["RUNS"]):
        # a run's own layout of the same ranks, else the job's
        mesh = build_mesh(MeshConfig.from_dict(run["mesh"]), dev) if "mesh" in run else job_mesh
        kind = run.get("kind", "train")
        if kind != "train":
            getattr(tg, kind)(run, ctx, mesh)
            continue
        with tg.patched(run):
            history = ttrain.run_task(tg.task_of(run, mesh), {**env, **run.get("env", {})},
                                      mesh=mesh)
        for h in history:
            print("LOSS %%s %%d %%.17g %%.17g %%.17g" %% (
                run["tag"], h["step"], h["loss"], h["grad_norm"], h[run["metric"]]), flush=True)
    print("DONE", flush=True)
    """
)


def pad_targets(make_batch):
    """A seq2seq batch maker whose rows end at random lengths: the source
    and targets past a row's length are ``PAD_ID`` (0), so the batch
    blocks hold different counts of target positions."""

    def make(rng: np.random.Generator, n: int):
        batch = make_batch(rng, n)
        seq = batch["src"].shape[1]
        keep = np.arange(seq)[None, :] < rng.integers(1, seq + 1, size=(n, 1))
        return {k: np.where(keep, v, 0).astype(v.dtype) for k, v in batch.items()}

    return make


def task_of(run, mesh):
    """The run's task over ``mesh`` (a ``Mesh``, or a device)."""
    family = importlib.import_module("tfk8s_tpu_torch.models." + run["family"])
    if run["family"] == "mlp":  # a few steps: no convergence target
        return dataclasses.replace(family.make_task(mesh=mesh, **run["task"]), targets={})
    if run["family"] == "dlrm":
        return family.task_for_mesh(mesh, **run["task"])
    if run["family"] == "pipelined":
        from tfk8s_tpu_torch.models import bert

        cfg = bert.tiny_config(dtype=torch.float32, **run.get("cfg", {}))
        return family.make_task(mesh, cfg=cfg, **run["task"])
    cfg = family.tiny_config(dtype=torch.float32, **run.get("cfg", {}))
    task = family.task_for_mesh(mesh, cfg=cfg, **run["task"])
    if run.get("pad"):
        task = dataclasses.replace(task, make_batch=pad_targets(task.make_batch))
    return task


@contextlib.contextmanager
def patched(run):
    """The run's patches, undone after it: ``run["dtype"]``, DLRM's compute
    dtype; ``run["old_formula"]``, the masked token losses as they were
    taken before the global masked mean, each batch block's own mean
    averaged over the blocks (the sums over the sequence group only);
    ``run["fault"] == "sequence_counted"``, the pipelined family's every
    sequence rank taking the loss over the whole sequence as a replica of
    the batch block (its masked mean over the batch axes alone), so the
    reduction's sum over the sequence group counts each token ``s``
    times."""
    from tfk8s_tpu_torch.models import bert, dlrm, gpt, pipelined, t5, transformer

    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    if run.get("dtype"):
        patch(dlrm, "DTYPE", getattr(torch, run["dtype"]))
    if run.get("old_formula"):
        for m in (bert, gpt, t5):
            patch(m, "token_group", lambda mesh: (transformer.seq_group(mesh), 1))
    if run.get("fault") == "sequence_counted":
        patch(pipelined, "sequence_share", lambda mesh: (mesh.group("data", "fsdp"), 0, 1))
    with first_grads(run.get("grads")):
        try:
            yield
        finally:
            for mod, name, value in reversed(saved):
                setattr(mod, name, value)


@contextlib.contextmanager
def first_grads(prefix):
    """Save the first update's whole gradient of the runs inside (every
    parameter by name, gathered whole over the mesh by
    ``DataParallel.whole_grads``, after the step's reductions) to
    ``<prefix>-<rank>.pt``, read from an optimizer step pre-hook; nothing
    when ``prefix`` is None."""
    if prefix is None:
        yield
        return
    import torch.distributed as dist
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    held, init_state = [], ttrain.Trainer.init_state

    def holding(self):
        state = init_state(self)
        held.append((self.parallel, state.model))
        return state

    def hook(opt, args, kwargs):
        if held:
            parallel, model = held.pop()
            rank = dist.get_rank() if dist.is_initialized() else 0
            torch.save(parallel.whole_grads(model), f"{prefix}-{rank}.pt")

    ttrain.Trainer.init_state = holding
    handle = register_optimizer_step_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()
        ttrain.Trainer.init_state = init_state


def one_process(name, steps=STEPS, ckpt="", resume=False, **run_kw):
    """Run ``name`` of :data:`RUNS` in this process through ``run_task``:
    ``[(loss, grad_norm, metric)]`` a step."""
    run = dict(RUNS[name], **run_kw)
    env = dict(TRAIN_ENV, TFK8S_DEVICE="cpu", TFK8S_TRAIN_STEPS=str(steps),
               TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_CHECKPOINT_EVERY=str(STEPS),
               **run.get("env", {}))
    if resume:
        env["TFK8S_WORLD_VERSION"] = "1"
    with patched(run):
        history = ttrain.run_task(task_of(run, torch.device("cpu")), env)
    return [(h["loss"], h["grad_norm"], h[run["metric"]]) for h in history]


def train_run(name, tag=None, **kw):
    """A ``train`` job of ``name`` for :data:`WORKER` (``tag``: its name
    in the LOSS lines, default ``name``)."""
    return dict(RUNS[name], tag=tag or name, **kw)


def gang(tmp, n_procs, mesh, runs, extra=None):
    """``n_procs`` processes of :data:`WORKER` on ``mesh`` running ``runs``
    in order (``test_torch_sequence_parallel._gang``); their outputs in
    rank order."""
    from test_torch_sequence_parallel import _gang

    return _gang(tmp, WORKER, n_procs, json.dumps(mesh),
                 dict(TRAIN_ENV, RUNS=json.dumps(runs), **(extra or {})))


# -- the non-training jobs ------------------------------------------------------


def _save(run, ctx, obj):
    torch.save(obj, f"{run['out']}-{ctx.process_id}.pt")


def load_parts(run, n):
    return [torch.load(f"{run['out']}-{r}.pt") for r in range(n)]


def attention(run, ctx, mesh):
    """Ring and Ulysses over ``mesh`` on this rank's block of each case's
    ``[b, L, H, d]`` arrays: its sequence block and its tensor block of
    the heads; out, dq, dk and dv saved with the rank's coordinates."""
    from tfk8s_tpu_torch.parallel.ring_attention import make_ring_attn_fn
    from tfk8s_tpu_torch.parallel.ulysses import make_ulysses_attn_fn

    cases = np.load(run["cases"])
    n, s = mesh.size("sequence"), mesh.index("sequence")
    t, j = mesh.size("tensor"), mesh.index("tensor")
    out = {}
    for impl, fn in (("ring", make_ring_attn_fn(mesh)), ("ulysses", make_ulysses_attn_fn(mesh))):
        for name in run["names"]:
            def blk(a, heads=True):
                w = a.shape[1] // n
                a = a[:, s * w:(s + 1) * w]
                if heads:
                    h = a.shape[2] // t
                    a = a[:, :, j * h:(j + 1) * h]
                return torch.from_numpy(np.ascontiguousarray(a))

            q, k, v = (blk(cases[f"{name}/{x}"]).requires_grad_() for x in "qkv")
            mask = cases[f"{name}/mask"]
            mask = blk(mask, heads=False) if mask.ndim == 2 else None
            o = fn(q, k, v, mask=mask, causal=bool(cases[f"{name}/causal"]))
            (o * blk(cases[f"{name}/g"])).sum().backward()
            for key, x in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                out[f"{impl}/{name}/{key}"] = x.detach()
    _save(run, ctx, {"coords": (s, j), "out": out})


def moe_parity(run, ctx, mesh):
    """The MoE GPT over ``mesh`` on whole bridged parameters, each rank
    keeping its expert rows and tensor blocks: the loss, metrics, the
    logits gathered whole and every gradient gathered whole
    (``DataParallel.whole_grads``), from every rank."""
    from tfk8s_tpu_torch.models import gpt
    from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
    from tfk8s_tpu_torch.parallel.tensor_parallel import (named_splits, shard_state_dict,
                                                          tensor_splits)

    cfg = gpt.tiny_config(dtype=torch.float32, **run["cfg"])
    task = gpt.task_for_mesh(mesh, cfg=cfg, seq_len=16, batch_size=2)
    model = gpt.GPTLM(cfg, mesh=mesh)
    model.load_state_dict(shard_state_dict(torch.load(run["params"]),
                                           named_splits(model, "expert_splits"),
                                           tensor_splits(model)))
    parallel = DataParallel(mesh, torch.device("cpu"))
    model = parallel.wrap(model)
    batch = {k: torch.from_numpy(v) for k, v in np.load(run["batch"]).items()}
    loss, metrics = task.loss_fn(model, batch)
    loss.backward()
    with torch.no_grad():
        logits = model.embed.whole(model(batch["input"]))
    _save(run, ctx, {"loss": loss.item(), "metrics": {k: float(v) for k, v in metrics.items()},
                     "logits": logits, "grads": parallel.whole_grads(model),
                     "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}})


def generate(run, ctx, mesh):
    """GPT's and T5's generation over ``mesh`` (a tensor axis, and maybe a
    data axis: each data rank decodes its block of the prompt rows) from
    the one-process initial parameters of seed 0: greedy, sampled and beam
    tokens, beam scores, the prefilled cache gathered whole over the
    tensor group, and whether the paged path refuses the split model."""
    import torch.distributed as dist

    from tfk8s_tpu_torch.models import gpt, t5
    from tfk8s_tpu_torch.models.transformer import init_params
    from tfk8s_tpu_torch.parallel.collectives import all_gather
    from tfk8s_tpu_torch.parallel.tensor_parallel import init_sharded

    rows = np.array_split(np.arange(run["batch"]), mesh.size("data"))[mesh.index("data")]
    prompt = torch.from_numpy(np.load(run["prompt"])[rows])
    cfg = gpt.tiny_config(dtype=torch.float32, max_len=64)
    model = init_sharded(lambda m: gpt.GPTLM(cfg, mesh=m), init_params,
                         torch.Generator().manual_seed(0), mesh)
    n, res = run["tokens"], {"rows": rows.tolist()}
    res["greedy"] = gpt.greedy_generate(cfg, model, prompt, n)
    res["sampled"] = gpt.generate(cfg, model, prompt, n, rng=7, temperature=0.8, top_k=20,
                                  top_p=0.9, batch_rows=(int(rows[0]), run["batch"]))
    res["beam"], res["scores"] = gpt.beam_generate(cfg, model, prompt, n, num_beams=3,
                                                   return_all=True)
    with torch.no_grad():
        _, cache = gpt.prefill_cache(dataclasses.replace(cfg, decode_cache_len=32), model,
                                     prompt)
    group = mesh.group("tensor")
    res["cache"] = [(all_gather(k, 2, group), all_gather(v, 2, group))
                    for k, v in zip(cache.keys, cache.values)]
    t5cfg = t5.tiny_config(dtype=torch.float32)
    t5model = init_sharded(lambda m: t5.T5(t5cfg, mesh=m), init_params,
                           torch.Generator().manual_seed(0), mesh)
    res["t5_greedy"] = t5.greedy_generate(t5cfg, t5model, prompt[:, :16] % 62 + 2, 8)
    paged = dataclasses.replace(cfg, kv_page_size=8, kv_max_pages=8)
    b = len(rows)
    try:
        gpt.GPTLM(paged, mesh=mesh)(prompt[:, :1], pos_offset=torch.zeros(b, dtype=torch.int32),
                                    page_tables=torch.ones(b, 8, dtype=torch.int32),
                                    pages=gpt.clean_pages(paged))
        res["paged"] = "ran"
    except NotImplementedError as e:
        res["paged"] = str(e)
    dist.barrier()
    _save(run, ctx, res)
