"""The port's ``pipeline`` mesh axis against one process and the JAX package.

Gangs of real processes over gloo on the CPU (the launcher's env contract,
as ``test_torch_tensor_parallel.py``), each launched once per module and
running several jobs one after another:

- ``{"pipeline": 2}`` (two ranks) and ``{"pipeline": 4}`` (four): the
  port's ``pipeline_apply`` of a tanh layer a stage, for 1, 2, 4 and 8
  microbatches, against the reference's ``pipeline_apply`` on as many of
  the conftest's virtual devices (outputs atol 1e-5, each stage's
  parameter gradients atol 1e-4) and the input's gradient against the
  sequential composition's;
- ``{"pipeline": 2}``: the tiny float32 pipelined BERT (2 and 4 layers) on
  bridged reference parameters against the reference's
  ``pipelined.make_task`` (loss, ``mlm_accuracy`` and every gradient atol
  1e-4) and against the port's sequential ``BertWithHead``;
- ``pipelined:train`` for three steps on ``{"pipeline": 2}`` and
  ``{"pipeline": 2, "data": 2}``, against the reference ``Trainer`` from
  the same parameters (loss and grad norm rtol 1e-4) and against one
  process (rtol 1e-5, the reference's gang bound); checkpoints across
  stage counts, each resume continuing the uninterrupted run (rtol
  1e-5); ``gpt:train`` on ``{"pipeline": 2}`` against one process.

And the refusals of ``make_task``, the mesh rules, the bridge maps, and a
TPUJob naming the entry point through the reference control plane.
"""

import collections
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import bert as jbert
from tfk8s_tpu.models import pipelined as jpipelined
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from tfk8s_tpu.parallel.pipeline import split_microbatches as jsplit
from tfk8s_tpu.parallel.pipeline import stack_stage_params
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import pipelined as tpipelined
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.parallel.pipeline import split_microbatches
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

from _torch_parity import assert_trees_close, numpy_tree
from test_torch_distributed import _free_port, _lines
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 150
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4  # pipeline_apply against the reference
ATOL = 1e-4  # the pipelined BERT against the reference: loss, accuracy, gradients
TRAJ_RTOL = 1e-4  # trajectories against the reference Trainer
RTOL = 1e-5  # gangs against one process, the reference's bound
STEPS = 3
MICRO = (1, 2, 4, 8)
APPLY = dict(batch=16, width=8)
LAYERS = 4  # the trajectories' model: 2 layers a stage on two stages
SEQ, BATCH = 16, 8
TRAIN_ENV = {"TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": str(SEQ),
             "TFK8S_BATCH_SIZE": str(BATCH), "TFK8S_LEARNING_RATE": "1e-2",
             "TFK8S_INPUT_MODE": "replicated", "TFK8S_LOG_EVERY": "1",
             "TFK8S_CHECKPOINT_EVERY": str(STEPS)}

WORKER = textwrap.dedent(
    """
    import functools, json, os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np, torch
    from tfk8s_tpu_torch.models import bert, gpt, pipelined
    from tfk8s_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from tfk8s_tpu_torch.parallel.pipeline import pipeline_apply, split_microbatches
    from tfk8s_tpu_torch.runtime import train as ttrain

    # the tiny presets in float32, as the reference comparisons need
    bert.tiny_config = functools.partial(bert.tiny_config, dtype=torch.float32)
    gpt.tiny_config = functools.partial(gpt.tiny_config, dtype=torch.float32)
    env = dict(os.environ)
    ctx, dev, mesh = ttrain.join_mesh(env)
    me = ctx.process_id


    class Tanh(torch.nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.w, self.b = torch.nn.Parameter(w), torch.nn.Parameter(b)

        def forward(self, x):
            return torch.tanh(x @ self.w + self.b)


    def apply(run):
        n = run["stages"]
        pmesh = mesh if mesh.cfg.names == ("pipeline",) and mesh.size("pipeline") == n \\
            else build_mesh(MeshConfig.create(pipeline=n), dev)
        a = np.load(run["arrays"])
        s, out = pmesh.index("pipeline"), {}
        for m in run["micro"]:
            stage = Tanh(torch.from_numpy(a["w"][s]), torch.from_numpy(a["b"][s]))
            x = torch.from_numpy(a["x"]).requires_grad_()
            y = pipeline_apply(stage, split_microbatches(x, m), pmesh)
            (y ** 2).sum().backward()
            out.update({"%%d/y" %% m: y.detach().numpy(), "%%d/w" %% m: stage.w.grad.numpy(),
                        "%%d/b" %% m: stage.b.grad.numpy(), "%%d/x" %% m: x.grad.numpy()})
        np.savez(run["out"] + "-%%d.npz" %% me, stage=s, **out)


    def parity(run):
        cfg = bert.tiny_config(num_layers=run["layers"])
        task = pipelined.make_task(mesh, cfg=cfg, seq_len=run["seq"], batch_size=run["batch"])
        model = task.init(torch.Generator())
        whole = torch.load(run["params"])
        model.load_state_dict({k: whole[k] for k in model.state_dict()})
        batch = {k: torch.from_numpy(v) for k, v in np.load(run["batch_file"]).items()}
        loss, metrics = task.loss_fn(model, batch)
        loss.backward()
        torch.save({"loss": loss.item(), "metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {n: p.grad for n, p in model.named_parameters()}},
                   run["out"] + "-%%d.pt" %% me)


    for run in json.loads(env["RUNS"]):
        if run["kind"] == "apply":
            apply(run)
        elif run["kind"] == "parity":
            parity(run)
        else:
            family = gpt if run["kind"] == "gpt" else pipelined
            for h in family.train({**env, **run["env"]}):
                metric = h.get("mlm_accuracy", h.get("next_token_accuracy"))
                print("LOSS %%s %%d %%.17g %%.17g %%.17g" %% (
                    run["tag"], h["step"], h["loss"], h["grad_norm"], metric), flush=True)
    print("DONE", flush=True)
    """
)


def _gang(tmp, n_procs, mesh, extra, rank_env=None, script=WORKER):
    """``n_procs`` processes of ``script`` joined on a fresh port
    (``rank_env``: each rank's own extra env); their outputs, failing the
    test (after killing the gang) past the timeout or on a non-zero exit."""
    path = os.path.join(tmp, "worker.py")
    with open(path, "w") as f:
        f.write(script % {"repo": REPO})
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, TFK8S_DISTRIBUTED="1", TFK8S_NUM_PROCESSES=str(n_procs),
                   TFK8S_PROCESS_ID=str(pid), TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   TFK8S_DEVICE="cpu", TFK8S_MESH=mesh, OMP_NUM_THREADS="1", **extra,
                   **(rank_env[pid] if rank_env else {}))
        procs.append(subprocess.Popen([sys.executable, path], env=env, cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=GANG_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"gang of {n_procs} ({mesh}) ran past {GANG_TIMEOUT}s")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outs


def _history(out, tag):
    return [tuple(float(x) for x in line.split()[3:]) for line in _lines(out, "LOSS")
            if line.split()[1] == tag]


def _resumable(src, dst, keep):
    """A copy of checkpoint dir ``src`` holding its steps up to ``keep``."""
    shutil.copytree(src, dst)
    for step in os.listdir(dst):
        if step.isdigit() and int(step) > keep:
            shutil.rmtree(os.path.join(dst, step))
    shutil.rmtree(os.path.join(dst, ".tfk8s_commits"), ignore_errors=True)
    return dst


@pytest.fixture
def f32_presets(monkeypatch):
    monkeypatch.setattr(tbert, "tiny_config", functools.partial(tbert.tiny_config,
                                                                dtype=torch.float32))
    monkeypatch.setattr(tgpt, "tiny_config", functools.partial(tgpt.tiny_config,
                                                               dtype=torch.float32))


def _train_env(tag, ckpt, steps=STEPS):
    """A ``pipelined:train`` job resuming checkpoint dir ``ckpt``: from step
    0 on the replicated batch stream (the reference Trainer's), or from
    STEPS to ``steps`` on per-host input, whose batches depend on the step
    alone (the replicated stream restarts at a resume)."""
    env = dict(TRAIN_ENV, TFK8S_NUM_LAYERS=str(LAYERS), TFK8S_TRAIN_STEPS=str(steps),
               TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_WORLD_VERSION="1")
    if steps > STEPS:
        env.update(TFK8S_INPUT_MODE="per_host", TFK8S_INPUT_SHARDS="2")
    return dict(kind="train", tag=tag, env=env)


def _one_process(ckpt, steps):
    """``pipelined:train`` in this process (float32 tiny preset) resuming
    ``ckpt``: ``(loss, grad_norm, mlm_accuracy)`` per step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbert, "tiny_config", functools.partial(tbert.tiny_config,
                                                           dtype=torch.float32))
        env = dict(_train_env("one", ckpt, steps)["env"], TFK8S_DEVICE="cpu")
        return [(h["loss"], h["grad_norm"], h["mlm_accuracy"]) for h in tpipelined.train(env)]


# -- the reference side ---------------------------------------------------------


def _apply_arrays(stages):
    rng = np.random.default_rng(stages)
    d = APPLY["width"]
    return dict(w=(rng.standard_normal((stages, d, d)) / np.sqrt(d)).astype(np.float32),
                b=(rng.standard_normal((stages, d)) * 0.1).astype(np.float32),
                x=rng.standard_normal((APPLY["batch"], d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference_apply(stages, num_micro):
    """The reference's outputs and stage gradients of ``sum(y ** 2)``, and
    the input's gradient through the sequential composition."""
    a = _apply_arrays(stages)
    mesh = make_mesh(pipeline=stages)

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    params = stack_stage_params([{"w": jnp.asarray(a["w"][s]), "b": jnp.asarray(a["b"][s])}
                                 for s in range(stages)])
    mb = jsplit(jnp.asarray(a["x"]), num_micro)

    def loss(p):
        y = jpipeline_apply(stage_fn, p, mb, mesh)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    def sequential(x):
        for s in range(stages):
            x = stage_fn({"w": a["w"][s], "b": a["b"][s]}, x)
        return jnp.sum(x ** 2)

    gx = jax.grad(sequential)(jnp.asarray(a["x"]))
    return np.asarray(y), numpy_tree(g), np.asarray(gx)


@functools.lru_cache(maxsize=None)
def _reference_bert(layers):
    """The reference's pipelined task on ``{"pipeline": 2}``: its params,
    a batch, and loss, metrics and gradients on them."""
    jcfg = jbert.tiny_config(dtype=jnp.float32, num_layers=layers)
    task = jpipelined.make_task(make_mesh(pipeline=2), cfg=jcfg, seq_len=SEQ, batch_size=BATCH)
    params = numpy_tree(unbox(jax.jit(task.init)(jax.random.key(layers))))
    batch = task.make_batch(np.random.default_rng(layers), BATCH)

    def loss(p):
        return task.loss_fn(p, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.key(0))

    (value, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, batch, float(value), numpy_tree(metrics), numpy_tree(grads)


def _reference_trajectory(params, data):
    jcfg = jbert.tiny_config(dtype=jnp.float32, num_layers=LAYERS)
    mesh = make_mesh(pipeline=2, data=data)
    jtask = jpipelined.make_task(mesh, cfg=jcfg, seq_len=SEQ, batch_size=BATCH)
    lr = float(TRAIN_ENV["TFK8S_LEARNING_RATE"])
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(steps=STEPS, learning_rate=lr, log_every=1),
                         mesh)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                              opt_state=jtr.optimizer.init(params)),
                            jtr.state_shardings)
    _, history = jtr.fit(state=jstate)
    return [(h["loss"], h["grad_norm"]) for h in history]


# -- the gangs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The initial state (step 0, checkpointed), one process's run of
    ``pipelined:train`` from it for STEPS steps (checkpointed at STEPS) and
    on from there for two more, and the reference Trainer's trajectories
    from it."""
    tmp = str(tmp_path_factory.mktemp("one"))
    cfg = tbert.tiny_config(dtype=torch.float32, num_layers=LAYERS)
    task = tpipelined.make_task(torch.device("cpu"), cfg=cfg, seq_len=SEQ, batch_size=BATCH)
    state = ttrain.Trainer(task, ttrain.TrainConfig(), torch.device("cpu")).init_state()
    init = os.path.join(tmp, "init")
    Checkpointer(init).save(0, state.state_dict(), wait=True)
    params = bridge.pipelined_state_dict_to_params(state.model.state_dict(), cfg, 2)
    ckpt = _resumable(init, os.path.join(tmp, "ckpt"), 0)
    history = _one_process(ckpt, STEPS)
    rest = _one_process(_resumable(ckpt, os.path.join(tmp, "rest"), STEPS), STEPS + 2)
    reference = {data: _reference_trajectory(params, data) for data in (1, 2)}
    return dict(init=init, ckpt=ckpt, history=history, rest=rest, reference=reference)


@pytest.fixture(scope="module")
def pipeline_gang(one_process, tmp_path_factory):
    """Two ranks on ``{"pipeline": 2}``."""
    tmp = str(tmp_path_factory.mktemp("pp2"))
    np.savez(os.path.join(tmp, "apply.npz"), **_apply_arrays(2))
    runs = [dict(kind="apply", stages=2, micro=list(MICRO),
                 arrays=os.path.join(tmp, "apply.npz"), out=os.path.join(tmp, "apply"))]
    for layers in (2, 4):
        params, batch, *_ = _reference_bert(layers)
        tcfg = tbert.tiny_config(dtype=torch.float32, num_layers=layers)
        torch.save(bridge.pipelined_params_to_state_dict(params, tcfg, 2),
                   os.path.join(tmp, f"bert{layers}.pt"))
        np.savez(os.path.join(tmp, f"batch{layers}.npz"), **batch)
        runs.append(dict(kind="parity", layers=layers, seq=SEQ, batch=BATCH,
                         params=os.path.join(tmp, f"bert{layers}.pt"),
                         batch_file=os.path.join(tmp, f"batch{layers}.npz"),
                         out=os.path.join(tmp, f"bert{layers}")))
    runs.append(_train_env("p2", _resumable(one_process["init"], os.path.join(tmp, "p2"), 0)))
    runs.append(_train_env("from_one", _resumable(one_process["ckpt"], os.path.join(tmp, "f1"),
                                                  STEPS), STEPS + 2))
    runs.append(dict(kind="gpt", tag="gpt", env=dict(
        TRAIN_ENV, TFK8S_SEQ_LEN="16", TFK8S_BATCH_SIZE="4", TFK8S_TRAIN_STEPS=str(STEPS))))
    outs = _gang(tmp, 2, '{"pipeline": 2}', {"RUNS": json.dumps(runs)})
    return outs, tmp


@pytest.fixture(scope="module")
def pipeline_data_gang(one_process, pipeline_gang, tmp_path_factory):
    """Four ranks on ``{"pipeline": 2, "data": 2}``, which also build a
    ``{"pipeline": 4}`` mesh for ``pipeline_apply``."""
    _, pp_tmp = pipeline_gang
    tmp = str(tmp_path_factory.mktemp("pp2d2"))
    np.savez(os.path.join(tmp, "apply.npz"), **_apply_arrays(4))
    runs = [dict(kind="apply", stages=4, micro=list(MICRO),
                 arrays=os.path.join(tmp, "apply.npz"), out=os.path.join(tmp, "apply")),
            _train_env("p2d2", _resumable(one_process["init"], os.path.join(tmp, "a"), 0)),
            _train_env("from_p2", _resumable(os.path.join(pp_tmp, "p2"), os.path.join(tmp, "b"),
                                             STEPS), STEPS + 2)]
    outs = _gang(tmp, 4, '{"pipeline": 2, "data": 2}', {"RUNS": json.dumps(runs)})
    return outs, tmp


# -- pipeline_apply ----------------------------------------------------------------


@pytest.mark.parametrize("stages,num_micro", [(s, m) for s in (2, 4) for m in MICRO])
def test_pipeline_apply_matches_the_reference(stages, num_micro, pipeline_gang,
                                              pipeline_data_gang):
    """Every rank holds the last stage's outputs; each stage's parameter
    gradients are the reference's, and every rank's input gradient is the
    sequential composition's (stage 0's, handed to all)."""
    _, tmp = pipeline_gang if stages == 2 else pipeline_data_gang
    want_y, want_g, want_x = _reference_apply(stages, num_micro)
    for r in range(stages):
        got = np.load(os.path.join(tmp, f"apply-{r}.npz"))
        s = int(got["stage"])
        np.testing.assert_allclose(got[f"{num_micro}/y"], want_y, atol=OUT_ATOL)
        np.testing.assert_allclose(got[f"{num_micro}/w"], want_g["w"][s], atol=GRAD_ATOL)
        np.testing.assert_allclose(got[f"{num_micro}/b"], want_g["b"][s], atol=GRAD_ATOL)
        np.testing.assert_allclose(got[f"{num_micro}/x"], want_x.reshape(got[f"{num_micro}/x"].shape),
                                   atol=GRAD_ATOL)


def test_split_microbatches_validates():
    x = torch.arange(24.0).reshape(12, 2)
    assert split_microbatches(x, 3).shape == (3, 4, 2)
    np.testing.assert_array_equal(split_microbatches(x, 3).numpy(),
                                  np.asarray(jsplit(jnp.asarray(x.numpy()), 3)))
    with pytest.raises(AssertionError, match="not divisible into 5 microbatches"):
        split_microbatches(torch.zeros(12, 2), 5)


# -- the pipelined BERT against the reference ---------------------------------------


def _gang_grads(tmp, name):
    """The two ranks' gradients as one whole state dict: each stage's
    layers from its rank, the embedding and final norm (equal on both)
    from rank 0."""
    parts = [torch.load(os.path.join(tmp, f"{name}-{r}.pt")) for r in range(2)]
    grads = dict(parts[1]["grads"])
    for n, g in parts[0]["grads"].items():
        if n in grads:
            torch.testing.assert_close(grads[n], g, rtol=0, atol=0)
        grads[n] = g
    return parts, grads


@pytest.mark.parametrize("layers", [2, 4])
def test_pipelined_bert_matches_the_reference(layers, pipeline_gang):
    """Loss, ``mlm_accuracy`` and every gradient of the ``{"pipeline": 2}``
    gang on bridged reference parameters (the tied embedding's gradient:
    the head's, alike on both ranks, and the lookup's from stage 0)."""
    _, tmp = pipeline_gang
    _, _, loss, metrics, want = _reference_bert(layers)
    parts, grads = _gang_grads(tmp, f"bert{layers}")
    tcfg = tbert.tiny_config(dtype=torch.float32, num_layers=layers)
    assert_trees_close(bridge.pipelined_state_dict_to_params(grads, tcfg, 2), want, ATOL)
    for p in parts:
        np.testing.assert_allclose(p["loss"], loss, atol=ATOL)
        np.testing.assert_allclose(p["metrics"]["mlm_accuracy"], metrics["mlm_accuracy"],
                                   atol=ATOL)


def test_pipelined_forward_is_the_sequential_composition(pipeline_gang):
    """The reference's check: the pipelined loss equals embed -> stage 0 ->
    stage 1 -> final norm -> tied head run in sequence on the same
    parameters (the port's ``BertWithHead``)."""
    _, tmp = pipeline_gang
    params, batch, *_ = _reference_bert(2)
    tcfg = tbert.tiny_config(dtype=torch.float32, num_layers=2)
    model = tbert.BertWithHead(tcfg)
    model.load_state_dict(bridge.pipelined_params_to_state_dict(params, tcfg, 2))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        want, _ = tbert.mlm_loss_and_metrics(model(tb["input"]), tb)
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"bert2-{r}.pt"))["loss"]
        np.testing.assert_allclose(got, want.item(), rtol=1e-4)


# -- training through the entry point ------------------------------------------------


@pytest.mark.parametrize("data", [1, 2])
def test_pipelined_train_follows_the_reference_trainer(data, one_process, pipeline_gang,
                                                       pipeline_data_gang):
    """``pipelined:train`` on ``{"pipeline": 2}`` and ``{"pipeline": 2,
    "data": 2}`` from the same initial parameters as the reference
    ``Trainer`` on the same mesh: loss and grad norm per step."""
    outs, _ = pipeline_gang if data == 1 else pipeline_data_gang
    want = one_process["reference"][data]
    for out in outs:
        got = [h[:2] for h in _history(out, "p2" if data == 1 else "p2d2")]
        np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("data", [1, 2])
def test_pipeline_gang_equals_one_process(data, one_process, pipeline_gang, pipeline_data_gang):
    """Loss, grad norm and ``mlm_accuracy`` per step equal one process's
    (one stage holding every layer), on every rank."""
    outs, _ = pipeline_gang if data == 1 else pipeline_data_gang
    for out in outs:
        got = _history(out, "p2" if data == 1 else "p2d2")
        assert len(got) == STEPS
        np.testing.assert_allclose(got, one_process["history"], rtol=RTOL)


def test_checkpoints_resume_across_stage_counts(one_process, pipeline_gang,
                                               pipeline_data_gang, tmp_path):
    """Checkpoints hold every layer under its global index: the
    ``{"pipeline": 2}`` gang's resumes in one process and in the
    ``{"pipeline": 2, "data": 2}`` gang, and one process's in the
    ``{"pipeline": 2}`` gang, each continuing the uninterrupted run."""
    _, pp_tmp = pipeline_gang
    want = one_process["rest"]
    saved = torch.load(os.path.join(pp_tmp, "p2", str(STEPS), "state.pt"))
    assert {f"layers.{i}.attn.q.weight" for i in range(LAYERS)} <= set(saved["model"])
    assert set(saved["optimizer"]["state"]) == set(saved["model"])
    assert saved["optimizer"]["param_groups"][0]["params"] == list(
        tbert.BertWithHead(tbert.tiny_config(num_layers=LAYERS)).state_dict())
    rest = _one_process(_resumable(os.path.join(pp_tmp, "p2"), str(tmp_path / "one"), STEPS),
                        STEPS + 2)
    np.testing.assert_allclose(rest, want, rtol=RTOL)
    for outs, tag in ((pipeline_gang[0], "from_one"), (pipeline_data_gang[0], "from_p2")):
        for out in outs:
            np.testing.assert_allclose(_history(out, tag), want, rtol=RTOL)


def test_other_families_replicate_over_the_pipeline_axis(pipeline_gang, f32_presets):
    """``gpt:train`` has no pipeline region: on ``{"pipeline": 2}`` both
    ranks run the whole step on the same rows, no gradient reduced over
    the axis, as one process does."""
    outs, _ = pipeline_gang
    env = dict(TRAIN_ENV, TFK8S_DEVICE="cpu", TFK8S_SEQ_LEN="16", TFK8S_BATCH_SIZE="4",
               TFK8S_TRAIN_STEPS=str(STEPS))
    del env["TFK8S_CHECKPOINT_EVERY"]
    want = [(h["loss"], h["grad_norm"], h["next_token_accuracy"]) for h in tgpt.train(env)]
    for out in outs:
        np.testing.assert_allclose(_history(out, "gpt"), want, rtol=RTOL)


# -- make_task's refusals and the mesh rules ------------------------------------------


def _mesh(rank=0, **axes):
    """Rank ``rank``'s place on a mesh built without a process group."""
    cfg = MeshConfig.create(**axes)
    return Mesh(cfg, torch.device("cpu"), rank, cfg.coords(rank), collections.defaultdict(object))


@pytest.mark.parametrize("cfg_kw,task_kw,axes,match", [
    ({"num_layers": 3}, {"batch_size": 8}, {"pipeline": 2}, "divide evenly into 2 stages"),
    ({"num_experts": 2}, {}, {"pipeline": 2}, "does not support MoE"),
    ({"attention_impl": "flash"}, {}, {"pipeline": 2}, "only full attention"),
    ({}, {"batch_size": 10, "num_micro": 4}, {"pipeline": 2}, "must divide into 4 microbatches"),
    ({}, {"batch_size": 12, "num_micro": 4}, {"pipeline": 2, "data": 2},
     "must divide over the data axis"),
])
def test_make_task_refuses_what_the_reference_refuses(cfg_kw, task_kw, axes, match):
    with pytest.raises(AssertionError, match=match):
        jpipelined.make_task(make_mesh(**axes), cfg=jbert.tiny_config(**cfg_kw), **task_kw)
    with pytest.raises(AssertionError, match=match):
        tpipelined.make_task(_mesh(**axes), cfg=tbert.tiny_config(**cfg_kw), **task_kw)


@pytest.mark.parametrize("axes", [{"pipeline": 2}, {"pipeline": 2, "data": 2},
                                  {"pipeline": 4, "data": 2}, {"pipeline": 2, "tensor": 2},
                                  {"pipeline": 2, "fsdp": 2, "sequence": 2},
                                  {"pipeline": 2, "data": 2, "expert": 2}])
def test_pipeline_layouts_build_a_mesh(axes):
    cfg = MeshConfig.from_dict(axes)
    cfg.require_ported()
    assert cfg.names[0] == "pipeline"
    # the stages vary slowest: rank 0's pipeline peers are a stage's ranks apart
    stages, per_stage = axes["pipeline"], cfg.size() // axes["pipeline"]
    assert [_mesh(**axes).rank_at("pipeline", s) for s in range(stages)] == [
        s * per_stage for s in range(stages)]
    for r in range(cfg.size()):
        mesh = _mesh(r, **axes)
        # each peer shares every other coordinate, and its pipeline group is them
        peers = [mesh.rank_at("pipeline", s) for s in range(stages)]
        assert [cfg.coords(p) for p in peers] == [{**mesh.coords, "pipeline": s}
                                                  for s in range(stages)]
        assert sorted(peers) in cfg.ranks_along(("pipeline",))
    # the gradient group (data x fsdp x sequence) lies within a stage
    for block in cfg.ranks_along(("data", "fsdp", "sequence")):
        assert len({cfg.coords(p)["pipeline"] for p in block}) == 1


@pytest.mark.parametrize("beside", ["fsdp", "expert", "sequence", "tensor"])
def test_pipeline_beside_a_model_axis_raises(beside):
    """Named for the refusal it held before the pipeline ran beside the
    model axes: each layout now passes the mesh rules, and every rank's
    pipelined task builds its stage on it (the gangs:
    ``tests/test_torch_pipeline_axes.py``)."""
    axes = {"pipeline": 2, beside: 2}
    MeshConfig.from_dict(axes).require_ported()
    cfg = tbert.tiny_config(num_layers=4)
    for r in range(4):
        mesh = _mesh(r, **axes)
        model = tpipelined.make_task(mesh, cfg=cfg, batch_size=8).init(torch.Generator())
        first = 2 * mesh.index("pipeline")
        assert set(model.layers) == {str(first), str(first + 1)}
        heads = cfg.num_heads // mesh.size("tensor")
        assert model.layers[str(first)].attn.q.weight.shape == (heads * cfg.head_dim,
                                                                cfg.embed_dim)


def test_bridge_maps_stages_to_global_layers():
    params, *_ = _reference_bert(4)
    tcfg = tbert.tiny_config(dtype=torch.float32, num_layers=4)
    sd = bridge.pipelined_params_to_state_dict(params, tcfg, 2)
    np.testing.assert_array_equal(sd["layers.3.mlp.wo.bias"].numpy(),
                                  params["stages"]["layer1"]["mlp"]["wo"]["bias"][1])
    assert_trees_close(bridge.pipelined_state_dict_to_params(sd, tcfg, 2), params, 0)
    # a stage's share: its layers, the embedding and the final norm
    mine = bridge.pipelined_params_to_state_dict(params, tcfg, 2, stage=1)
    model = tpipelined.PipelinedBert(tcfg, _mesh(1, pipeline=2), num_micro=4)
    assert set(mine) == set(model.state_dict())
    assert {k for k in mine if k.startswith("layers.")} == {
        k for k in sd if k.startswith(("layers.2.", "layers.3."))}
    # every stage count draws each layer alike
    one = tpipelined.make_task(torch.device("cpu"), cfg=tcfg).init(torch.Generator().manual_seed(5))
    two = tpipelined.init_model(tpipelined.PipelinedBert(tcfg, _mesh(1, pipeline=2), 4),
                                torch.Generator().manual_seed(5))
    for k, v in two.state_dict().items():
        torch.testing.assert_close(v, one.state_dict()[k], rtol=0, atol=0)


# -- the control plane -----------------------------------------------------------------


def test_tpujob_runs_the_pipelined_entrypoint_through_the_reference_control_plane(tmp_path):
    """One process under the reference ``LocalKubelet`` (one stage holding
    every layer) trains to Succeeded; the shipped ``cpu-2`` example on
    ``{"pipeline": 2}`` (``manifests/examples/bert-pipelined-torch.yaml``)
    renders two Worker pods whose env, each run in its own process (the
    kubelet runs pods as threads of one process, which cannot form a
    process group), trains the two stages to the end on the same losses."""
    from conftest import wait_for
    from tfk8s_tpu.api import (
        ContainerSpec, ObjectMeta, ReplicaSpec, ReplicaType, TPUJob, TPUJobSpec, TPUSpec, helpers,
    )
    from tfk8s_tpu.client import FakeClientset
    from tfk8s_tpu.cmd.main import load_manifest
    from tfk8s_tpu.runtime import LocalKubelet
    from tfk8s_tpu.trainer import TPUJobController
    from tfk8s_tpu.trainer import labels as L

    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
           "TFK8S_BATCH_SIZE": "8", "TFK8S_TRAIN_STEPS": "2", "TFK8S_LOG_EVERY": "1"}
    entry = "tfk8s_tpu_torch.models.pipelined:train"
    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    stop = threading.Event()
    LocalKubelet(cs).run(stop)
    try:
        assert ctrl.run(workers=2, stop=stop, block=False)
        cs.tpujobs().create(TPUJob(
            metadata=ObjectMeta(name="bert-pipelined-torch"),
            spec=TPUJobSpec(replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=1, template=ContainerSpec(entrypoint=entry, env=env))},
                tpu=TPUSpec(accelerator="cpu-1"))))

        def finished():
            status = cs.tpujobs().get("bert-pipelined-torch").status
            return helpers.is_succeeded(status) or helpers.is_failed(status)

        assert wait_for(finished, timeout=120)
        status = cs.tpujobs().get("bert-pipelined-torch").status
        assert helpers.is_succeeded(status), [c.message for c in status.conditions]
    finally:
        stop.set()
        ctrl.controller.shutdown()

    # the shipped example, cut to two tiny steps
    job = load_manifest(os.path.join(REPO, "manifests", "examples", "bert-pipelined-torch.yaml"))
    job.spec.replica_specs[ReplicaType.WORKER].template.env.update(env)
    name = job.metadata.name
    cs = FakeClientset()
    ctrl = TPUJobController(cs)
    stop = threading.Event()
    try:
        assert ctrl.run(workers=2, stop=stop, block=False)
        cs.tpujobs().create(job)
        assert wait_for(lambda: len(cs.pods().list(label_selector=L.job_selector(name))[0]) == 2)
        pods = cs.pods().list(label_selector=L.job_selector(name))[0]
    finally:
        stop.set()
        ctrl.controller.shutdown()
    port = _free_port()
    procs = []
    for pod in sorted(pods, key=lambda p: int(p.spec.containers[0].env["TFK8S_PROCESS_ID"])):
        c = pod.spec.containers[0]
        assert c.entrypoint == entry and json.loads(c.env["TFK8S_MESH"]) == {"pipeline": 2}
        # the rendered coordinator is the job's service name: here, a local port
        assert c.env["TFK8S_DISTRIBUTED"] == "1"
        penv = dict(os.environ, **{**c.env, "TFK8S_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"},
                    OMP_NUM_THREADS="1")
        code = ("import os, sys; sys.path.insert(0, %r)\n"
                "from tfk8s_tpu.runtime import registry\n"
                "for h in registry.resolve(os.environ['ENTRY'])(dict(os.environ)):\n"
                "    print('LOSS', h['step'], repr(h['loss']), flush=True)\n" % REPO)
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=dict(penv, ENTRY=entry),
                                      cwd=str(tmp_path), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=GANG_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert len(_lines(outs[0], "LOSS")) == 2 and _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
