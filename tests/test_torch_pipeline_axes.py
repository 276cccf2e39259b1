"""The ``pipeline`` axis beside ``fsdp``, ``expert``, ``sequence`` and
``tensor``, against one process and the JAX package.

Two gangs of real processes over gloo on the CPU (``_torch_gangs``), each
run once per module: four ranks taking ``{"pipeline": 2, "tensor": 2}``,
``{"pipeline": 2, "fsdp": 2}``, ``{"pipeline": 2, "sequence": 2}`` and
``{"pipeline": 2, "expert": 2}`` in turn, and eight ranks on the
reference's multislice layout ``{"pipeline": 2, "data": 2, "tensor": 2}``
over two slices (``TFK8S_NUM_SLICES=2``). Tiny float32 configs, three
steps through ``run_task`` on per_host input of four shards, against one
process on the same global batch at rtol 1e-5 (loss, gradient norm and
accuracy a step):

- the pipelined BERT (4 layers, 2 a stage), from the reference's initial
  parameters carried across by ``bridge.pipelined_params_to_state_dict``,
  on every layout (batch 4 in 4 microbatches on fsdp: each fsdp rank
  holds 2 rows and pipelines its data block's 4), and at vocabulary 63
  (split 32 + 31) on ``{"pipeline": 2, "tensor": 2}``;
- GPT on ``{"pipeline": 2, "tensor": 2}`` and the MoE GPT on
  ``{"pipeline": 2, "expert": 2}``, which have no pipeline region and
  replicate their step over the axis;
- a planted fault, every sequence rank taking the whole sequence's loss
  as a replica of its batch block, whose gradient the reduction's sum
  over the sequence group counts twice: it misses the bound;
- the vocab-63 run's ``{"pipeline": 2, "tensor": 2}`` checkpoint holds
  whole tensors and resumes in one process and on ``{"pipeline": 2,
  "fsdp": 2}``, each continuing the uninterrupted run;
- ``make_task`` accepts the layouts the reference's accepts, with the
  reference's first loss (its task on as many virtual devices, from the
  same parameters, on its Trainer's first batch and shardings) within
  1e-4, and refuses the others with the reference's text.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import bert as jbert
from tfk8s_tpu.models import pipelined as jpipelined
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.models import pipelined as tpipelined
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer

import _torch_gangs as tg
from _torch_parity import numpy_tree
from test_torch_tensor_parallel import _history, _resumable

LAYOUTS = {"pipeline_tensor": {"pipeline": 2, "tensor": 2},
           "pipeline_fsdp": {"pipeline": 2, "fsdp": 2},
           "pipeline_sequence": {"pipeline": 2, "sequence": 2},
           "pipeline_expert": {"pipeline": 2, "expert": 2}}
MULTISLICE = {"pipeline": 2, "data": 2, "tensor": 2}
# each layout's pipelined run: the batch 4 / 4 microbatches case on fsdp
PIPELINED = {"pipeline_fsdp": "pipelined_b4"}
REFERENCE_ATOL = 1e-4  # the first loss against the reference's


def _cfg():
    return tbert.tiny_config(dtype=torch.float32, **tg.RUNS["pipelined"]["cfg"])


def _reference_params():
    jcfg = jbert.tiny_config(dtype=jnp.float32, **tg.RUNS["pipelined"]["cfg"])
    task = jpipelined.make_task(make_mesh(pipeline=2), cfg=jcfg, seq_len=16, batch_size=8)
    return jcfg, numpy_tree(unbox(jax.jit(task.init)(jax.random.key(0))))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The reference's initial parameters and a step-0 checkpoint of them
    (the port's one-process state, moments zero) that every pipelined run
    resumes."""
    tmp = str(tmp_path_factory.mktemp("init"))
    jcfg, params = _reference_params()
    task = tg.task_of(tg.RUNS["pipelined"], torch.device("cpu"))
    state = ttrain.Trainer(task, ttrain.TrainConfig(), torch.device("cpu")).init_state()
    state.model.load_state_dict(bridge.pipelined_params_to_state_dict(params, _cfg(), 2))
    Checkpointer(tmp).save(0, state.state_dict(), wait=True)
    return dict(dir=tmp, jcfg=jcfg, params=params)


def _from_init(init, dst):
    """A run's env resuming a fresh copy of the step-0 checkpoint."""
    return {"TFK8S_CHECKPOINT_DIR": _resumable(init["dir"], dst, 0),
            "TFK8S_WORLD_VERSION": "1"}


@pytest.fixture(scope="module")
def one_process(init, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("one"))
    out = {n: np.array(tg.one_process(n, ckpt=_resumable(init["dir"], os.path.join(tmp, n), 0),
                                      resume=True, grads=os.path.join(tmp, n)))
           for n in ("pipelined", "pipelined_b4")}
    out["grads"] = torch.load(os.path.join(tmp, "pipelined-0.pt"))
    out["pipelined63"] = np.array(tg.one_process("pipelined63", tg.STEPS + 2))
    out.update({n: np.array(tg.one_process(n)) for n in ("gpt", "gpt_moe")})
    return out


@pytest.fixture(scope="module")
def gang(init, tmp_path_factory):
    """Four ranks over the four layouts in turn."""
    tmp = str(tmp_path_factory.mktemp("pp"))
    saved = os.path.join(tmp, "pt63")

    def from_init(layout, name="pipelined", tag=None, **kw):
        return tg.train_run(name, tag=tag or f"{layout}/{name}", mesh=LAYOUTS[layout],
                            env=_from_init(init, os.path.join(tmp, tag or layout)), **kw)

    def fresh(layout, name, **kw):
        return tg.train_run(name, tag=kw.pop("tag", f"{layout}/{name}"), mesh=LAYOUTS[layout],
                            **kw)

    runs = [from_init("pipeline_tensor", grads=os.path.join(tmp, "grads-pipeline_tensor")),
            fresh("pipeline_tensor", "pipelined63", env={
                "TFK8S_CHECKPOINT_DIR": saved, "TFK8S_CHECKPOINT_EVERY": str(tg.STEPS)}),
            fresh("pipeline_tensor", "gpt"),
            from_init("pipeline_fsdp", "pipelined_b4"),
            fresh("pipeline_fsdp", "pipelined63", tag="from_pipeline_tensor", env={
                "TFK8S_CHECKPOINT_DIR": saved, "TFK8S_WORLD_VERSION": "1",
                "TFK8S_TRAIN_STEPS": str(tg.STEPS + 2)}),
            from_init("pipeline_sequence", grads=os.path.join(tmp, "grads-pipeline_sequence")),
            from_init("pipeline_sequence", tag="sequence_counted", fault="sequence_counted"),
            from_init("pipeline_expert"),
            fresh("pipeline_expert", "gpt_moe")]
    return tg.gang(tmp, 4, LAYOUTS["pipeline_tensor"], runs), saved, tmp


@pytest.fixture(scope="module")
def multislice_gang(init, tmp_path_factory):
    """Eight ranks on the reference's multislice layout, two slices."""
    tmp = str(tmp_path_factory.mktemp("pdt"))
    run = tg.train_run("pipelined", tag="multislice/pipelined",
                       env=_from_init(init, os.path.join(tmp, "ckpt")))
    return tg.gang(tmp, 8, MULTISLICE, [run], extra={"TFK8S_NUM_SLICES": "2"})


def _outs(tag, gang, multislice_gang):
    return multislice_gang if tag.startswith("multislice/") else gang[0]


@pytest.mark.parametrize("tag", [f"{layout}/{PIPELINED.get(layout, 'pipelined')}"
                                 for layout in LAYOUTS]
                         + ["pipeline_tensor/pipelined63", "multislice/pipelined"])
def test_pipelined_gang_equals_one_process(tag, gang, multislice_gang, one_process):
    """Every layout's pipelined BERT: loss, gradient norm and
    ``mlm_accuracy`` per step equal one process's on every rank."""
    want = one_process[tag.split("/")[1]][:tg.STEPS]
    for out in _outs(tag, gang, multislice_gang):
        got = _history(out, tag)
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, want, rtol=tg.RTOL)


@pytest.mark.parametrize("tag", ["pipeline_tensor/gpt", "pipeline_expert/gpt_moe"])
def test_unpipelined_families_replicate_over_the_pipeline_axis(tag, gang, one_process):
    """GPT beside tensor and the MoE GPT beside expert: both pipeline ranks
    run the whole step on the same rows, as one process does."""
    for out in gang[0]:
        got = _history(out, tag)
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, one_process[tag.split("/")[1]], rtol=tg.RTOL)


def test_planted_sequence_count_misses_the_bound(gang, one_process):
    """Each sequence rank holding the whole sequence's loss as a replica:
    the first loss is right, but the reduction sums the whole gradient
    over the two sequence ranks, so the norm reads twice one process's,
    past the bound."""
    want = one_process["pipelined"]
    for out in gang[0]:
        got = np.array(_history(out, "sequence_counted"))
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=tg.RTOL)
        np.testing.assert_allclose(got[0, 1], 2 * want[0, 1], rtol=tg.RTOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got, want, rtol=tg.RTOL)


@pytest.mark.parametrize("layout", ["pipeline_tensor", "pipeline_sequence"])
def test_whole_first_gradient_is_one_process_s(layout, gang, one_process):
    """``DataParallel.whole_grads`` on every rank: the tensor blocks and
    the stages put together, in the one process's parameter order, each
    within 1e-5 relative L2 of one process's first-update gradient."""
    want = one_process["grads"]
    for rank in range(4):
        got = torch.load(os.path.join(gang[2], f"grads-{layout}-{rank}.pt"))
        assert list(got) == list(want)
        for name, g in got.items():
            err = float((g - want[name]).norm() / want[name].norm().clamp_min(1e-30))
            assert err < tg.RTOL, (name, err)


def test_checkpoint_resumes_across_layouts(gang, one_process, tmp_path):
    """The ``{"pipeline": 2, "tensor": 2}`` checkpoint holds every layer
    and the 63-row table whole; it resumes in one process and on
    ``{"pipeline": 2, "fsdp": 2}``, each continuing the uninterrupted
    run."""
    outs, saved, _ = gang
    state = torch.load(os.path.join(saved, str(tg.STEPS), "state.pt"))
    assert state["model"]["embed.tok.weight"].shape == (63, 32)
    assert state["optimizer"]["state"]["layers.3.mlp.wi.weight"]["exp_avg"].shape == (64, 32)
    assert set(state["optimizer"]["state"]) == set(state["model"])
    want = one_process["pipelined63"][tg.STEPS:]
    ckpt = _resumable(saved, str(tmp_path / "one"), tg.STEPS)
    np.testing.assert_allclose(tg.one_process("pipelined63", tg.STEPS + 2, ckpt=ckpt,
                                              resume=True), want, rtol=tg.RTOL)
    for out in outs:
        np.testing.assert_allclose(_history(out, "from_pipeline_tensor"), want, rtol=tg.RTOL)


# -- make_task against the reference's -------------------------------------------------


def _mesh(**axes):
    """Rank 0's place on a mesh built without a process group."""
    cfg = MeshConfig.create(**axes)
    return Mesh(cfg, torch.device("cpu"), 0, cfg.coords(0), collections.defaultdict(object))


ACCEPTED = [("pipeline_tensor", LAYOUTS["pipeline_tensor"], {}),
            ("pipeline_fsdp", LAYOUTS["pipeline_fsdp"], {"batch_size": 4, "num_micro": 4}),
            ("pipeline_sequence", LAYOUTS["pipeline_sequence"], {}),
            ("pipeline_expert", LAYOUTS["pipeline_expert"], {}),
            ("multislice", MULTISLICE, {})]
# (axes, task arguments, config overrides): each of the reference's checks
REFUSED = [(LAYOUTS["pipeline_tensor"], {"batch_size": 10, "num_micro": 4}, {}),
           (LAYOUTS["pipeline_fsdp"], {}, {"num_layers": 3}),
           (LAYOUTS["pipeline_expert"], {}, {"num_experts": 2}),
           (LAYOUTS["pipeline_sequence"], {}, {"attention_impl": "ring"}),
           (MULTISLICE, {"batch_size": 12, "num_micro": 4}, {})]


def _reference_first_loss(init, axes, task_kw):
    """The reference's loss on its Trainer's first per_host batch (the
    gangs' input: ``TFK8S_INPUT_SHARDS`` shards of seed 0, step 0) with the
    initial parameters placed by its Trainer's shardings, on ``axes`` of
    the virtual devices."""
    mesh = make_mesh(**axes)
    task = jpipelined.make_task(mesh, cfg=init["jcfg"], seq_len=16,
                                **{"batch_size": 8, **task_kw})
    trainer = jtrain.Trainer(task, jtrain.TrainConfig(input_mode="per_host",
                                                      input_shards=tg.SHARDS), mesh)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, init["params"]),
                            trainer.state_shardings.params)
    batch = trainer._make_shard_batch(0, 0, tg.SHARDS, tg.SHARDS)
    loss, _ = jax.jit(task.loss_fn)(params, batch, jax.random.key(0))
    return float(loss)


@pytest.mark.parametrize("layout,axes,task_kw", ACCEPTED, ids=[a[0] for a in ACCEPTED])
def test_make_task_accepts_what_the_reference_accepts(layout, axes, task_kw, init, gang,
                                                      multislice_gang):
    """Both tasks build on the layout, and the gang's first loss (every
    rank's) is the reference's within 1e-4."""
    tpipelined.make_task(_mesh(**axes), cfg=_cfg(), seq_len=16, **task_kw)
    want = _reference_first_loss(init, axes, task_kw)
    tag = f"{layout}/{PIPELINED.get(layout, 'pipelined')}"
    for out in _outs(tag, gang, multislice_gang):
        np.testing.assert_allclose(_history(out, tag)[0][0], want, atol=REFERENCE_ATOL)


@pytest.mark.parametrize("axes,task_kw,cfg_kw", REFUSED)
def test_make_task_refuses_what_the_reference_refuses_beside_a_model_axis(axes, task_kw, cfg_kw):
    """The reference's ``AssertionError``, with its text."""
    with pytest.raises(AssertionError) as want:
        jpipelined.make_task(make_mesh(**axes), cfg=jbert.tiny_config(**cfg_kw), **task_kw)
    with pytest.raises(AssertionError) as got:
        tpipelined.make_task(_mesh(**axes), cfg=tbert.tiny_config(**cfg_kw), **task_kw)
    assert str(got.value) == str(want.value)
