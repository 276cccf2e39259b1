"""The port's ``tensor`` axis beside ``fsdp``, ``expert`` and ``sequence``,
against one process and the JAX package.

Gangs of real processes over gloo on the CPU (``_torch_gangs``), each run
once per module, tiny float32 configs, three steps through each family's
training path, against one process on the same global batch at rtol 1e-5
(loss, gradient norm and accuracy a step):

- ``{"fsdp": 2, "tensor": 2}``: GPT, BERT with 63 vocabulary rows (split
  32 + 31 over tensor, then each block's rows over fsdp), T5 with padded
  targets, ViT and the MLP; and the same four ranks' layout with a data
  axis, ``{"data": 2, "fsdp": 2, "tensor": 2}``, for BERT and T5;
- ``{"expert": 2, "tensor": 2}``: the MoE GPT, BERT and T5 (each expert's
  hidden width split, ``expert_mlp``), and the MoE GPT on bridged
  reference parameters, its blocks put together, against the reference
  at atol 1e-4;
- ``{"sequence": 2, "tensor": 2}``: GPT, BERT, T5 and ViT through the
  policy (Ulysses over each rank's two heads), GPT and BERT pinned to the
  ring; ring and Ulysses on each rank's sequence and head block against
  the reference's on four virtual devices at atol 1e-4;
- checkpoints: the ``{"fsdp": 2, "tensor": 2}`` GPT's and the
  ``{"expert": 2, "tensor": 2}`` MoE GPT's hold whole tensors and resume
  in one process and on ``{"tensor": 2}``, each continuing the
  uninterrupted run.

And the policy and Ulysses' error on a rank's head count, as the
reference's.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.models.transformer import apply_with_aux as japply_with_aux
from tfk8s_tpu.models.transformer import select_attn_fn as jselect
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.ring_attention import make_ring_attn_fn as jring
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.parallel.ulysses import make_ulysses_attn_fn as julysses
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models.transformer import select_attn_fn
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.parallel.ulysses import make_ulysses_attn_fn

import _torch_gangs as tg
from test_torch_tensor_parallel import _history, _resumable
from _torch_parity import assert_trees_close, numpy_tree
from test_torch_sequence_parallel import CASES, _case_arrays

ATOL = 1e-4
FSDP_TENSOR = ("gpt", "bert63", "t5", "vit", "mlp")
DATA_FSDP_TENSOR = ("bert63", "t5")
EXPERT_TENSOR = ("gpt_moe", "bert_moe", "t5_moe")
SEQUENCE_TENSOR = ("gpt", "bert63", "t5", "vit", "gpt_ring", "bert_ring")
# checkpointed in the gangs: (gang, run)
SAVED = {"fsdp_tensor": "gpt", "expert_tensor": "gpt_moe"}
MOE_CFG = {"num_experts": 4}


def _ckpt(tmp, name):
    return {"TFK8S_CHECKPOINT_DIR": os.path.join(tmp, name),
            "TFK8S_CHECKPOINT_EVERY": str(tg.STEPS)}


@pytest.fixture(scope="module")
def one_process():
    """Every run in one process; the checkpointed ones for two more steps."""
    names = set(FSDP_TENSOR + EXPERT_TENSOR + SEQUENCE_TENSOR)
    return {n: np.array(tg.one_process(n, tg.STEPS + 2 * (n in SAVED.values())))
            for n in sorted(names)}


@pytest.fixture(scope="module")
def fsdp_tensor_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ft"))
    runs = [tg.train_run(n, env=_ckpt(tmp, "ckpt") if n == "gpt" else {})
            for n in FSDP_TENSOR]
    return tg.gang(tmp, 4, {"fsdp": 2, "tensor": 2}, runs), tmp


@pytest.fixture(scope="module")
def data_fsdp_tensor_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dft"))
    return tg.gang(tmp, 8, {"data": 2, "fsdp": 2, "tensor": 2},
                   [tg.train_run(n) for n in DATA_FSDP_TENSOR])


def _moe_parity_inputs():
    jcfg = jgpt.tiny_config(dtype=jnp.float32, **MOE_CFG)
    params = numpy_tree(unbox(jgpt.make_task(cfg=jcfg, seq_len=16, batch_size=2).init(
        jax.random.key(3))))
    batch = tgpt.make_batch_fn(jcfg.vocab_size, 16)(np.random.default_rng(4), 2)
    return jcfg, params, batch


@pytest.fixture(scope="module")
def expert_tensor_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("et"))
    runs = [tg.train_run(n, env=_ckpt(tmp, "ckpt") if n == "gpt_moe" else {})
            for n in EXPERT_TENSOR]
    jcfg, params, batch = _moe_parity_inputs()
    tcfg = tgpt.tiny_config(dtype=torch.float32, **MOE_CFG)
    torch.save(bridge.params_to_state_dict(params, tcfg), os.path.join(tmp, "params.pt"))
    np.savez(os.path.join(tmp, "batch.npz"), **batch)
    parity = dict(kind="moe_parity", cfg=MOE_CFG, params=os.path.join(tmp, "params.pt"),
                  batch=os.path.join(tmp, "batch.npz"), out=os.path.join(tmp, "parity"))
    outs = tg.gang(tmp, 4, {"expert": 2, "tensor": 2}, runs + [parity])
    return outs, tmp, (jcfg, params, batch), tg.load_parts(parity, 4)


@pytest.fixture(scope="module")
def sequence_tensor_gang(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("st"))
    arrays = {}
    for name in CASES:
        arrays.update({f"{name}/{k}": v for k, v in _case_arrays(name).items()})
    np.savez(os.path.join(tmp, "cases.npz"), **arrays)
    attn = dict(kind="attention", names=list(CASES), cases=os.path.join(tmp, "cases.npz"),
                out=os.path.join(tmp, "attn"))
    outs = tg.gang(tmp, 4, {"sequence": 2, "tensor": 2},
                   [tg.train_run(n) for n in SEQUENCE_TENSOR] + [attn])
    return outs, tg.load_parts(attn, 4)


@pytest.fixture(scope="module")
def tensor_resume_gang(fsdp_tensor_gang, expert_tensor_gang, tmp_path_factory):
    """``{"tensor": 2}`` resuming both gangs' step-3 checkpoints."""
    tmp = str(tmp_path_factory.mktemp("tr"))
    runs = []
    for gang, src in (("fsdp_tensor", fsdp_tensor_gang[1]), ("expert_tensor",
                                                             expert_tensor_gang[1])):
        ckpt = _resumable(os.path.join(src, "ckpt"), os.path.join(tmp, gang), tg.STEPS)
        runs.append(tg.train_run(SAVED[gang], tag=gang, env={
            "TFK8S_CHECKPOINT_DIR": ckpt, "TFK8S_WORLD_VERSION": "1",
            "TFK8S_TRAIN_STEPS": str(tg.STEPS + 2)}))
    return tg.gang(tmp, 2, {"tensor": 2}, runs)


def _assert_gang(outs, name, want):
    for out in outs:
        got = _history(out, name)
        assert len(got) == tg.STEPS
        np.testing.assert_allclose(got, want[name][:tg.STEPS], rtol=tg.RTOL)


@pytest.mark.parametrize("name", FSDP_TENSOR)
def test_fsdp_tensor_gang_equals_one_process(name, fsdp_tensor_gang, one_process):
    """The fsdp axis's dim-0 shards of blocks the tensor axis already split
    (BERT's uneven vocabulary blocks split again)."""
    _assert_gang(fsdp_tensor_gang[0], name, one_process)


@pytest.mark.parametrize("name", DATA_FSDP_TENSOR)
def test_data_fsdp_tensor_gang_equals_one_process(name, data_fsdp_tensor_gang, one_process):
    _assert_gang(data_fsdp_tensor_gang, name, one_process)


@pytest.mark.parametrize("name", EXPERT_TENSOR)
def test_expert_tensor_gang_equals_one_process(name, expert_tensor_gang, one_process):
    """MoE on a tensor mesh: each rank's experts, each at its block of the
    hidden width (``expert_mlp``), the blocks' products summed over
    tensor, the combine over expert."""
    _assert_gang(expert_tensor_gang[0], name, one_process)


@pytest.mark.parametrize("name", SEQUENCE_TENSOR)
def test_sequence_tensor_gang_equals_one_process(name, sequence_tensor_gang, one_process):
    """Ulysses and the ring at a rank's heads, the vocab-parallel loss over
    the sequence group's tokens."""
    _assert_gang(sequence_tensor_gang[0], name, one_process)


def test_reassembled_expert_mlp_model_matches_jax(expert_tensor_gang):
    """The ``{"expert": 2, "tensor": 2}`` blocks of bridged reference
    parameters: loss, metrics, the logits and every gradient, gathered
    whole on each rank, match the reference's."""
    _, _, (jcfg, params, batch), parts = expert_tensor_gang
    jtask = jgpt.make_task(cfg=jcfg, seq_len=16, batch_size=2)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, jbatch, jax.random.key(0)), has_aux=True))(params)
    want_logits, _ = jax.jit(lambda p: japply_with_aux(jgpt.GPTLM(jcfg), jcfg, p,
                                                       jbatch["input"]))(params)
    tcfg = tgpt.tiny_config(dtype=torch.float32, **MOE_CFG)
    wi = "layers.1.moe.wi"
    assert parts[0]["shapes"][wi] == (2, 32, 32)  # 2 of 4 experts, 32 of 64 hidden
    for p in parts:
        np.testing.assert_allclose(p["loss"], float(want_loss), atol=ATOL)
        for k, v in want_m.items():
            np.testing.assert_allclose(p["metrics"][k], float(v), atol=ATOL)
        np.testing.assert_allclose(p["logits"].numpy(), np.asarray(want_logits), atol=ATOL)
        assert p["grads"][wi].shape == (4, 32, 64)
        assert_trees_close(bridge.state_dict_to_params(p["grads"], tcfg), numpy_tree(want_g),
                           ATOL)


def _reference_attention(impl, name):
    a = _case_arrays(name)
    mesh = make_mesh(sequence=2, tensor=2)
    fn = jring(mesh) if impl == "ring" else julysses(mesh)
    mask = jnp.asarray(a["mask"]) if a["mask"].ndim == 2 else None
    causal = bool(a["causal"])

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask=mask, causal=causal), q, k, v)
        return (out, *vjp(g))

    return dict(zip(("out", "dq", "dk", "dv"), run(*(jnp.asarray(a[x]) for x in "qkvg"))))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_attention_at_a_ranks_heads_matches_the_reference(impl, sequence_tensor_gang):
    """Each rank's sequence block of its tensor block of the heads (two of
    four; Ulysses' inner attention at one): out, dq, dk, dv put together
    equal the reference's on a ``{"sequence": 2, "tensor": 2}`` mesh of
    virtual devices."""
    _, parts = sequence_tensor_gang
    order = sorted(parts, key=lambda p: p["coords"])  # (sequence, tensor) rank order
    for name in CASES:
        want = _reference_attention(impl, name)
        for key, w in want.items():
            blocks = [[p["out"][f"{impl}/{name}/{key}"].numpy() for p in order[s * 2:s * 2 + 2]]
                      for s in range(2)]
            got = np.concatenate([np.concatenate(b, axis=2) for b in blocks], axis=1)
            assert np.isfinite(got).all(), (name, key)
            np.testing.assert_allclose(got, np.asarray(w), atol=ATOL, err_msg=f"{name} {key}")


@pytest.mark.parametrize("gang", list(SAVED))
def test_combined_checkpoints_resume_in_one_process_and_on_tensor(gang, request, one_process,
                                                                   tensor_resume_gang,
                                                                   tmp_path):
    """A ``{"fsdp": 2, "tensor": 2}`` and an ``{"expert": 2, "tensor": 2}``
    checkpoint hold whole tensors; each resumes in one process and on
    ``{"tensor": 2}``, continuing the uninterrupted run."""
    name = SAVED[gang]
    src = request.getfixturevalue(f"{gang}_gang")[1]
    saved = torch.load(os.path.join(src, "ckpt", str(tg.STEPS), "state.pt"))
    assert saved["model"]["embed.tok.weight"].shape == (64, 32)
    assert saved["optimizer"]["state"]["layers.0.attn.q.weight"]["exp_avg"].shape == (32, 32)
    if name == "gpt_moe":
        assert saved["model"]["layers.1.moe.wo"].shape == (4, 64, 32)
        assert saved["optimizer"]["state"]["layers.1.moe.wi"]["exp_avg_sq"].shape == (4, 32, 64)
    want = one_process[name][tg.STEPS:]
    ckpt = _resumable(os.path.join(src, "ckpt"), str(tmp_path / "one"), tg.STEPS)
    np.testing.assert_allclose(tg.one_process(name, tg.STEPS + 2, ckpt=ckpt, resume=True), want,
                               rtol=tg.RTOL)
    for out in tensor_resume_gang:
        np.testing.assert_allclose(_history(out, gang), want, rtol=tg.RTOL)


def _mesh(**axes):
    cfg = MeshConfig.create(**axes)
    return Mesh(cfg, torch.device("cpu"), 0, cfg.coords(0), collections.defaultdict(object))


@pytest.mark.parametrize("axes", [{"sequence": 2, "tensor": 2}, {"sequence": 4, "tensor": 2},
                                  {"sequence": 2, "tensor": 4}])
def test_policy_decides_on_a_ranks_head_count(axes):
    """Ulysses while the per-rank head count (4 / tensor) divides by the
    sequence degree, ring beyond it, as the reference decides."""
    cfg = tgpt.tiny_config()
    want = jselect(make_mesh(**axes), jgpt.tiny_config(), 32)
    got = select_attn_fn(cfg, 32, _mesh(**axes))
    assert got.__qualname__.split(".")[0] == want.__qualname__.split(".")[0]


def test_ulysses_head_count_error_equals_the_reference():
    q = jnp.zeros((1, 8, 6, 8))
    with pytest.raises(ValueError) as want:
        julysses(make_mesh(sequence=4, tensor=2))(q, q, q)
    local = torch.zeros(1, 2, 3, 8)  # a rank's sequence block of its 3 heads
    with pytest.raises(ValueError) as got:
        make_ulysses_attn_fn(_mesh(sequence=4, tensor=2))(local, local, local)
    assert str(got.value) == str(want.value)
    assert "(= 6 heads / tensor=2)" in str(got.value)
