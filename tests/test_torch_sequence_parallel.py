"""The port's sequence and expert axes against the JAX package's.

Gangs of real processes over gloo on the CPU (the launcher's env contract,
as ``test_torch_distributed.py``), each run once per module:

- ring and Ulysses attention in gangs of 2 and 4: every rank's output,
  dq, dk and dv blocks, put together, against the reference's
  ``make_ring_attn_fn``/``make_ulysses_attn_fn`` on as many virtual CPU
  devices, atol 1e-4: causal, ``[b, lk]`` key masks, unequal lengths
  (end-aligned causal) and a fully padded row (its cotangent masked, as
  the reference's tests mask the loss);
- ``gpt:train``'s path with MoE layers on ``{"sequence": 2}`` (Ulysses by
  the policy; the MoE blocks gather the sequence) and on ``{"data": 2,
  "expert": 2}``, against one process, rtol 1e-5 (the reference's bound,
  ``tests/test_distributed.py``);
- an expert-sharded checkpoint restored in another layout: the
  ``{"data": 2, "expert": 2}`` gang's by one process, and one process's
  by an ``{"expert": 2}`` gang, each continuing the uninterrupted run.

And ``select_attn_fn``'s choices and errors (the reference's
``tests/test_ulysses.py``), over meshes built without a process group.
"""

import collections
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models.transformer import dot_product_attention as jdot
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.ring_attention import make_ring_attn_fn as jring
from tfk8s_tpu.parallel.ulysses import make_ulysses_attn_fn as julysses
from tfk8s_tpu_torch.models import bert as tbert
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import t5 as tt5
from tfk8s_tpu_torch.models import vit as tvit
from tfk8s_tpu_torch.models.transformer import dot_product_attention as tdot
from tfk8s_tpu_torch.models.transformer import select_attn_fn
from tfk8s_tpu_torch.ops.flash_attention import auto_flash_attn_fn, flash_attention
from tfk8s_tpu_torch.parallel import ring_attention as tring
from tfk8s_tpu_torch.parallel.ulysses import make_ulysses_attn_fn
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.runtime import train as ttrain

from test_torch_distributed import _free_port, _lines
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 150
ATOL = 1e-4
RTOL = 1e-5
STEPS = 3

# name: (b, lq, lk, causal, key lengths per row or None)
CASES = {
    "causal": (2, 32, 32, True, None),
    "mask": (2, 32, 32, False, (21, 9)),
    "causal_mask": (2, 32, 32, True, (27, 13)),
    "cross_mask": (2, 16, 32, False, (27, 18)),
    "causal_unequal": (2, 16, 32, True, None),
    "padded_row": (2, 32, 32, True, (21, 0)),
}
H, D = 4, 8

ATTN_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np, torch
    from tfk8s_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from tfk8s_tpu_torch.parallel.ring_attention import make_ring_attn_fn
    from tfk8s_tpu_torch.parallel.ulysses import make_ulysses_attn_fn
    from tfk8s_tpu_torch.runtime import train as ttrain

    env = dict(os.environ)
    ctx, dev = ttrain.join_job(env)
    mesh = build_mesh(ctx.mesh, dev)
    n, r = mesh.size("sequence"), mesh.index("sequence")
    cases = np.load(env["CASES"], allow_pickle=True)
    out = {}
    for impl, fn in (("ring", make_ring_attn_fn(mesh)), ("ulysses", make_ulysses_attn_fn(mesh))):
        for name in cases["names"]:
            c = {k: cases[name + "/" + k] for k in ("q", "k", "v", "g", "mask")}
            causal = bool(cases[name + "/causal"])
            def blk(a):
                w = a.shape[1] // n
                return torch.from_numpy(np.ascontiguousarray(a[:, r * w:(r + 1) * w]))
            q, k, v = (blk(c[x]).requires_grad_() for x in "qkv")
            mask = blk(c["mask"]) if c["mask"].ndim == 2 else None
            o = fn(q, k, v, mask=mask, causal=causal)
            (o * blk(c["g"])).sum().backward()
            for key, t in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                out[impl + "/" + name + "/" + key] = t.detach().numpy()
    np.savez(env["OUT"] + "-%%d.npz" %% r, **out)
    print("DONE", flush=True)
    """
)

TRAIN_WORKER = textwrap.dedent(
    """
    import importlib, json, os, sys
    sys.path.insert(0, %(repo)r)
    import torch
    from tfk8s_tpu_torch.runtime import train as ttrain

    env = dict(os.environ)
    family = importlib.import_module("tfk8s_tpu_torch.models." + env.get("FAMILY", "gpt"))
    cfg = family.tiny_config(dtype=torch.float32, num_experts=int(env.get("EXPERTS", "0")))
    ctx, dev, mesh = ttrain.join_mesh(env)
    task = family.task_for_mesh(mesh, cfg=cfg, **json.loads(env.get("TASK_KW", "{}")))
    fn = next(m.attn_fn for m in task.init(torch.Generator()).modules()
              if hasattr(m, "attn_fn"))
    print("ATTN %%s" %% getattr(fn, "__qualname__", None), flush=True)
    for h in ttrain.run_task(task, env, mesh=mesh):
        print("LOSS %%d %%.17g %%.17g" %% (h["step"], h["loss"], h["grad_norm"]), flush=True)
    """
)

TRAIN_ENV = {"TFK8S_LEARNING_RATE": "1e-2", "TFK8S_INPUT_MODE": "per_host",
             "TFK8S_INPUT_SHARDS": "2", "TFK8S_LOG_EVERY": "1"}


def _gang(tmp, script, n_procs, mesh, extra):
    """``n_procs`` processes of ``script`` joined on a fresh port; their
    outputs, failing the test (after killing the gang) past the timeout or
    on a non-zero exit."""
    path = os.path.join(tmp, "worker.py")
    with open(path, "w") as f:
        f.write(script % {"repo": REPO})
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ, TFK8S_DISTRIBUTED="1", TFK8S_NUM_PROCESSES=str(n_procs),
                   TFK8S_PROCESS_ID=str(pid), TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   TFK8S_DEVICE="cpu", TFK8S_MESH=mesh, OMP_NUM_THREADS="1", **extra)
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


# -- ring and Ulysses attention ----------------------------------------------


def _case_arrays(name):
    b, lq, lk, causal, lengths = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((b, lq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, lk, H, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, lq, H, D)).astype(np.float32)
    mask = np.zeros(0, bool)
    if lengths is not None:
        mask = np.arange(lk)[None, :] < np.array(lengths)[:, None]
        # a row with no visible key: its cotangent masked, as the loss would
        g = g * mask.any(axis=1)[:, None, None, None]
    if causal and lq > lk:
        g = g * (np.arange(lq) + lk - lq >= 0)[None, :, None, None]
    return dict(q=q, k=k, v=v, g=g, mask=mask, causal=np.array(causal))


def _attn_gang(n_procs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(f"attn{n_procs}"))
    arrays = {"names": np.array(list(CASES))}
    for name in CASES:
        arrays.update({f"{name}/{k}": v for k, v in _case_arrays(name).items()})
    np.savez(os.path.join(tmp, "cases.npz"), **arrays)
    _gang(tmp, ATTN_WORKER, n_procs, f'{{"sequence": {n_procs}}}',
          {"CASES": os.path.join(tmp, "cases.npz"), "OUT": os.path.join(tmp, "out")})
    parts = [np.load(os.path.join(tmp, f"out-{r}.npz")) for r in range(n_procs)]
    return {k: np.concatenate([p[k] for p in parts], axis=1) for k in parts[0].files}


@pytest.fixture(scope="module")
def attn_gang_2(tmp_path_factory):
    return _attn_gang(2, tmp_path_factory)


@pytest.fixture(scope="module")
def attn_gang_4(tmp_path_factory):
    return _attn_gang(4, tmp_path_factory)


def _reference(impl, n, name):
    a = _case_arrays(name)
    mesh = make_mesh(sequence=n)
    fn = jring(mesh) if impl == "ring" else julysses(mesh)
    mask = jnp.asarray(a["mask"]) if a["mask"].ndim == 2 else None
    causal = bool(a["causal"])

    @jax.jit  # compiled: several times faster than eager shard_map
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask=mask, causal=causal), q, k, v)
        return (out, *vjp(g))

    got = run(*(jnp.asarray(a[x]) for x in "qkvg"))
    return dict(zip(("out", "dq", "dk", "dv"), got))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_attention_gang_matches_the_reference(impl, n, request):
    got = request.getfixturevalue(f"attn_gang_{n}")
    for name in CASES:
        want = _reference(impl, n, name)
        for key, w in want.items():
            g = got[f"{impl}/{name}/{key}"]
            assert np.isfinite(g).all(), (name, key)
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=f"{name} {key}")


def test_one_process_ring_and_ulysses_are_full_attention():
    """A ring of one (and Ulysses with nothing to exchange) is exact
    attention: the pins are honoured in a one-process run."""
    a = _case_arrays("causal_mask")
    t = {k: torch.from_numpy(a[k]) for k in ("q", "k", "v", "mask")}
    want = np.asarray(jdot(*(jnp.asarray(a[x]) for x in "qkv"), mask=jnp.asarray(a["mask"]),
                           causal=True))
    for fn in (tring.make_ring_attn_fn(torch.device("cpu"), block_k=16),
               make_ulysses_attn_fn(None)):
        got = fn(t["q"], t["k"], t["v"], mask=t["mask"], causal=True)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_ring_block_k_must_divide_and_full_masks_are_refused():
    with pytest.raises(ValueError, match="does not divide"):
        tring._pick_bk(96, 64)
    assert tring._pick_bk(384, None) == 128 and tring._pick_bk(98, None) == 98
    q = torch.zeros(1, 8, 2, 4)
    for fn in (tring.make_ring_attn_fn(None), make_ulysses_attn_fn(None)):
        with pytest.raises(NotImplementedError, match="2-D"):
            fn(q, q, q, mask=torch.ones(1, 8, 8, dtype=torch.bool))


# -- select_attn_fn -----------------------------------------------------------


def _mesh(device="cpu", **axes):
    """A mesh as rank 0 sees it, with stand-in groups (no process group)."""
    cfg = MeshConfig.create(**axes)
    return Mesh(cfg, torch.device(device), 0, cfg.coords(0), collections.defaultdict(object))


def _kind(fn):
    return fn.__qualname__.split(".")[0] if fn is not None else None


def test_impl_selection_policy_matches_the_reference():
    seq_mesh, flat_mesh = _mesh(data=2, sequence=2), _mesh(data=4)
    with pytest.raises(ValueError, match="unknown attention_impl"):
        auto_flash_attn_fn("flsh", 2048, torch.device("cpu"))
    with pytest.raises(ValueError, match="sequence-sharded"):
        tbert.task_for_mesh(seq_mesh, cfg=tbert.tiny_config(attention_impl="flash"),
                            seq_len=32, batch_size=8)
    with pytest.raises(ValueError, match="sequence-sharded"):
        tt5.task_for_mesh(seq_mesh, cfg=tt5.tiny_config(attention_impl="full"),
                          seq_len=16, batch_size=8)
    tt5.task_for_mesh(seq_mesh, cfg=tt5.tiny_config(attention_impl="ring"), seq_len=16,
                      batch_size=8)
    with pytest.raises(ValueError, match="sequence=N"):
        tbert.task_for_mesh(flat_mesh, cfg=tbert.tiny_config(attention_impl="ulysses"),
                            seq_len=32, batch_size=8)
    with pytest.raises(ValueError, match="sequence=N"):
        tt5.task_for_mesh(flat_mesh, cfg=tt5.tiny_config(attention_impl="ring"),
                          seq_len=16, batch_size=8)
    # auto: Ulysses while the 4 heads divide by the degree, ring beyond
    cfg = tgpt.tiny_config()
    assert _kind(select_attn_fn(cfg, 32, _mesh(sequence=2))) == "make_ulysses_attn_fn"
    assert _kind(select_attn_fn(cfg, 32, _mesh(sequence=4))) == "make_ulysses_attn_fn"
    assert _kind(select_attn_fn(cfg, 32, _mesh(sequence=8))) == "make_ring_attn_fn"
    assert select_attn_fn(cfg, 32, flat_mesh) is None
    # Ulysses' local attention: the flash kernels on the card (every length,
    # the head widths they are built for), the reference's plain one else
    assert select_attn_fn(cfg, 32, _mesh(sequence=2)).inner is tdot
    wide = tgpt.tiny_config(head_dim=16)
    assert select_attn_fn(wide, 32, _mesh("cuda", sequence=2)).inner is flash_attention
    assert select_attn_fn(cfg, 32, _mesh("cuda", sequence=2)).inner is tdot  # head_dim 8
    # pins in a one-process run
    for impl in ("ring", "ulysses"):
        fn = select_attn_fn(tgpt.tiny_config(attention_impl=impl), 32, torch.device("cpu"))
        assert _kind(fn) == f"make_{impl}_attn_fn"


def test_tensor_and_pipeline_axes_still_raise():
    """Named for the refusals it held before: the tensor axis runs alone,
    beside data (``tests/test_torch_tensor_parallel.py``) and beside fsdp,
    expert or sequence (``tests/test_torch_axes_tensor.py``); the pipeline
    axis alone, beside data (``tests/test_torch_pipeline.py``) and beside
    sequence (``tests/test_torch_pipeline_axes.py``)."""
    MeshConfig.from_dict({"pipeline": 2, "sequence": 2}).require_ported()
    assert _mesh(pipeline=2, sequence=2).size("pipeline", "sequence") == 4
    for axes in ({"tensor": 2}, {"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2},
                 {"expert": 2, "tensor": 2}, {"sequence": 2, "tensor": 2}):
        MeshConfig.from_dict(axes).require_ported()
        assert _mesh(**axes).size("tensor") == 2


def test_mesh_coordinates_follow_the_reference_order():
    cfg = MeshConfig.create(sequence=2, data=2, expert=2)
    assert cfg.names == ("data", "expert", "sequence")
    assert [tuple(cfg.coords(r).values()) for r in range(8)] == [
        (d, e, s) for d in range(2) for e in range(2) for s in range(2)]
    assert cfg.ranks_along(("expert",)) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert cfg.ranks_along(("data", "fsdp", "sequence")) == [[0, 1, 4, 5], [2, 3, 6, 7]]


# -- gangs against one process ------------------------------------------------


def _losses(out):
    return [(float(a), float(b)) for _, _, a, b in (line.split() for line in _lines(out, "LOSS"))]


# each family's task at the gangs' size: 16 tokens (ViT: 16 patches), 4 rows
TASK_KW = {"gpt": dict(seq_len=16, batch_size=4), "bert": dict(seq_len=16, batch_size=4),
           "t5": dict(seq_len=16, batch_size=4),
           "vit": dict(image_size=16, patch_size=4, batch_size=4)}


def _one_process(steps, ckpt="", experts=0, resume=False, family=tgpt):
    env = dict(TRAIN_ENV, TFK8S_DEVICE="cpu", TFK8S_TRAIN_STEPS=str(steps),
               TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_CHECKPOINT_EVERY=str(STEPS))
    if resume:
        env["TFK8S_WORLD_VERSION"] = "1"
    cfg = family.tiny_config(dtype=torch.float32, num_experts=experts)
    task = family.task_for_mesh(torch.device("cpu"), cfg=cfg,
                                **TASK_KW[family.__name__.rsplit(".", 1)[1]])
    return [(h["loss"], h["grad_norm"]) for h in ttrain.run_task(task, env)]


def _train_gang(tmp_path_factory, n_procs, mesh, **env):
    tmp = str(tmp_path_factory.mktemp("train"))
    env.setdefault("TASK_KW", json.dumps(TASK_KW[env.get("FAMILY", "gpt")]))
    return _gang(tmp, TRAIN_WORKER, n_procs, mesh,
                 {**TRAIN_ENV, "TFK8S_TRAIN_STEPS": str(STEPS), **env}), tmp


def test_sequence_gang_equals_one_process(tmp_path_factory):
    """With MoE layers too: they gather the sequence, so capacities and
    queues count over all of it."""
    outs, _ = _train_gang(tmp_path_factory, 2, '{"sequence": 2}', EXPERTS="2")
    want = _one_process(STEPS, experts=2)
    for out in outs:
        assert _lines(out, "ATTN") == ["ATTN make_ulysses_attn_fn.<locals>.attn_fn"]
        np.testing.assert_allclose(_losses(out), want, rtol=RTOL)


@pytest.mark.parametrize("name", ["bert", "t5", "vit"])
def test_family_sequence_gang_equals_one_process(name, tmp_path_factory):
    """Each other family's sequence path on ``{"sequence": 2}`` with MoE
    layers, through Ulysses: BERT's masked-token loss summed over the
    group, T5's split encoder and decoder (cross-attention over the
    gathered key mask), ViT's patch blocks and pooled sum (its ``1/n``
    gradient scale)."""
    family = {"bert": tbert, "t5": tt5, "vit": tvit}[name]
    outs, _ = _train_gang(tmp_path_factory, 2, '{"sequence": 2}', EXPERTS="2", FAMILY=name)
    want = _one_process(STEPS, experts=2, family=family)
    for out in outs:
        assert _lines(out, "ATTN") == ["ATTN make_ulysses_attn_fn.<locals>.attn_fn"]
        np.testing.assert_allclose(_losses(out), want, rtol=RTOL)


@pytest.fixture(scope="module")
def moe_one_process(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("one") / "ckpt")
    return _one_process(STEPS + 2, ckpt=ckpt, experts=2), ckpt


def test_data_expert_gang_equals_one_process_and_resumes_as_one(moe_one_process,
                                                                 tmp_path_factory):
    want, _ = moe_one_process
    ckpt = str(tmp_path_factory.mktemp("dx") / "ckpt")
    outs, _ = _train_gang(tmp_path_factory, 4, '{"data": 2, "expert": 2}', EXPERTS="2",
                          TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_CHECKPOINT_EVERY=str(STEPS))
    for out in outs:
        np.testing.assert_allclose(_losses(out), want[:STEPS], rtol=RTOL)
    # the gang's whole checkpoint, restored by one process
    assert torch.load(os.path.join(ckpt, str(STEPS), "state.pt"))["model"][
        "layers.1.moe.wi"].shape[0] == 2
    rest = _one_process(STEPS + 2, ckpt=ckpt, experts=2, resume=True)
    np.testing.assert_allclose(rest, want[STEPS:], rtol=RTOL)


def test_expert_gang_resumes_a_one_process_checkpoint(moe_one_process, tmp_path_factory):
    want, ckpt_one = moe_one_process
    ckpt = str(tmp_path_factory.mktemp("ex") / "ckpt")
    shutil.copytree(ckpt_one, ckpt)
    shutil.rmtree(os.path.join(ckpt, str(STEPS + 2)))
    shutil.rmtree(os.path.join(ckpt, ".tfk8s_commits"))
    outs, _ = _train_gang(tmp_path_factory, 2, '{"expert": 2}', EXPERTS="2",
                          TFK8S_CHECKPOINT_DIR=ckpt, TFK8S_TRAIN_STEPS=str(STEPS + 2),
                          TFK8S_WORLD_VERSION="1")
    for out in outs:
        np.testing.assert_allclose(_losses(out), want[STEPS:], rtol=RTOL)
