"""Multi-process data parallelism in the port, over gloo on the CPU.

Gangs of real OS processes join through the launcher's env contract
(``TFK8S_DISTRIBUTED=1``, ``TFK8S_NUM_PROCESSES``, ``TFK8S_PROCESS_ID``,
``TFK8S_COORDINATOR_ADDRESS``, ``TFK8S_MESH``), each on a fresh port,
each process bounded by a timeout and killed with its gang if it runs
over. Their scripts import only ``tfk8s_tpu_torch``. Each gang runs once
per module and several tests read its output:

- ``data=2`` (DDP) with per-host input: the ranks build disjoint shards
  whose bytes equal a one-process run's, the two trajectories are
  identical and equal the one-process run within rtol 1e-5 (the
  reference's own bound, ``tests/test_distributed.py``), also under
  gradient accumulation; one process resumes the gang's checkpoint
  (``TFK8S_WORLD_VERSION=1``) and equals the uninterrupted run;
- ``fsdp=2`` (FSDP2): a sharded checkpoint, restored by a new gang and
  by one process, with equal parameter checksums and continued losses;
- ``data=2, fsdp=2`` (HSDP, four processes) against one process;
- files input with two processes: the ranks read disjoint files.

Also the launcher's gate (no process group without
``TFK8S_DISTRIBUTED=1``), ``MeshConfig`` against the reference's, and
the pods of layouts with more devices than processes: their rank counts,
global ranks and backends.
"""

import dataclasses
import hashlib
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tfk8s_tpu.parallel.mesh import MeshConfig as JMeshConfig
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu_torch.data import example
from tfk8s_tpu_torch.data.recordio import RecordWriter
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.models.bert import make_chain_tokens
from tfk8s_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from tfk8s_tpu_torch.runtime import launcher, pod_ranks
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.launcher import ProcessContext, initialize_distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 120
RTOL = 1e-5  # gang against one process: the reference's bound
STEPS, BATCH = 3, 8

WORKER = textwrap.dedent(
    """
    import hashlib, os, sys
    sys.path.insert(0, %(repo)r)
    import numpy as np

    from tfk8s_tpu_torch.models import gpt, mlp
    from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
    from tfk8s_tpu_torch.runtime import train as ttrain

    env = dict(os.environ)
    ctx, dev = ttrain.join_job(env)
    if env["TASK"] == "gpt":
        task = gpt.make_task(gpt.tiny_config(), seq_len=32, batch_size=8)
    else:
        task = mlp.make_task(batch_size=8)
    trainer = ttrain.Trainer(task, ttrain.config_from_env(env, ctx), dev,
                             DataParallel(ctx.mesh, dev))
    state, hist = trainer.fit()
    if trainer.input_shard_range is not None:
        print("SHARDS %%d %%d %%d" %% trainer.input_shard_range, flush=True)
    for h in hist:
        print("LOSS %%d %%.17g" %% (h["step"], h["loss"]), flush=True)
    model = state.state_dict()["model"]
    full = [v.full_tensor() if hasattr(v, "full_tensor") else v for v in model.values()]
    print("CHECKSUM %%.17g" %% sum(float(t.double().abs().sum()) for t in full), flush=True)
    if env.get("INPUT_FILES_GLOB"):
        import glob
        from tfk8s_tpu_torch.data.recordio import shard_files
        mine = shard_files(sorted(glob.glob(env["INPUT_FILES_GLOB"])),
                           trainer.parallel.rank, trainer.parallel.world)
        print("MYFILES " + ",".join(os.path.basename(f) for f in mine), flush=True)
    if trainer.input_mode() == "per_host":
        lo, hi, n = trainer.input_shard_range
        for step in range(int(env.get("TFK8S_TRAIN_STEPS"))):
            for s in range(lo, hi):
                shard = trainer._make_shard_batch(step, s, s + 1, n)
                h = hashlib.sha256()
                for k in sorted(shard):
                    h.update(np.ascontiguousarray(shard[k]).tobytes())
                print("BATCHHASH %%d %%d %%s" %% (step, s, h.hexdigest()[:16]), flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_gang(tmp, n_procs, mesh, extra):
    """``n_procs`` worker processes joined on a fresh port; returns their
    outputs, failing the test (after killing the gang) if any runs past
    ``GANG_TIMEOUT`` or exits non-zero."""
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER % {"repo": REPO})
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env.update(
            TFK8S_DISTRIBUTED="1", TFK8S_NUM_PROCESSES=str(n_procs),
            TFK8S_PROCESS_ID=str(pid), TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            TFK8S_DEVICE="cpu", TFK8S_LOG_EVERY="1", OMP_NUM_THREADS="1", **extra,
        )
        if mesh:
            env["TFK8S_MESH"] = mesh
        procs.append(subprocess.Popen([sys.executable, script], env=env, cwd=tmp,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"gang of {n_procs} ({mesh}) ran past {GANG_TIMEOUT}s")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outs


def _lines(out, tag):
    return [line for line in out.splitlines() if line.startswith(tag)]


def _losses(out):
    return [float(line.split()[2]) for line in _lines(out, "LOSS")]


def _checksum(out):
    return _lines(out, "CHECKSUM")[0]


MLP_ENV = {"TASK": "mlp", "TFK8S_TRAIN_STEPS": str(STEPS), "TFK8S_LEARNING_RATE": "1e-3",
           "TFK8S_INPUT_MODE": "per_host", "TFK8S_INPUT_SHARDS": "2",
           "TFK8S_CHECKPOINT_EVERY": str(STEPS)}


def _mlp_task():
    return dataclasses.replace(tmlp.make_task(batch_size=BATCH), targets={})


def _one_process(steps, ckpt="", **env):
    """The same MLP run in this process, alone, through ``run_task``."""
    full = {"TFK8S_DEVICE": "cpu", "TFK8S_LOG_EVERY": "1", "TFK8S_CHECKPOINT_DIR": ckpt,
            **{k: v for k, v in MLP_ENV.items() if k != "TASK"}, "TFK8S_TRAIN_STEPS": str(steps),
            **env}
    return ttrain.run_task(_mlp_task(), full)


@pytest.fixture(scope="module")
def one_process():
    """The uninterrupted one-process run, five steps."""
    return [h["loss"] for h in _one_process(STEPS + 2)]


def _gang_fixture(n_procs, mesh, **env):
    @pytest.fixture(scope="module")
    def run(tmp_path_factory):
        tmp = str(tmp_path_factory.mktemp("gang"))
        ckpt = os.path.join(tmp, "ckpt")
        outs = _run_gang(tmp, n_procs, mesh, dict(MLP_ENV, TFK8S_CHECKPOINT_DIR=ckpt, **env))
        return outs, ckpt

    return run


dp_gang = _gang_fixture(2, '{"data": 2}')
# two microbatches a rank: every one but the last skips the all-reduce
dp_accum_gang = _gang_fixture(2, '{"data": 2}', TFK8S_GRAD_ACCUM="2")
fsdp_gang = _gang_fixture(2, '{"fsdp": 2}')
# four ranks of two rows each: four input shards
hsdp_gang = _gang_fixture(4, '{"data": 2, "fsdp": 2}', TFK8S_INPUT_SHARDS="4")


def test_data_gang_builds_disjoint_shards_equal_to_one_process(dp_gang):
    outs, _ = dp_gang
    assert {line for out in outs for line in _lines(out, "SHARDS")} == {
        "SHARDS 0 1 2", "SHARDS 1 2 2"}
    trainer = ttrain.Trainer(_mlp_task(), ttrain.TrainConfig(input_mode="per_host",
                                                             input_shards=2),
                             torch.device("cpu"))
    single = set()
    for step in range(STEPS):
        for s in range(2):
            shard = trainer._make_shard_batch(step, s, s + 1, 2)
            h = hashlib.sha256()
            for k in sorted(shard):
                h.update(np.ascontiguousarray(shard[k]).tobytes())
            single.add(f"BATCHHASH {step} {s} {h.hexdigest()[:16]}")
    gang = {line for out in outs for line in _lines(out, "BATCHHASH")}
    assert gang == single and len(gang) == STEPS * 2


def test_data_gang_trajectories_are_identical_and_equal_one_process(dp_gang, one_process):
    outs, _ = dp_gang
    assert _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
    assert _checksum(outs[0]) == _checksum(outs[1])
    np.testing.assert_allclose(_losses(outs[0]), one_process[:STEPS], rtol=RTOL)


def test_data_gang_with_gradient_accumulation_equals_one_process(dp_accum_gang):
    outs, _ = dp_accum_gang
    assert _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
    assert _checksum(outs[0]) == _checksum(outs[1])
    single = [h["loss"] for h in _one_process(STEPS, TFK8S_GRAD_ACCUM="2")]
    np.testing.assert_allclose(_losses(outs[0]), single, rtol=RTOL)


def test_one_process_resumes_the_gang_checkpoint(dp_gang, one_process, tmp_path):
    """Elastic: two processes saved; one process of world version 1
    resumes and equals the uninterrupted run."""
    _, ckpt = dp_gang
    mine = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, mine)
    history = _one_process(STEPS + 2, mine, TFK8S_WORLD_VERSION="1")
    assert [h["step"] for h in history] == [STEPS + 1, STEPS + 2]
    np.testing.assert_allclose([h["loss"] for h in history], one_process[STEPS:], rtol=RTOL)


class _DrainNow:
    drain_requested = True

    def is_set(self):
        return False


def test_a_checkpoint_before_the_first_step_resumes_exactly(one_process, tmp_path):
    """The optimizer is untouched at step 0: its saved state must resume
    as a fresh one does (AdamW's count 0, not a count from initialising
    the state for the save)."""
    ckpt = str(tmp_path / "ckpt")
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_CHECKPOINT_DIR": ckpt, "TFK8S_TRAIN_STEPS": str(STEPS),
           "TFK8S_LOG_EVERY": "1", **{k: v for k, v in MLP_ENV.items() if k != "TASK"}}
    with pytest.raises(ttrain.PodDrained):
        ttrain.run_task(_mlp_task(), env, stop=_DrainNow())
    history = _one_process(STEPS, ckpt, TFK8S_GANG_RESTARTS="1")
    np.testing.assert_allclose([h["loss"] for h in history], one_process[:STEPS], rtol=RTOL)


def test_fsdp_gang_equals_one_process(fsdp_gang, one_process):
    outs, ckpt = fsdp_gang
    assert _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
    assert _checksum(outs[0]) == _checksum(outs[1])
    np.testing.assert_allclose(_losses(outs[0]), one_process[:STEPS], rtol=RTOL)
    # every rank wrote its own shards of the step
    step_dir = os.path.join(ckpt, str(STEPS))
    assert sorted(os.listdir(step_dir)) == [".metadata", "__0_0.distcp", "__1_0.distcp"]


def test_fsdp_checkpoint_restores_in_a_new_gang(fsdp_gang, one_process, tmp_path):
    outs, ckpt = fsdp_gang
    mine = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, mine)
    resumed = _run_gang(str(tmp_path), 2, '{"fsdp": 2}', dict(
        MLP_ENV, TFK8S_CHECKPOINT_DIR=mine, TFK8S_GANG_RESTARTS="1",
        TFK8S_TRAIN_STEPS=str(STEPS + 2), TFK8S_CHECKPOINT_EVERY="0"))
    assert [int(line.split()[1]) for line in _lines(resumed[0], "LOSS")] == [STEPS + 1, STEPS + 2]
    assert _lines(resumed[0], "LOSS") == _lines(resumed[1], "LOSS")
    np.testing.assert_allclose(_losses(resumed[0]), one_process[STEPS:], rtol=RTOL)
    # the restored parameters are the saved ones: restore alone, here
    saved = ttrain.Checkpointer(ckpt).restore(STEPS)
    total = sum(float(t.double().abs().sum()) for t in saved["model"].values())
    assert f"CHECKSUM {total:.17g}" == _checksum(outs[0])


def test_one_process_resumes_the_sharded_checkpoint(fsdp_gang, one_process, tmp_path):
    _, ckpt = fsdp_gang
    mine = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, mine)
    history = _one_process(STEPS + 2, mine, TFK8S_WORLD_VERSION="1")
    np.testing.assert_allclose([h["loss"] for h in history], one_process[STEPS:], rtol=RTOL)


def test_hsdp_gang_of_four_equals_one_process(hsdp_gang):
    outs, _ = hsdp_gang
    assert len({tuple(_lines(out, "LOSS")) for out in outs}) == 1
    assert len({_checksum(out) for out in outs}) == 1
    assert sorted(line for out in outs for line in _lines(out, "SHARDS")) == [
        f"SHARDS {r} {r + 1} 4" for r in range(4)]
    single = [h["loss"] for h in _one_process(STEPS, TFK8S_INPUT_SHARDS="4")]
    np.testing.assert_allclose(_losses(outs[0]), single, rtol=RTOL)


def test_two_process_file_input_reads_disjoint_files(tmp_path):
    rng = np.random.default_rng(0)
    vocab = tgpt.tiny_config().vocab_size
    for fi in range(4):
        with RecordWriter(str(tmp_path / f"part-{fi}.rio")) as w:
            for _ in range(16):
                toks = make_chain_tokens(rng, 1, 32, vocab)[0]
                w.write(example.encode({"input": toks.astype(np.int32)}))
    pattern = str(tmp_path / "part-*.rio")
    outs = _run_gang(str(tmp_path), 2, '{"data": 2}', {
        "TASK": "gpt", "TFK8S_TRAIN_STEPS": "3", "TFK8S_LEARNING_RATE": "1e-3",
        "TFK8S_INPUT_FILES": pattern, "INPUT_FILES_GLOB": pattern})
    assert sorted(line for out in outs for line in _lines(out, "MYFILES")) == [
        "MYFILES part-0.rio,part-2.rio", "MYFILES part-1.rio,part-3.rio"]
    assert {line for out in outs for line in _lines(out, "SHARDS")} == {
        "SHARDS 0 1 2", "SHARDS 1 2 2"}
    assert _lines(outs[0], "LOSS") == _lines(outs[1], "LOSS")
    losses = _losses(outs[0])
    assert len(losses) == 3 and all(np.isfinite(losses))


# -- launcher and mesh ---------------------------------------------------------


def test_no_process_group_without_the_distributed_flag():
    env = {"TFK8S_NUM_PROCESSES": "2", "TFK8S_PROCESS_ID": "1",
           "TFK8S_COORDINATOR_ADDRESS": "127.0.0.1:1", "TFK8S_DEVICE": "cpu"}
    ctx = ProcessContext.from_env(env)
    assert (ctx.num_processes, ctx.process_id, ctx.is_coordinator) == (2, 1, False)
    assert initialize_distributed(ctx, env) is False
    assert not dist.is_initialized()
    # replicas run as threads of one process each train alone
    history = _one_process(1)
    assert history[-1]["step"] == 1 and not dist.is_initialized()


def test_process_context_reads_the_reference_fields():
    env = {"TFK8S_JOB_NAME": "j", "TFK8S_NAMESPACE": "ns", "TFK8S_REPLICA_TYPE": "Evaluator",
           "TFK8S_REPLICA_INDEX": "3", "TFK8S_HOST_INDEX": "2", "TFK8S_ACCELERATOR": "cpu-4",
           "TFK8S_SLICE_ID": "s0", "TFK8S_WORLD_VERSION": "1", "TFK8S_MESH": '{"fsdp": 2, "data": 2}'}
    ctx = ProcessContext.from_env(env)
    assert (ctx.job_name, ctx.namespace, ctx.replica_type, ctx.replica_index,
            ctx.host_index, ctx.accelerator, ctx.slice_id) == (
        "j", "ns", "Evaluator", 3, 2, "cpu-4", "s0")
    assert ctx.resuming and ctx.mesh.names == ("data", "fsdp")


@pytest.mark.parametrize("axes", [{"data": 4}, {"fsdp": 2, "data": 2}, {"tensor": 2, "data": 1},
                                  {"data": 1}, {"custom": 3, "data": 2}])
def test_mesh_config_matches_the_reference(axes):
    got, want = MeshConfig.from_dict(axes), JMeshConfig.from_dict(axes)
    assert (got.names, got.shape, got.size()) == (want.names, want.shape, want.size())
    for name in ("data", "fsdp", "tensor", "custom"):
        assert got.axis_size(name) == want.axis_size(name)


def test_mesh_device_count_error_matches_the_reference():
    with pytest.raises(ValueError) as want:
        make_mesh(data=16)
    with pytest.raises(ValueError) as got:
        MeshConfig.create(data=16).check_devices(8)
    assert str(got.value) == str(want.value)
    # one process holds one device: a two-device mesh needs a gang
    with pytest.raises(ValueError, match=r"needs 2 devices; 1 available"):
        build_mesh(MeshConfig.create(data=2), torch.device("cpu"))
    assert build_mesh(MeshConfig.create(data=1), torch.device("cpu")).device_mesh is None


def _assert_pods(env, ranks, monkeypatch):
    """``env``'s pods each run ``ranks`` rank processes: pod ``p``'s are
    global ranks ``p * ranks + l`` of ``n * ranks``, each a rank alone (a
    gang member as started by hand); over gloo on the CPU and where they
    share one card, over NCCL where each has a card of its own."""
    ctx = ProcessContext.from_env(env)
    assert ctx.pod_ranks() == ranks
    n = ctx.num_processes
    for p in range(n):
        pod = dict(env, TFK8S_PROCESS_ID=str(p), TFK8S_DISTRIBUTED="1",
                   TFK8S_COORDINATOR_ADDRESS="10.0.0.1:8476", TFK8S_SLICE_ID=f"s{p}")
        envs = pod_ranks.rank_envs(pod, ranks)
        assert [int(e["TFK8S_PROCESS_ID"]) for e in envs] == [p * ranks + l for l in range(ranks)]
        for l, e in enumerate(envs):
            rank = ProcessContext.from_env(e)
            assert (rank.num_processes, rank.local_rank, rank.local_ranks) == (n * ranks, l, ranks)
            assert rank.pod_ranks() == 1 and rank.slice_id == f"s{p}"
            # one pod meets on loopback; several at the job's coordinator
            assert rank.coordinator_address.startswith("127.0.0.1:" if n == 1 else "10.0.0.1:")
    assert launcher.backend_for("cpu", ranks) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launcher.backend_for("cuda", ranks) == ("nccl" if ranks == 1 else "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: ranks)
    assert launcher.backend_for("cuda", ranks) == "nccl"


@pytest.mark.parametrize("mesh", [
    # tensor beside fsdp, expert or sequence runs
    # (tests/test_torch_axes_tensor.py)
    '{"fsdp": 2, "tensor": 2}', '{"expert": 2, "tensor": 2}', '{"sequence": 2, "tensor": 2}',
])
def test_combined_layouts_pass_the_launcher_check(mesh, monkeypatch):
    """Four processes run these four-device layouts a rank each; two
    processes run two ranks a pod."""
    _assert_pods({"TFK8S_MESH": mesh, "TFK8S_NUM_PROCESSES": "4"}, 1, monkeypatch)
    _assert_pods({"TFK8S_MESH": mesh, "TFK8S_NUM_PROCESSES": "2"}, 2, monkeypatch)


@pytest.mark.parametrize("env,ranks", [
    # pipeline runs beside every axis in a gang (tests/test_torch_pipeline*.py)
    ({"TFK8S_MESH": '{"expert": 2, "pipeline": 2}', "TFK8S_NUM_PROCESSES": "4"}, 1),
    ({"TFK8S_MESH": '{"pipeline": 2, "tensor": 2}', "TFK8S_NUM_PROCESSES": "4"}, 1),
    # multislice runs (tests/test_torch_multislice.py); a multislice mesh
    # of more devices than processes runs a pod's ranks in its slice
    ({"TFK8S_NUM_SLICES": "2", "TFK8S_MESH": '{"data": 4}', "TFK8S_NUM_PROCESSES": "2"}, 2),
    ({"TFK8S_MESH": '{"data": 4}', "TFK8S_NUM_PROCESSES": "2"}, 2),
    # image input runs (tests/test_torch_image_job.py); a four-device
    # layout in one process runs four ranks
    ({"TFK8S_INPUT_FILES": "x-*.rio", "TFK8S_INPUT_FORMAT": "image",
      "TFK8S_MESH": '{"data": 4}', "TFK8S_NUM_PROCESSES": "1"}, 4),
])
def test_unported_layouts_raise_naming_their_item(env, ranks, monkeypatch):
    """The layouts that raised ROADMAP item 1.5 (more devices than
    processes) run a pod's ranks a device each."""
    MeshConfig.from_env(env).require_ported()  # every layout passes the mesh rules
    _assert_pods(env, ranks, monkeypatch)
