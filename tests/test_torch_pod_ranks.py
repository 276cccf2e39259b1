"""A pod whose mesh spans several devices, run as one rank process per
device (``tfk8s_tpu_torch/runtime/pod_ranks.py``), on the CPU over gloo.

- one pod of two ranks on ``{"fsdp": 2}`` (GPT, FSDP2) and two pods of two
  ranks on ``{"data": 2, "fsdp": 2}`` (HSDP, the two pods started as two
  processes at one coordinator), each against one process at rtol 1e-5
  (the reference's bound, ``tests/test_distributed.py``);
- the input split: pods of several ranks build the reference's global
  batch in per_host mode, the auto mode follows the pods, and in ``files``
  mode one pod of four ranks reads the reference's one-process batch over
  four devices (the reference gives files to processes, not to ranks);
- the ``fsdp`` route on a card that ranks share over gloo;
- the relay: stop and drain reach every rank, a drain ends in the node
  agent's drained class, a failing rank fails the pod naming it, and no
  rank outlives the call; the errors of a mesh the processes do not
  divide, of several pods without ``TFK8S_DISTRIBUTED=1`` and of a host
  with no card.

``tests/test_torch_pod_jobs.py`` runs the reference's job shapes. The
entry points the ranks run are ``tests/_torch_pod_entry.py``'s (the
families' tiny presets in float32).
"""

import collections
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from tfk8s_tpu.models import gpt as jgpt
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu.runtime.kubelet import PodStopSignal
from tfk8s_tpu.runtime.registry import PodDrained as ReferencePodDrained
from tfk8s_tpu_torch.data import example
from tfk8s_tpu_torch.data.recordio import RecordWriter
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models.bert import make_chain_tokens
from tfk8s_tpu_torch.parallel import data_parallel
from tfk8s_tpu_torch.parallel.data_parallel import DataParallel
from tfk8s_tpu_torch.parallel.mesh import Mesh, MeshConfig
from tfk8s_tpu_torch.runtime import pod_ranks
from tfk8s_tpu_torch.runtime import train as ttrain

import _torch_pod_entry as entry
import _torch_threads  # noqa: F401  (torch's threads under xdist)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
RTOL, ATOL = 1e-5, 1e-4
STEPS = 3
KEYS = ("loss", "grad_norm")
CPU = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_LOG_EVERY": "1",
       "TFK8S_TRAIN_STEPS": str(STEPS), "TFK8S_LEARNING_RATE": "1e-2",
       "TFK8S_SEQ_LEN": "16", "TFK8S_BATCH_SIZE": "8", "OMP_NUM_THREADS": "1"}


def _trajectory(history):
    return [[h[k] for k in KEYS] for h in history]


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def _run_all(runs):
    """Start each of ``runs`` (name -> callable) on a thread of its own;
    the dict their ``(result or the exception raised, the thread's
    PodRun)`` land in, under ``_threads`` the threads to join."""
    out = {}

    def one(name, fn):
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — the tests read it
            value = e
        out[name] = (value, pod_ranks.last_run())

    out["_threads"] = [threading.Thread(target=one, args=item, daemon=True)
                       for item in runs.items()]
    for t in out["_threads"]:
        t.start()
    return out


def _joined(out):
    for t in out.pop("_threads"):
        t.join(timeout=240)
    return out


PARENT = textwrap.dedent(
    """
    import json, os, sys
    sys.path[:0] = [%(repo)r, %(tests)r]
    import _torch_pod_entry as entry
    print("HISTORY " + json.dumps(entry.gpt_f32(dict(os.environ))), flush=True)
    """
)


def _two_pods():
    """``bert-v5p32.yaml``'s shape in miniature: two pods (processes) of
    two ranks on ``{"data": 2, "fsdp": 2}`` at one coordinator; their
    histories."""
    port = pod_ranks.free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, **CPU, TFK8S_MESH=json.dumps({"data": 2, "fsdp": 2}),
                   TFK8S_NUM_PROCESSES="2", TFK8S_PROCESS_ID=str(pid), TFK8S_DISTRIBUTED="1",
                   TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PARENT % {"repo": REPO, "tests": TESTS}], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    histories = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        histories.append(json.loads(next(ln for ln in out.splitlines()
                                         if ln.startswith("HISTORY "))[8:]))
    return histories


def _signalled(signal, ckpt):
    stop = PodStopSignal()
    if signal == "drain":
        stop.request_drain(deadline=1e12)
    else:
        stop.set()
    env = dict(CPU, TFK8S_MESH=json.dumps({"data": 2}), TFK8S_TRAIN_STEPS="50",
               TFK8S_CHECKPOINT_DIR=ckpt)
    return entry.gpt_f32(env, stop)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """The pods of two ranks at once, each on a thread of its own (their
    rank processes' start-up is most of their time), the one-process runs
    meanwhile on this thread: ``({name: (result or the exception raised,
    its PodRun)}, tmp)``."""
    tmp = tmp_path_factory.mktemp("pods")
    runs = {
        "fsdp": lambda: entry.gpt_f32(dict(CPU, TFK8S_MESH=json.dumps({"fsdp": 2}))),
        "drain": lambda: _signalled("drain", str(tmp / "drain")),
        "stop": lambda: _signalled("stop", str(tmp / "stop")),
        "failing": lambda: entry.gpt_failing(
            dict(CPU, TFK8S_MESH=json.dumps({"data": 2}), TFK8S_TRAIN_STEPS="50")),
        "two_pods": _two_pods,
        "rank1_drain": lambda: entry.gpt_drained_by_rank1(
            dict(CPU, TFK8S_MESH=json.dumps({"data": 2}), TFK8S_TRAIN_STEPS="50",
                 TFK8S_CHECKPOINT_DIR=str(tmp / "rank1_drain")), PodStopSignal()),
    }
    out = _run_all(runs)
    out["one_gpt"] = entry.gpt_f32(CPU)
    out["one_gpt_per_host"] = entry.gpt_f32(dict(CPU, TFK8S_INPUT_MODE="per_host",
                                                 TFK8S_INPUT_SHARDS="2"))
    return _joined(out), tmp


def test_one_pod_fsdp_equals_one_process(pods):
    """FSDP2 over the pod's two ranks (gloo on the CPU)."""
    (pod, run), one = pods[0]["fsdp"], pods[0]["one_gpt"]
    assert run.ranks == 2
    np.testing.assert_allclose(_trajectory(pod), _trajectory(one), rtol=RTOL)


def test_two_pods_of_two_ranks_equal_one_process(pods):
    """Two pods of two ranks, per_host input by the reference's default of
    a shard a pod (its process count), against one process on those two
    shards."""
    histories, _ = pods[0]["two_pods"]
    assert len(histories) == 2
    for h in histories:
        np.testing.assert_allclose(_trajectory(h), _trajectory(pods[0]["one_gpt_per_host"]),
                                   rtol=RTOL)


# -- the input split -------------------------------------------------------------


def _pod_trainers(axes, pods, **config):
    """A Trainer for each rank of ``pods`` pods on the mesh ``axes``, each
    over its place in the mesh (no process group: the plans only)."""
    cfg = MeshConfig.create(**axes)
    per = cfg.size() // pods
    task = tgpt.make_task(tgpt.tiny_config(), seq_len=16, batch_size=8)
    out = []
    for r in range(cfg.size()):
        mesh = Mesh(cfg, torch.device("cpu"), r, cfg.coords(r), collections.defaultdict(object))
        out.append(ttrain.Trainer(task, ttrain.TrainConfig(pod_ranks=per, **config),
                                  torch.device("cpu"), DataParallel(mesh, torch.device("cpu"))))
    return out


@pytest.mark.parametrize("axes,pods,shards,n", [
    ({"data": 4}, 2, None, 2), ({"data": 4}, 1, 2, 2), ({"data": 2, "fsdp": 2}, 2, None, 2),
    ({"data": 2, "tensor": 2}, 2, 4, 4), ({"data": 2, "tensor": 2}, 1, 2, 2),
    ({"data": 8}, 2, 8, 8),
    # pods that share rows over a model axis share a block: a shard a block
    ({"data": 2, "tensor": 2}, 4, None, 2), ({"sequence": 2}, 2, None, 1),
])
def test_per_host_pods_build_the_reference_global_batch(axes, pods, shards, n):
    """Each rank builds the shards its rows lie in and keeps its rows; put
    together by batch block they are the reference's global batch of
    ``shards`` (default: a shard a pod's block of rows, the reference's
    process count where the pods hold different rows)."""
    trainers = _pod_trainers(axes, pods, input_mode="per_host", input_shards=shards)
    jtask = jgpt.make_task(jgpt.tiny_config(), seq_len=16, batch_size=8)
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(input_mode="per_host", input_shards=n),
                         make_mesh(data=1))
    want = jtr._make_shard_batch(0, 0, n, n)["input"]
    blocks = {}
    for tr in trainers:
        lo, hi, num = tr._input_shard_plan()
        assert num == n
        rows = tr._make_shard_batch(0, lo, hi, num)["input"][tr._shard_rows]
        prev = blocks.setdefault(tr.parallel.batch_rank, rows)
        np.testing.assert_array_equal(prev, rows)  # the model axes' ranks alike
    np.testing.assert_array_equal(np.concatenate([blocks[b] for b in sorted(blocks)]), want)


def test_shards_may_not_straddle_pods():
    tr = _pod_trainers({"data": 4}, 2, input_mode="per_host", input_shards=4)[0]
    tr._input_shard_plan()
    tr = _pod_trainers({"data": 4}, 4, input_mode="per_host", input_shards=2)[1]
    with pytest.raises(ValueError, match=r"process-local rows \[2,4\) are not aligned"):
        tr._input_shard_plan()


def test_input_mode_follows_the_pods():
    """The reference's rule on its processes: one pod of four ranks is one
    process (replicated), two pods are two (per_host)."""
    assert {t.input_mode() for t in _pod_trainers({"data": 4}, 1)} == {"replicated"}
    assert {t.input_mode() for t in _pod_trainers({"data": 4}, 2)} == {"per_host"}
    assert {t.pods() for t in _pod_trainers({"data": 2, "tensor": 2}, 4)} == {4}


def test_files_one_pod_of_four_ranks_reads_the_reference_batch(tmp_path):
    """``files`` input: one pod of four ranks on ``{"data": 2, "tensor":
    2}`` reads, put together, the reference's one-process batch over four
    devices (the reference gives files to processes, not to ranks)."""
    rng = np.random.default_rng(3)
    for fi in range(4):
        with RecordWriter(str(tmp_path / f"part-{fi}.rio")) as w:
            for toks in make_chain_tokens(rng, 16, 16, tgpt.tiny_config().vocab_size):
                w.write(example.encode({"input": toks.astype(np.int32)}))
    files = str(tmp_path / "part-*.rio")
    jtask = jgpt.make_task(jgpt.tiny_config(), seq_len=16, batch_size=8)
    jtr = jtrain.Trainer(jtask, jtrain.TrainConfig(input_files=files, seed=4),
                         make_mesh(data=2, tensor=2))
    jit = jtr._open_input_files(0)
    want = [next(jit)["input"] for _ in range(2)]
    blocks = {}
    for tr in _pod_trainers({"data": 2, "tensor": 2}, 1, input_files=files, seed=4):
        it = tr._open_input_files(0)
        rows = [next(it)["input"][tr._file_rows] for _ in range(2)]
        it.close()
        prev = blocks.setdefault(tr.parallel.batch_rank, rows)
        np.testing.assert_array_equal(np.stack(prev), np.stack(rows))
    for step in range(2):
        np.testing.assert_array_equal(
            np.concatenate([blocks[b][step] for b in sorted(blocks)]), want[step])


def test_fsdp_on_a_shared_card_takes_fsdp_shards(monkeypatch):
    """Ranks sharing a card run gloo, where FSDP2 of CUDA tensors
    segfaults: fsdp and HSDP take ``FsdpShards`` there, FSDP2 elsewhere."""
    cfg = MeshConfig.create(data=2, fsdp=2)
    mesh = Mesh(cfg, torch.device("cuda", 0), 0, cfg.coords(0), collections.defaultdict(object))
    monkeypatch.setattr(data_parallel.dist, "get_backend", lambda *a: "gloo")
    assert DataParallel(mesh, torch.device("cuda", 0)).mode == "mesh"
    monkeypatch.setattr(data_parallel.dist, "get_backend", lambda *a: "nccl")
    assert DataParallel(mesh, torch.device("cuda", 0)).mode == "hsdp"
    monkeypatch.setattr(data_parallel.dist, "get_backend", lambda *a: "gloo")
    assert DataParallel(mesh, torch.device("cpu")).mode == "hsdp"


# -- the relay -------------------------------------------------------------------


@pytest.mark.parametrize("signal", ["drain", "stop"])
def test_drain_and_stop_reach_every_rank(signal, pods):
    """The node agent's drain notice ends every rank in its drain (a
    checkpoint at the step it reached) and the pod in the agent's drained
    class; its stop ends the ranks' loops, and the pod returns."""
    runs, tmp = pods
    value, run = runs[signal]
    if signal == "drain":
        assert isinstance(value, ReferencePodDrained), value
        assert "drained at step 0" in str(value)
        assert os.path.isdir(tmp / "drain" / "0")
    else:
        assert value == []
    assert [sorted(r) for r in run.records] == [
        sorted(["drained" if signal == "drain" else "result", "wall_s", "device", "backend",
                "peak_memory_bytes", "launches"])] * 2
    assert {(r["device"], r["backend"]) for r in run.records} == {("cpu", "gloo")}
    assert all(_gone(pid) for pid in run.pids)


def test_a_stop_given_at_spawn_waits_for_slow_ranks_to_start(monkeypatch):
    """The stop grace counts from the moment every rank has started: ranks
    whose start takes longer than the grace still take a stop given at
    spawn and end, and the pod returns their empty history."""
    import _torch_pod_slow_entry as slow

    monkeypatch.setattr(pod_ranks, "STOP_GRACE_S", slow.SLOW_START_S / 3)
    stop = PodStopSignal()
    stop.set()
    assert slow.until_stopped(dict(CPU, TFK8S_MESH=json.dumps({"data": 2})), stop) == []
    run = pod_ranks.last_run()
    assert [sorted(r) for r in run.records] == [
        sorted(["result", "wall_s", "device", "backend", "peak_memory_bytes", "launches"])] * 2
    assert all(r["wall_s"] >= slow.SLOW_START_S for r in run.records)
    assert all(_gone(pid) for pid in run.pids)


def test_a_notice_one_rank_sees_drains_every_rank_at_one_step(pods):
    """Rank 1 alone takes the notice after its second step: both ranks
    drain there (one host all-reduce of the signals a step), where rank 0
    would otherwise enter the third step's all-reduce alone."""
    runs, tmp = pods
    value, run = runs["rank1_drain"]
    assert isinstance(value, ReferencePodDrained), value
    assert [r.get("drained", "")[-32:] for r in run.records] == [
        "drained at step 2 on reclaim notice"[-32:]] * 2
    assert os.path.isdir(tmp / "rank1_drain" / "2")


def test_a_failing_rank_fails_the_pod_and_no_rank_outlives_it(pods):
    value, run = pods[0]["failing"]
    assert isinstance(value, pod_ranks.RankFailed), value
    assert str(value).startswith("_torch_pod_entry:gpt_failing: rank 1 (local rank 1 of 2) "
                                 "failed: RuntimeError: planted failure at step 1"), value
    assert (value.rank, value.local_rank) == (1, 1)
    assert "planted failure" in run.records[1]["traceback"]
    assert all(_gone(pid) for pid in run.pids)


@pytest.mark.parametrize("env,error,match", [
    ({"TFK8S_MESH": '{"data": 3}', "TFK8S_NUM_PROCESSES": "2"}, ValueError,
     r"needs 3 devices, which 2 processes do not divide"),
    ({"TFK8S_MESH": '{"data": 4}', "TFK8S_NUM_PROCESSES": "2", "TFK8S_PROCESS_ID": "1"},
     RuntimeError, r"over 2 pods .* needs TFK8S_DISTRIBUTED=1"),
    ({"TFK8S_MESH": '{"data": 2}', "TFK8S_DEVICE": ""}, RuntimeError, r"no CUDA device"),
])
def test_pods_that_cannot_run_their_ranks_raise(env, error, match):
    """Before any rank starts: a mesh the processes do not divide (the
    reference's "needs N devices" wording), several pods outside a process
    group, and a host with no card that did not ask for the CPU."""
    full = dict(CPU, **env)
    if not full["TFK8S_DEVICE"]:
        del full["TFK8S_DEVICE"]
    with pytest.raises(error, match=match):
        tgpt.train(full)
