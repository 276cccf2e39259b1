"""The port's ``TFK8S_SCAN_STEPS`` and ``TFK8S_PROFILE_DIR`` against the
JAX package's ``scan_steps`` and ``profile_dir``.

Scanning dispatches k steps with no host fetch between them; the trajectory
must be per-step dispatch's: scan 1, 4 and 5 give equal histories (the
reference's ``tests/test_train_runtime.py`` check), and the reference
``Trainer`` with ``scan_steps=4`` on the same bridged MLP and batches
agrees to rtol 1e-4. Chunks clamp to the checkpoint cadence (steps 3, 6
and 8 with ``scan_steps=4``), and stop and drain are honoured between
chunks. A ``{"data": 2}`` gang scanning two steps a dispatch follows one
process to rtol 1e-5 (``tests/test_distributed.py``'s bound) and writes
a trace a rank. The profile window writes a Chrome trace of
``profile_steps`` ``ProfilerStep#<step>`` spans, also when the run ends
inside it or a step raises there (the step's own error propagates), and
forces one step a dispatch.
"""

import functools
import glob
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfk8s_tpu.models import mlp as jmlp
from tfk8s_tpu.parallel.mesh import make_mesh
from tfk8s_tpu.parallel.sharding import unbox
from tfk8s_tpu.runtime import train as jtrain
from tfk8s_tpu_torch import bridge
from tfk8s_tpu_torch.models import gpt as tgpt
from tfk8s_tpu_torch.models import mlp as tmlp
from tfk8s_tpu_torch.runtime import train as ttrain
from tfk8s_tpu_torch.runtime.checkpoint import Checkpointer
from tfk8s_tpu_torch.runtime.launcher import ProcessContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4  # the port against the reference Trainer
GANG_RTOL = 1e-5  # a gang against one process
GANG_TIMEOUT = 120
CPU = torch.device("cpu")
# the reference's scan check: 12 steps logged every 6
SCAN_KW = dict(steps=12, learning_rate=1e-2, log_every=6, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The MLP's small products run fastest on one thread; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _history(h, keys=("loss", "grad_norm", "accuracy")):
    return [(x["step"], *(x[k] for k in keys)) for x in h]


def _mlp_fit(**kw):
    trainer = ttrain.Trainer(tmlp.make_task(), ttrain.TrainConfig(**kw), CPU)
    state, hist = trainer.fit()
    return trainer, state, hist


@pytest.fixture(scope="module")
def per_step_history():
    return _history(_mlp_fit(**SCAN_KW)[2])


@pytest.mark.parametrize("scan", [4, 5])  # 5 does not divide log_every: chunks clamp
def test_scan_steps_give_the_per_step_history(scan, per_step_history):
    got = _history(_mlp_fit(scan_steps=scan, **SCAN_KW)[2])
    assert [h[0] for h in got] == [6, 12]
    assert got == per_step_history


def test_scanned_history_follows_the_reference_trainer():
    """The reference Trainer with ``scan_steps=4`` (its ``lax.scan``
    chunks) and the port's with the same, from the same flax-initialised
    parameters on the same ``default_rng(seed)`` batch stream."""
    params = jax.tree_util.tree_map(np.asarray, unbox(jmlp.make_task().init(jax.random.key(0))))
    jtr = jtrain.Trainer(jmlp.make_task(), jtrain.TrainConfig(scan_steps=4, **SCAN_KW),
                         make_mesh(data=1))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.device_put(jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                              opt_state=jtr.optimizer.init(jparams)),
                            jtr.state_shardings)
    _, want = jtr.fit(state=jstate)

    trainer = ttrain.Trainer(tmlp.make_task(), ttrain.TrainConfig(scan_steps=4, **SCAN_KW), CPU)
    state = trainer.init_state()
    state.model.load_state_dict(bridge.mlp_params_to_state_dict(params))
    _, got = trainer.fit(state=state)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [6, 12]
    keys = ("loss", "grad_norm")
    np.testing.assert_allclose(np.array(_history(got, keys))[:, 1:],
                               np.array(_history(want, keys))[:, 1:], rtol=RTOL)


def test_scan_steps_respect_the_checkpoint_cadence(tmp_path):
    _mlp_fit(steps=8, learning_rate=1e-2, log_every=8, checkpoint_every=3,
             checkpoint_dir=str(tmp_path / "ck"), scan_steps=4)
    # the cadence's steps and the final one: a chunk that crossed step 3
    # or 6 would leave its save elsewhere
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [3, 6, 8]


class _FlipAfter:
    """A stop whose ``is_set`` (or ``drain_requested``) turns true on its
    ``after``-th poll; the loop polls both once before each chunk."""

    def __init__(self, after, drain):
        self.polls, self.after, self.drain = 0, after, drain

    def _poll(self):
        self.polls += 1
        return self.polls > self.after

    def is_set(self):
        return not self.drain and self._poll()

    @property
    def drain_requested(self):
        return self.drain and self._poll()


@pytest.mark.parametrize("drain", [False, True])
def test_stop_and_drain_fire_between_chunks(drain, tmp_path):
    """Asked at the second chunk's start, the run ends after the first
    whole chunk of 4 steps, not after one step; a drain commits that
    step's checkpoint."""
    trainer = ttrain.Trainer(tmlp.make_task(), ttrain.TrainConfig(
        steps=12, learning_rate=1e-2, log_every=12, scan_steps=4,
        checkpoint_dir=str(tmp_path)), CPU)
    state, _ = trainer.fit(stop=_FlipAfter(1, drain))
    assert state.step == 4
    assert trainer.drained_at == (4 if drain else None)
    assert Checkpointer(str(tmp_path)).latest_step() == 4


def _step_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("ProfilerStep#")]


@pytest.mark.parametrize("steps,scan,skip,want", [
    (10, 1, 3, [4, 5, 6, 7, 8]),  # the window: 5 steps after the first 3
    (5, 1, 3, [4, 5]),  # the run ends inside the window: its steps still written
    (10, 4, 3, [4, 5, 6, 7, 8]),  # profiling forces one step a dispatch
    (6, 1, 0, [1, 2, 3, 4, 5]),  # no step before the window to warm up on
])
def test_profile_window_writes_a_span_a_step(steps, scan, skip, want, tmp_path):
    _, state, hist = _mlp_fit(
        steps=steps, learning_rate=1e-2, log_every=5, seed=3, scan_steps=scan,
        profile_dir=str(tmp_path / "prof"), profile_skip=skip)
    assert state.step == steps
    assert os.listdir(tmp_path / "prof") == [
        f"mnist-mlp-rank0-steps{want[0]}-{want[-1]}.pt.trace.json"]
    (path,) = glob.glob(str(tmp_path / "prof" / "*"))
    assert _step_spans(path) == [f"ProfilerStep#{s}" for s in want]
    # the trace changes nothing the run computes
    plain = _history(_mlp_fit(steps=steps, learning_rate=1e-2, log_every=5, seed=3)[2])
    assert _history(hist) == plain


def test_a_run_ending_before_the_window_writes_no_trace(tmp_path):
    """Three steps: the trace is prepared at step 3 and the run ends
    before the window's first step, as the reference's writes nothing;
    the next run's trace is whole."""
    _mlp_fit(steps=3, learning_rate=1e-2, log_every=3, profile_dir=str(tmp_path / "a"))
    assert not (tmp_path / "a").exists()
    _mlp_fit(steps=8, learning_rate=1e-2, log_every=4, profile_dir=str(tmp_path / "b"))
    (path,) = glob.glob(str(tmp_path / "b" / "*"))
    assert _step_spans(path) == [f"ProfilerStep#{s}" for s in range(4, 9)]


@pytest.mark.parametrize("export_fails", [False, True], ids=["written", "export-fails"])
def test_a_step_raising_inside_the_window_keeps_its_own_error(export_fails, tmp_path,
                                                                monkeypatch):
    """Step 6 raises inside the window (steps 4-8): the trace of steps 4-5
    is written with no fetch of the failed run's metrics, and the step's
    own error propagates even when writing the trace fails too."""
    trainer = ttrain.Trainer(tmlp.make_task(), ttrain.TrainConfig(
        steps=10, learning_rate=1e-2, log_every=5, profile_dir=str(tmp_path)), CPU)
    real_step = trainer.train_step

    def failing_step(state, batch):
        if state.step == 5:
            raise RuntimeError("step 6 failed")
        return real_step(state, batch)

    monkeypatch.setattr(trainer, "train_step", failing_step)
    if export_fails:
        def no_export(self, path):
            raise RuntimeError("export failed")
        monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", no_export)
    with pytest.raises(RuntimeError, match="step 6 failed"):
        trainer.fit()
    if export_fails:
        assert not os.listdir(tmp_path)
    else:
        (path,) = glob.glob(str(tmp_path / "*"))
        assert path.endswith("mnist-mlp-rank0-steps4-5.pt.trace.json")
        assert _step_spans(path)[:2] == ["ProfilerStep#4", "ProfilerStep#5"]


def test_env_contract_reads_both_knobs_with_the_reference_defaults():
    ctx = ProcessContext.from_env({})
    got = ttrain.config_from_env({"TFK8S_PROFILE_DIR": "p", "TFK8S_SCAN_STEPS": "4"}, ctx)
    assert (got.profile_dir, got.scan_steps) == ("p", 4)
    want = jtrain.TrainConfig()
    base = ttrain.config_from_env({}, ctx)
    for name in ("profile_dir", "profile_skip", "profile_steps", "scan_steps"):
        assert getattr(base, name) == getattr(want, name), name


def test_gpt_train_runs_both_knobs_through_its_entrypoint(tmp_path):
    """``gpt:train`` with ``TFK8S_SCAN_STEPS`` gives its per-step history,
    and with ``TFK8S_PROFILE_DIR`` writes the task's trace."""
    env = {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
           "TFK8S_BATCH_SIZE": "4", "TFK8S_TRAIN_STEPS": "8", "TFK8S_LOG_EVERY": "4"}
    plain = _history(tgpt.train(env), ("loss", "grad_norm"))
    assert _history(tgpt.train(dict(env, TFK8S_SCAN_STEPS="4")), ("loss", "grad_norm")) == plain
    prof = tgpt.train(dict(env, TFK8S_PROFILE_DIR=str(tmp_path)))
    assert _history(prof, ("loss", "grad_norm")) == plain
    (path,) = glob.glob(str(tmp_path / "*"))
    assert os.path.basename(path) == "gpt-lm-rank0-steps4-8.pt.trace.json"
    assert len(_step_spans(path)) == 5


GANG_WORKER = textwrap.dedent(
    """
    import functools, json, os, sys
    sys.path.insert(0, %(repo)r)
    import torch
    from tfk8s_tpu_torch.models import gpt

    gpt.tiny_config = functools.partial(gpt.tiny_config, dtype=torch.float32)

    for run, extra in enumerate(json.loads(os.environ["RUNS"])):
        for h in gpt.train(dict(os.environ, **extra)):
            print("HIST %%d %%d %%.17g %%.17g" %% (run, h["step"], h["loss"], h["grad_norm"]),
                  flush=True)
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gang_env():
    """Per-host input of two shards: two data ranks and one process read
    the same batches."""
    return {"TFK8S_DEVICE": "cpu", "TFK8S_MODEL_PRESET": "tiny", "TFK8S_SEQ_LEN": "16",
            "TFK8S_BATCH_SIZE": "8", "TFK8S_TRAIN_STEPS": "4", "TFK8S_LOG_EVERY": "2",
            "TFK8S_LEARNING_RATE": "3e-3", "TFK8S_INPUT_MODE": "per_host",
            "TFK8S_INPUT_SHARDS": "2"}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One ``{"data": 2}`` gang of the float32 tiny GPT, two runs: two
    steps a dispatch, then a profiled run whose window (steps 4-8) the run's end cuts to step 4.
    Each rank's histories by run, and the profile directory."""
    tmp = tmp_path_factory.mktemp("gang")
    script = tmp / "worker.py"
    script.write_text(GANG_WORKER % {"repo": REPO})
    runs = [{"TFK8S_SCAN_STEPS": "2"}, {"TFK8S_PROFILE_DIR": str(tmp / "prof")}]
    port, procs = _free_port(), []
    for rank in range(2):
        env = dict(os.environ, **_gang_env(), RUNS=json.dumps(runs),
                   TFK8S_DISTRIBUTED="1", TFK8S_NUM_PROCESSES="2", TFK8S_PROCESS_ID=str(rank),
                   TFK8S_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", TFK8S_MESH='{"data": 2}',
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env, cwd=str(tmp),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the gang ran past {GANG_TIMEOUT}s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    hists = [[[tuple(float(x) for x in line.split()[2:]) for line in out.splitlines()
               if line.startswith(f"HIST {run} ")] for run in range(len(runs))] for out in outs]
    return hists, tmp / "prof"


@pytest.mark.parametrize("run", [0, 1], ids=["scanned", "profiled"])
def test_a_data_gang_follows_one_process(run, gang, monkeypatch):
    hists, _ = gang
    monkeypatch.setattr(tgpt, "tiny_config",
                        functools.partial(tgpt.tiny_config, dtype=torch.float32))
    one = _history(tgpt.train(_gang_env()), ("loss", "grad_norm"))
    assert hists[0][run] == hists[1][run]
    assert [h[0] for h in hists[0][run]] == [2, 4]
    np.testing.assert_allclose(np.array(hists[0][run]), np.array(one, dtype=float),
                               rtol=GANG_RTOL)


def test_each_rank_of_a_profiled_gang_writes_its_own_trace(gang):
    _, prof = gang
    names = sorted(os.listdir(prof))
    assert names == [f"gpt-lm-rank{r}-steps4-4.pt.trace.json" for r in (0, 1)]
    for name in names:
        assert _step_spans(prof / name) == ["ProfilerStep#4"]
