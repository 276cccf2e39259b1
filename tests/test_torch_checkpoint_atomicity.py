"""The port's checkpoint commit markers against the reference's, on the CPU.

Each of the nine flows of ``tests/test_checkpoint_atomicity.py`` runs
through both packages' ``Checkpointer``s (the reference's over orbax, the
port's over ``torch.save``), each in a directory of its own, on the same
numpy-seeded states (``jnp`` arrays on the reference's side, torch tensors
on the port's). Held equal after each operation: the commit markers under
``.tfk8s_commits`` (None where there is no registry), ``all_steps()``,
``latest_step()``, and the values restored where the flow restores.

Where the two APIs differ the flows adapt: the reference restores into
an example tree (``restore(state_like, step)``), the port returns the
whole saved state (``restore(step, map_location)``); and the reference's
kill mid-write deletes all but the first entry of orbax's step directory,
where the port's step holds one file, ``state.pt``, which is cut to half
its length instead.
"""

import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import torch

from _torch_control import PACKAGES
import _torch_threads  # noqa: F401  (torch's threads under xdist)

_RNG = np.random.default_rng(24)
_W, _B = _RNG.standard_normal(4, dtype=np.float32), _RNG.standard_normal(2, dtype=np.float32)


class _Side:
    """One package's ``Checkpointer`` and the states it saves."""

    def __init__(self, name, directory):
        self.name, self.directory = name, str(directory)
        self.module = PACKAGES[name].checkpoint
        self.open = []

    def checkpointer(self, sub="ck", **kw):
        c = self.module.Checkpointer(os.path.join(self.directory, sub), **kw)
        assert c.enabled
        self.open.append(c)
        return c

    def state(self, v):
        arrays = {"w": _W + np.float32(v), "b": _B * np.float32(10) + np.float32(v)}
        if self.name == "reference":
            return {k: jnp.asarray(a) for k, a in arrays.items()}
        return {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}

    def restored(self, c, step=None):
        """The restored state as lists of floats."""
        if self.name == "reference":
            state = c.restore(self.state(0.0), step=step)
        else:
            state = c.restore(step)
        return {k: np.asarray(v).tolist() for k, v in sorted(state.items())}

    def truncate(self, c, step):
        """A kill mid-write: the step's data partly on disk."""
        step_dir = os.path.join(c.directory, str(step))
        if self.name == "reference":
            for name in os.listdir(step_dir)[1:]:
                p = os.path.join(step_dir, name)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        else:
            path = os.path.join(step_dir, "state.pt")
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)

    def close(self):
        for c in self.open:
            c.close()


def _commit_dir(c):
    return os.path.join(c.directory, PACKAGES["port"].checkpoint._COMMITS_DIRNAME)


def _markers(c):
    commits = _commit_dir(c)
    return (sorted(int(n) for n in os.listdir(commits) if n.isdigit())
            if os.path.isdir(commits) else None)


def _seen(c, label):
    """What a flow holds equal after an operation."""
    return {"at": label, "markers": _markers(c), "all_steps": c.all_steps(),
            "latest": c.latest_step()}


def _both(flow, tmp_path):
    """``flow(side)`` through each package; the records, held equal."""
    out = {}
    for name in PACKAGES:
        side = _Side(name, tmp_path / name)
        try:
            out[name] = flow(side)
        finally:
            side.close()
    assert out["port"] == out["reference"]
    return out["port"]


def test_save_wait_commits_marker_and_discovers(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0), wait=True)
        return [_seen(c, "saved"), side.restored(c)]

    seen, restored = _both(flow, tmp_path)
    assert (seen["markers"], seen["latest"]) == ([10], 10)
    assert restored["w"][0] == float(_W[0] + np.float32(1.0))


def test_async_save_commits_at_next_barrier(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0))
        c.save(20, side.state(2.0))
        # the markers alone: the reference's writer must not list its steps
        # mid-save (test_a_step_listing_mid_save_...)
        started = _markers(c)
        c.wait_until_finished()
        return [started, _seen(c, "finished")]

    started, finished = _both(flow, tmp_path)
    assert started == [10]
    assert (finished["all_steps"], finished["latest"]) == ([10, 20], 20)


def test_uncommitted_partial_step_dir_is_skipped_on_restore(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0), wait=True)
        c.save(20, side.state(2.0), wait=True)
        # the kill lands between the data write and the commit
        os.remove(os.path.join(_commit_dir(c), "20"))
        assert os.path.isdir(os.path.join(c.directory, "20"))
        side.truncate(c, 20)
        fresh = side.checkpointer()  # the restarted process
        return [_seen(fresh, "restarted"), side.restored(fresh)]

    seen, restored = _both(flow, tmp_path)
    assert (seen["latest"], seen["all_steps"]) == (10, [10])
    assert restored["w"][0] == float(_W[0] + np.float32(1.0))


def test_save_async_window_is_invisible_until_committed(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0), wait=True)
        c.save_async(20, side.state(2.0))
        reader = side.checkpointer()
        recs = [_seen(reader, "in the window")]
        c.wait_until_finished()
        return recs + [_seen(reader, "committed")]

    window, committed = _both(flow, tmp_path)
    assert (window["latest"], committed["latest"]) == (10, 20)


def test_first_save_into_fresh_dir_activates_gate_before_writing(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save_async(10, side.state(1.0))
        gate = os.path.isdir(_commit_dir(c))
        fresh = side.checkpointer()  # the writer died before committing
        recs = [gate, _seen(fresh, "first save started")]
        c.wait_until_finished()
        return recs + [_seen(fresh, "committed")]

    gate, started, committed = _both(flow, tmp_path)
    assert gate and (started["latest"], started["all_steps"]) == (None, [])
    assert committed["latest"] == 10


def test_maybe_commit_bounds_replay_to_one_interval(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0))
        deadline = time.time() + 30
        while c.saving_in_progress() and time.time() < deadline:
            time.sleep(0.01)
        c.maybe_commit()
        fresh = side.checkpointer()  # the cold-killed then restarted process
        return [_seen(c, "maybe_commit"), _seen(fresh, "restarted")]

    committed, fresh = _both(flow, tmp_path)
    assert committed["markers"] == [10] and fresh["latest"] == 10


def test_retention_prunes_marker_registry(tmp_path):
    def flow(side):
        c = side.checkpointer("prune", max_to_keep=2)
        recs = []
        for step in (10, 20, 30, 40):
            c.save(step, side.state(float(step)), wait=True)
            recs.append(_seen(c, f"saved {step}"))
        return recs

    recs = _both(flow, tmp_path)
    assert recs[-1]["markers"] == recs[-1]["all_steps"] == [30, 40]
    assert all(len(r["markers"]) <= 2 for r in recs)


def test_legacy_directory_without_marker_registry_still_restores(tmp_path):
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0), wait=True)
        c.save(20, side.state(2.0), wait=True)
        shutil.rmtree(_commit_dir(c))
        fresh = side.checkpointer()
        return [_seen(fresh, "no registry"), side.restored(fresh)]

    seen, restored = _both(flow, tmp_path)
    assert (seen["markers"], seen["latest"]) == (None, 20)
    assert restored["w"][0] == float(_W[0] + np.float32(2.0))


def test_gc_leaves_stale_markers_harmless(tmp_path):
    def flow(side):
        c = side.checkpointer("gc", max_to_keep=2)
        for step in (10, 20, 30):
            c.save(step, side.state(float(step)), wait=True)
        return [_seen(c, "saved 30"), side.restored(c, 20)]

    seen, restored = _both(flow, tmp_path)
    assert 30 in seen["all_steps"] and len(seen["all_steps"]) <= 2
    assert seen["latest"] == 30
    assert restored["b"][0] == float(_B[0] * np.float32(10) + np.float32(20.0))


def test_a_step_listing_mid_save_keeps_the_step_in_flight_on_the_port_alone(tmp_path):
    """The reference's writer that lists its steps while an async save is
    in flight re-reads orbax's step list (``reload``), which drops that
    step, and its commit then prunes the step's marker: a durable step is
    lost to discovery. The port's commit keeps it. A known behaviour of the
    reference, which is not edited."""
    def flow(side):
        c = side.checkpointer()
        c.save(10, side.state(1.0))
        c.save(20, side.state(2.0))
        mid = c.all_steps()
        c.wait_until_finished()
        return [mid, _seen(c, "finished")]

    out = {}
    for name in PACKAGES:
        side = _Side(name, tmp_path / name)
        try:
            out[name] = flow(side)
        finally:
            side.close()
    assert out["port"][0] == out["reference"][0] == [10]
    assert out["port"][1]["all_steps"] == out["port"][1]["markers"] == [10, 20]
    assert out["reference"][1]["all_steps"] == out["reference"][1]["markers"] == [10]
