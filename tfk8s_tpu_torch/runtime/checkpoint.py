"""Checkpoint/resume over ``torch.save`` and ``torch.distributed.
checkpoint`` — the contract gang restart depends on, kept from the JAX
package's orbax-backed ``Checkpointer``.

Layout: ``<dir>/<step>/`` holds either ``state.pt``, one pickled state
dict written by the coordinator (one process, or replicas on the data
axis), or a ``torch.distributed.checkpoint`` directory to which every
rank wrote its own shards (``save(..., sharded=True)``, the fsdp axis).
A step only counts as restorable once its commit marker
``<dir>/.tfk8s_commits/<step>`` exists, and the coordinator writes the
marker strictly after the step is durably on disk (for shards, after a
barrier behind every rank's write): a kill mid-save leaves an unmarked
directory that ``latest_step``/``all_steps`` skip, and restore falls back
to the previous committed step. A directory with no marker registry at
all is trusted as it is, and the first save into such a directory marks
the steps already there before it writes its own.

``restore`` returns the whole unsharded state whichever way it was
written, so a checkpoint saved by N processes restores in M (elastic
resume). ``save_async`` copies replicated state to host memory at once
(training may go on changing the parameters) and writes it on a
background thread; the marker follows in ``wait_until_finished``/
``maybe_commit``.

Locations are local directories. A plain path becomes absolute.
``gs://bucket/path`` maps to ``<TFK8S_GCS_FAKE_ROOT>/bucket/path``, the
local fake of the object store the JAX package keeps for hermetic runs,
so a job's gs://-shaped checkpoint annotation resumes as there;
``file:///abs/path`` is ``/abs/path``. Any other URI, and ``gs://``
without a fake root, raises: the port has no object-store client.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from tfk8s_tpu_torch.parallel.mesh import rank, world_size
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")

_URI_RE = re.compile(r"^[a-z][a-z0-9+.\-]*://")
_COMMITS_DIRNAME = ".tfk8s_commits"
_STATE_FILE = "state.pt"
_SHARDED_FILE = ".metadata"  # what torch.distributed.checkpoint writes last


def resolve_directory(directory: str) -> str:
    """The local directory a checkpoint location names (module
    docstring). ``TFK8S_GCS_FAKE_ROOT`` is read from ``os.environ`` at
    call time, as the JAX package reads it."""
    if not _URI_RE.match(directory):
        return os.path.abspath(directory)
    scheme = directory.split("://", 1)[0]
    if scheme == "gs":
        fake_root = os.environ.get("TFK8S_GCS_FAKE_ROOT", "")
        if fake_root:
            return os.path.join(os.path.abspath(fake_root), directory[len("gs://"):])
    elif scheme == "file":
        return os.path.abspath(directory[len("file://"):])
    raise NotImplementedError(
        f"checkpoint URI {directory!r}: the port writes local directories and has no "
        f"object-store client for {scheme}://"
        + (" (set TFK8S_GCS_FAKE_ROOT to map gs:// onto a local directory)"
           if scheme == "gs" else "")
    )


def _to_host(obj: Any) -> Any:
    """Deep copy of a state tree with every tensor cloned to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    """Save/restore a state dict under ``directory/<step>``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = resolve_directory(directory) if directory else ""
        self.max_to_keep = max_to_keep
        # steps whose write was started but whose marker is not written
        self._pending: List[int] = []
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._commit_dir = (
            os.path.join(self.directory, _COMMITS_DIRNAME) if self.directory else None
        )
        # the coordinator writes replicated state and every marker
        self._coordinator = rank() == 0
        self._world = world_size()
        if self.directory and self._coordinator:
            os.makedirs(self.directory, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    # -- step listing -----------------------------------------------------------

    def _step_dirs(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and any(os.path.isfile(os.path.join(self.directory, n, f))
                                   for f in (_STATE_FILE, _SHARDED_FILE))
        )

    def _committed_only(self, steps: List[int]) -> List[int]:
        if not os.path.isdir(self._commit_dir):
            return list(steps)
        marked = {int(n) for n in os.listdir(self._commit_dir) if n.isdigit()}
        return [s for s in steps if s in marked]

    def all_steps(self) -> List[int]:
        """Every retained COMMITTED step, ascending."""
        if not self.enabled:
            return []
        return self._committed_only(self._step_dirs())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- commit markers -----------------------------------------------------------

    def _write_marker(self, step: int) -> None:
        with open(os.path.join(self._commit_dir, str(int(step))), "w") as f:
            f.write("committed\n")

    def _commit_pending(self) -> None:
        """Mark every pending step, then drop steps past ``max_to_keep``
        and markers whose step is gone. Only call once the writes are
        known durable."""
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            self._pending.clear()
            raise RuntimeError("checkpoint write failed") from err
        if not self._pending:
            return
        os.makedirs(self._commit_dir, exist_ok=True)
        for step in self._pending:
            self._write_marker(step)
        self._pending.clear()
        keep = self.all_steps()[-self.max_to_keep:] if self.max_to_keep else self.all_steps()
        for step in self._step_dirs():
            if step not in keep:
                shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)
        for n in os.listdir(self._commit_dir):
            if n.isdigit() and int(n) not in keep:
                os.remove(os.path.join(self._commit_dir, n))

    # -- save / restore ------------------------------------------------------------

    def _write(self, step: int, host_state: Any) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            path = os.path.join(tmp, _STATE_FILE)
            with open(path, "wb") as f:
                torch.save(host_state, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        except Exception as e:  # noqa: BLE001 — re-raised at commit
            self._write_error = e

    def save(self, step: int, state: Any, wait: bool = False, sharded: bool = False) -> None:
        """Save ``state`` at ``step``. Every rank calls it. ``sharded``:
        each rank holds shards of the state (DTensors) and writes them; else
        the state is the same on every rank and the coordinator writes it.
        ``wait`` returns once the step is committed, on every rank."""
        self.save_async(step, state, sharded=sharded)
        if wait:
            self.wait_until_finished()
            self._barrier()

    def _barrier(self) -> None:
        if self._world > 1:
            dist.barrier()

    def _open_gate(self) -> None:
        if not os.path.isdir(self._commit_dir):
            # first save here: switch on the strict gate, marking the steps
            # already present, before this step's directory starts to exist
            os.makedirs(self._commit_dir, exist_ok=True)
            for s in self._step_dirs():
                self._write_marker(s)

    def save_async(self, step: int, state: Any, sharded: bool = False) -> None:
        """Replicated state: the coordinator copies it to host memory now
        and writes it on a background thread; its marker is written once
        the write has finished. Sharded state is written at once by every
        rank, and committed behind a barrier."""
        if not self.enabled:
            return
        if self._pending:
            # the previous step commits before this one opens its window
            self.wait_until_finished()
        if sharded:
            self._save_sharded(int(step), state)
            return
        if not self._coordinator:
            return
        self._open_gate()
        host_state = _to_host(state)
        self._pending.append(int(step))
        self._writer = threading.Thread(
            target=self._write, args=(int(step), host_state),
            name="checkpoint-writer", daemon=True,
        )
        self._writer.start()
        log.info("saving checkpoint step=%d -> %s", step, self.directory)

    def _save_sharded(self, step: int, state: Any) -> None:
        import torch.distributed.checkpoint as dcp

        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp"
        if self._coordinator:
            self._open_gate()
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        dcp.save(state, checkpoint_id=tmp)
        self._barrier()  # every rank's shards are on disk
        if self._coordinator:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._pending.append(step)
            self._commit_pending()
        log.info("saved sharded checkpoint step=%d -> %s", step, self.directory)

    def saving_in_progress(self) -> bool:
        return self._writer is not None and self._writer.is_alive()

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._commit_pending()

    def maybe_commit(self) -> None:
        """Commit pending markers iff the write has finished — never
        blocks."""
        if self._pending and not self.saving_in_progress():
            self.wait_until_finished()

    def restore(self, step: Optional[int] = None, map_location: Any = "cpu") -> Any:
        """The whole state saved at ``step`` (default: the newest
        committed), unsharded, whichever way and by however many ranks it
        was written. Reads files only: no collective."""
        if not self.enabled:
            raise RuntimeError("checkpointing is disabled (no directory)")
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(step))
        if os.path.isfile(os.path.join(path, _STATE_FILE)):
            state = torch.load(os.path.join(path, _STATE_FILE),
                               map_location=map_location, weights_only=True)
        else:
            state = _load_sharded(path)
        log.info("restored checkpoint step=%d from %s", step, self.directory)
        return state

    def close(self) -> None:
        """Commit what is pending; every rank returns once it is."""
        self.wait_until_finished()
        self._barrier()


def _load_sharded(path: str) -> Any:
    """Gather a ``torch.distributed.checkpoint`` directory into one
    unsharded state dict on the CPU, in this process alone (what
    ``format_utils.dcp_to_torch_save`` does, without the file)."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
    from torch.distributed.checkpoint.state_dict_loader import _load_state_dict

    state: dict = {}
    _load_state_dict(state, storage_reader=FileSystemReader(path),
                     planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return state
