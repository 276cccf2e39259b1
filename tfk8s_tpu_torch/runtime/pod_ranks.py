"""A pod's rank processes: one per device of its share of the mesh.

The reference runs one process a host over every chip of it: its launcher
builds the mesh over ``jax.devices()``, so a TPUJob whose ``TFK8S_MESH``
spans more devices than it has processes (``cpu-4`` with one Worker on
``{"data": 2, "tensor": 2}``, four hosts over sixteen chips) runs as one
program a host. The port runs one rank process per device instead, a
card each (``runtime/launcher.py``), so such a pod starts
``ProcessContext.pod_ranks()`` = ``d`` rank processes of its own:

- :func:`ranks` is an entry point's first act (the :func:`entrypoint`
  decorator of every family's ``train``): where the pod has more than one
  rank it runs them (:func:`run`) and returns rank 0's metrics history as
  the entry point's result; else it returns None and the entry point
  trains in this process, as before;
- each rank is ``python -m tfk8s_tpu_torch.runtime.pod_ranks <entrypoint>``
  (never ``fork``: the node agent runs pods as threads of a process that
  holds torch and, on the card, CUDA), given the pod's env with
  ``TFK8S_PROCESS_ID`` = ``p * d + l``, ``TFK8S_NUM_PROCESSES`` = ``n * d``,
  ``TFK8S_DISTRIBUTED=1``, ``TFK8S_LOCAL_RANK`` = ``l`` and
  ``TFK8S_POD_RANKS`` = ``d``, so it is exactly a gang member started by
  hand and runs the entry point's unchanged path (whose ``ranks`` call
  then finds one rank). It resolves the entry point on this process's
  ``sys.path``;
- the ranks meet on a free loopback port when the job is this one pod (the
  group never leaves the pod, as the reference's one-process mesh needs
  no coordinator), else at ``TFK8S_COORDINATOR_ADDRESS``, where pod 0's
  rank 0 is global rank 0; several pods need ``TFK8S_DISTRIBUTED=1``;
- this process relays between the node agent and the ranks: the agent's
  stop and drain notice go to every rank (a line on its stdin), rank 0's
  progress reports reach the agent's sink on the entry point's thread
  (``runtime/node_agent.attach``), a drained rank ends in the agent's
  drained class, and a failed rank ends the others and raises
  :class:`RankFailed`, naming it and carrying its exception's text;
- no rank outlives its pod: after a stop and :data:`STOP_GRACE_S`, or at
  once after a failure, the ranks are terminated, then killed after
  :data:`TERM_GRACE_S`, and every one is joined on every path; a rank
  whose stdin closes (this process gone) exits at once with no final save
  (its node is lost, as the reference's one process a host would be), or,
  once told to stop, :data:`STOP_GRACE_S` later whatever it is doing. The
  grace counts from the stop or from the moment every rank has said it
  started (its entry point imported), whichever is later: a stop given
  at spawn must not spend the grace on the ranks' interpreter start and
  torch import, which on a loaded host take more than the grace itself.
  A rank that has not started :data:`START_GRACE_S` after the spawn no
  longer holds the grace back.

In a rank process this module stands in for the node agent: the stop
object is a :class:`RankStop`, whose module holds the three names
``node_agent.find`` looks up (``PodDrained``, ``_progress`` and
``get_tracer``), so the trainer's progress, drain and spans reach this
module, which sends them to the pod's process as JSON lines on a pipe of
their own. A rank's last line carries its history, or the drain, or its
error, with its wall time, peak device memory and the port's kernel
launch counts; :func:`last_run` gives them for the latest pod the calling
thread ran.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import logging
import os
import queue
import random
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from tfk8s_tpu_torch.obs.trace import Tracer
from tfk8s_tpu_torch.runtime import node_agent, progress
from tfk8s_tpu_torch.runtime.launcher import (LOCAL_RANK_ENV, POD_RANKS_ENV, ProcessContext,
                                              requested_device)
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("pod_ranks")

# seconds the ranks get to end after a stop before they are terminated,
# and after a terminate before they are killed
STOP_GRACE_S = 30.0
TERM_GRACE_S = 5.0
# seconds from the spawn after which a rank that has not started counts
# as started for the stop grace
START_GRACE_S = 120.0
# the op modules whose LAUNCHES a rank reports
_KERNEL_MODULES = ("flash_attention", "group_norm", "block_copy")


class RankFailed(RuntimeError):
    """A rank of the pod failed: raised by the pod's process after it has
    ended the others. ``rank`` is its global rank, ``local_rank`` its
    index in the pod (its traceback is in :func:`last_run`'s record)."""

    def __init__(self, message: str, rank: int, local_rank: int):
        super().__init__(message)
        self.rank, self.local_rank = rank, local_rank


@dataclasses.dataclass
class PodRun:
    """What a pod's ranks did: ``records`` holds each rank's last message
    (its ``wall_s``, ``device``, ``backend``, ``peak_memory_bytes``,
    ``launches``, and ``result``,
    ``drained`` or ``error``) in local-rank order, None for a rank that
    sent none; ``first_rank`` is its rank 0's global rank, ``pids`` its
    ranks' process ids; ``first_step_s`` is the time from the spawn to rank 0's
    first finished step."""

    entrypoint: str
    ranks: int
    first_rank: int
    world: int
    first_step_s: Optional[float] = None
    wall_s: float = 0.0
    records: List[Optional[Dict[str, Any]]] = dataclasses.field(default_factory=list)
    pids: List[int] = dataclasses.field(default_factory=list)


_LOCK = threading.Lock()
_LAST: Dict[int, PodRun] = {}


def last_run() -> Optional[PodRun]:
    """The latest pod the calling thread ran (:func:`run`), if any."""
    with _LOCK:
        return _LAST.get(threading.get_ident())


def ranks(entrypoint: str, env: Dict[str, str], stop: Optional[Any] = None
          ) -> Optional[List[Dict[str, float]]]:
    """An entry point's first act: where the pod runs more than one rank
    (:meth:`ProcessContext.pod_ranks`), run them on ``entrypoint`` (the
    entry point's own ``module:function``) and return rank 0's metrics
    history; None where the pod is one rank."""
    d = ProcessContext.from_env(env).pod_ranks()
    return None if d == 1 else run(entrypoint, env, stop, d)


def entrypoint(fn: Callable[..., Any]) -> Callable[..., Any]:
    """A family's ``train(env, stop)`` with :func:`ranks` as its first
    act, on its own ``module:function`` string."""
    name = f"{fn.__module__}:{fn.__qualname__}"

    @functools.wraps(fn)
    def train(env: Dict[str, str], stop: Optional[Any] = None) -> Any:
        history = ranks(name, env, stop)
        return fn(env, stop) if history is None else history

    return train


def rank_envs(env: Dict[str, str], d: int) -> List[Dict[str, str]]:
    """The pod env of each of its ``d`` ranks, in local-rank order."""
    ctx = ProcessContext.from_env(env)
    n = ctx.num_processes
    if n == 1:
        addr = f"127.0.0.1:{free_port()}"
    elif env.get("TFK8S_DISTRIBUTED") != "1":
        raise RuntimeError(
            f"a mesh of {n * d} devices over {n} pods runs {d} ranks a pod in one "
            "process group across the pods, which needs TFK8S_DISTRIBUTED=1"
        )
    elif not ctx.coordinator_address:
        raise RuntimeError(f"{n} pods of {d} ranks need TFK8S_COORDINATOR_ADDRESS")
    else:
        addr = ctx.coordinator_address
    # the pod's ranks are contiguous, pod-major, as the reference orders
    # its processes' devices
    return [dict(env, TFK8S_PROCESS_ID=str(ctx.process_id * d + l),
                 TFK8S_NUM_PROCESSES=str(n * d), TFK8S_DISTRIBUTED="1",
                 TFK8S_COORDINATOR_ADDRESS=addr, **{LOCAL_RANK_ENV: str(l), POD_RANKS_ENV: str(d)})
            for l in range(d)]


def free_port() -> int:
    """A loopback port free now, below the host's ephemeral range: a port
    the kernel hands out (``bind`` to 0) can be taken by another process
    group's connections before the ranks' store binds it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            first = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        first = 32768
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(max(first - 12000, 1024), first)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free loopback port for the pod's ranks")


def _child_path() -> str:
    """``PYTHONPATH`` for a rank: this process's ``sys.path``, so the rank
    resolves the entry point as the pod's process did."""
    return os.pathsep.join(os.getcwd() if p == "" else p for p in sys.path
                           if isinstance(p, str))


def run(entrypoint: str, env: Dict[str, str], stop: Optional[Any], d: int
        ) -> List[Dict[str, float]]:
    """Run the pod's ``d`` ranks on ``entrypoint`` and relay for them until
    they end; rank 0's history. Raises the node agent's drained class
    after a drain, and :class:`RankFailed` when a rank fails or one has
    not ended :data:`STOP_GRACE_S` after a stop."""
    # no card and no request for the CPU: raise, as a rank would (the pod's
    # process makes no CUDA context of its own)
    requested_device(env)
    envs = rank_envs(env, d)
    ctx = ProcessContext.from_env(envs[0])
    pod = PodRun(entrypoint, d, ctx.process_id, ctx.num_processes, records=[None] * d)
    with _LOCK:
        _LAST[threading.get_ident()] = pod
    messages: "queue.Queue" = queue.Queue()
    procs: List[subprocess.Popen] = []
    t0 = time.perf_counter()
    penv = dict(os.environ, PYTHONPATH=_child_path())
    # the host's cores shared out among the ranks (torchrun's concern: d
    # ranks of as many threads each oversubscribe the host)
    penv.setdefault("OMP_NUM_THREADS", str(max((os.cpu_count() or 1) // d, 1)))
    try:
        with node_agent.attach(stop):
            for l, renv in enumerate(envs):
                read, write = os.pipe()
                try:
                    p = subprocess.Popen(
                        [sys.executable, "-m", __name__, entrypoint, str(write)],
                        stdin=subprocess.PIPE, env=penv, pass_fds=(write,), text=True)
                finally:
                    os.close(write)
                procs.append(p)
                pod.pids.append(p.pid)
                threading.Thread(target=_read, args=(l, read, messages), daemon=True,
                                 name=f"pod-rank-{l}").start()
                # the signals already given, so a rank starts with them
                _send(p, json.dumps({"env": renv, "stop": _is_set(stop),
                                     "drain": bool(getattr(stop, "drain_requested", False))}))
            return _relay(pod, procs, messages, stop, t0)
    finally:
        _end(procs)
        pod.wall_s = time.perf_counter() - t0


def _relay(pod: PodRun, procs: List[subprocess.Popen], messages: "queue.Queue",
           stop: Optional[Any], t0: float) -> List[Dict[str, float]]:
    """The pod's process while its ranks run: stop and drain out to every
    rank, rank 0's progress in to the agent's sink, each rank's last
    message kept; a failure ends the loop at once."""
    d, ended, started = len(procs), set(), set()
    drain_sent = stop_sent = False
    stop_at: Optional[float] = None
    ready_at: Optional[float] = None  # every rank started or ended
    while len(ended) < d:
        if ready_at is None and len(started | ended) == d:
            ready_at = time.perf_counter()
        if stop is not None and not drain_sent and getattr(stop, "drain_requested", False):
            drain_sent = True
            for p in procs:
                _send(p, "drain")
        if stop is not None and not stop_sent and _is_set(stop):
            stop_sent, stop_at = True, time.perf_counter()
            for p in procs:
                _send(p, "stop")
        ready = ready_at if ready_at is not None else t0 + START_GRACE_S
        if stop_at is not None and time.perf_counter() - max(stop_at, ready) > STOP_GRACE_S:
            late = [l for l in range(d) if l not in ended]
            raise RankFailed(f"{pod.entrypoint}: ranks {late} did not stop within "
                             f"{STOP_GRACE_S:.0f} s", pod.first_rank + late[0], late[0])
        try:
            l, msg = messages.get(timeout=0.1)
        except queue.Empty:
            continue
        if msg is None:  # the rank's pipe closed: it has ended
            ended.add(l)
            if pod.records[l] is None:
                code = _wait(procs[l])
                pod.records[l] = {"error": f"exited with code {code} and sent no result",
                                  "at": time.time()}
        elif "started" in msg:
            started.add(l)
            continue
        elif "progress" in msg:
            progress.report(**msg["progress"])
            if pod.first_step_s is None and "first_step_seconds" in msg["progress"]:
                pod.first_step_s = time.perf_counter() - t0
            continue
        else:
            pod.records[l] = msg
        if pod.records[l] is not None and "error" in pod.records[l]:
            _fail(pod, messages)
    first = pod.records[0]
    drained = [r for r in pod.records if "drained" in r]
    if drained:
        raise node_agent.pod_drained_class(stop)(drained[0]["drained"])
    return first["result"]


def _fail(pod: PodRun, messages: "queue.Queue") -> None:
    """Raise for the rank that failed first: of the errors already sent,
    the one raised earliest (a peer's collective fails after the rank it
    waited on has gone)."""
    while True:
        try:
            l, msg = messages.get_nowait()
        except queue.Empty:
            break
        if msg is not None and "error" in msg:
            pod.records[l] = msg
    errs = [(r["at"], l) for l, r in enumerate(pod.records) if r is not None and "error" in r]
    _, l = min(errs)
    rec = pod.records[l]
    raise RankFailed(
        f"{pod.entrypoint}: rank {pod.first_rank + l} (local rank {l} of {pod.ranks}) "
        f"failed: {rec['error']}", pod.first_rank + l, l)


def _is_set(stop: Optional[Any]) -> bool:
    return stop is not None and getattr(stop, "is_set", lambda: False)()


def _send(p: subprocess.Popen, line: str) -> None:
    """A line to a rank's stdin; a rank that has ended takes none."""
    try:
        p.stdin.write(line + "\n")
        p.stdin.flush()
    except (OSError, ValueError):
        pass


def _read(l: int, fd: int, messages: "queue.Queue") -> None:
    """Rank ``l``'s JSON lines into ``messages``, then None when its pipe
    closes."""
    with os.fdopen(fd, "r") as f:
        for line in f:
            try:
                messages.put((l, json.loads(line)))
            except ValueError:
                log.warning("rank %d sent a malformed line: %r", l, line[:200])
    messages.put((l, None))


def _wait(p: subprocess.Popen) -> Optional[int]:
    try:
        return p.wait(timeout=TERM_GRACE_S)
    except subprocess.TimeoutExpired:
        return None


def _end(procs: List[subprocess.Popen]) -> None:
    """Every rank ended and joined: those still running are terminated,
    then killed after TERM_GRACE_S."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + TERM_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for p in procs:
        if p.stdin is not None and not p.stdin.closed:
            try:
                p.stdin.close()
            except OSError:
                pass


# -- in a rank process: the node agent's stand-in -----------------------------


PodDrained = node_agent.PodDrained
_CHANNEL: Optional[Any] = None
_CHANNEL_LOCK = threading.Lock()
_RELAY_PROGRESS = False


class RankStop(threading.Event):
    """A rank's stop signal: set on the pod's stop, with the drain notice
    as ``drain_requested``."""

    def __init__(self) -> None:
        super().__init__()
        self._drain = threading.Event()

    def request_drain(self) -> None:
        self._drain.set()

    @property
    def drain_requested(self) -> bool:
        return self._drain.is_set()


class _Progress:
    """The progress sink ``node_agent.find`` reads here: rank 0's reports
    go to the pod's process."""

    @staticmethod
    def report(**values: float) -> None:
        if _RELAY_PROGRESS:
            _emit({"progress": values})


_progress = _Progress()
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """A rank's spans go nowhere: the node agent's tracer is in the pod's
    process."""
    return _TRACER


def _emit(msg: Dict[str, Any]) -> None:
    with _CHANNEL_LOCK:
        if _CHANNEL is not None:
            _CHANNEL.write(json.dumps(msg, default=float) + "\n")
            _CHANNEL.flush()


def _listen(stop: RankStop) -> None:
    """The pod's commands on stdin. At its end the pod's process is gone.
    A rank told ``stop`` before that keeps its graceful end (the final
    save), and exits STOP_GRACE_S later if still running. A rank never
    told ``stop`` lost its node with the pod's process: it ends at once and
    writes nothing more, as the node's one process would have (a final
    save would commit a later step than the job's last one)."""
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "drain":
            stop.request_drain()
        elif cmd == "stop":
            stop.set()
    if not stop.is_set():
        os._exit(1)
    time.sleep(STOP_GRACE_S)
    os._exit(1)


def _resolve(entrypoint: str) -> Callable[..., Any]:
    module, _, attr = entrypoint.partition(":")
    obj: Any = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _stats(t0: float) -> Dict[str, Any]:
    """A rank's wall time, device, process group backend, peak device
    memory and kernel launches."""
    torch = sys.modules.get("torch")
    peak, device, backend = None, "cpu", None
    if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
        peak = int(torch.cuda.max_memory_allocated())
        device = f"cuda:{torch.cuda.current_device()}"
    if torch is not None and torch.distributed.is_available() and torch.distributed.is_initialized():
        backend = torch.distributed.get_backend()
    launches = {}
    for name in _KERNEL_MODULES:
        mod = sys.modules.get(f"tfk8s_tpu_torch.ops.{name}")
        if mod is not None:
            launches[name] = dict(mod.LAUNCHES)
    return {"wall_s": time.perf_counter() - t0, "device": device, "backend": backend,
            "peak_memory_bytes": peak, "launches": launches}


def child_main(argv: List[str]) -> int:
    """A rank: read its pod env from stdin's first line, run
    ``entrypoint(env, stop)`` and send its last message (the history, the
    drain or the error) on the pipe ``fd``."""
    global _CHANNEL, _RELAY_PROGRESS
    t0 = time.perf_counter()
    entrypoint, fd = argv[0], int(argv[1])
    _CHANNEL = os.fdopen(fd, "w")
    spec = json.loads(sys.stdin.readline())
    env = spec["env"]
    ctx = ProcessContext.from_env(env)
    _RELAY_PROGRESS = ctx.local_rank == 0
    logging.basicConfig(format=f"%(asctime)s rank {ctx.process_id} %(name)s "
                               "%(levelname)s: %(message)s")
    stop = RankStop()
    if spec["drain"]:
        stop.request_drain()
    if spec["stop"]:
        stop.set()
    threading.Thread(target=_listen, args=(stop,), daemon=True, name="pod-commands").start()
    code = 0
    try:
        fn = _resolve(entrypoint)
        _emit({"started": True})
        result = fn(env, stop)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.barrier()  # every rank done before any exits
        msg = {"result": result}
    except PodDrained as e:
        msg = {"drained": str(e)}
    except BaseException as e:  # noqa: BLE001 — every failure is the pod's to report
        msg = {"error": f"{type(e).__name__}: {e}", "at": time.time(),
               "traceback": traceback.format_exc()[-4000:]}
        code = 1
    try:
        _emit({**msg, **_stats(t0)})
        _CHANNEL.close()
    except OSError:
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: a process group's at a failed peer can hang
    os._exit(code)


if __name__ == "__main__":
    from tfk8s_tpu_torch.runtime import pod_ranks

    pod_ranks.child_main(sys.argv[1:])
