"""LocalKubelet: executes pods in-process — the node agent of the hermetic
backend. A copy of the JAX package's ``runtime/kubelet.py``.

A port entry point that this kubelet runs needs no node agent
(``runtime/node_agent``): it reports into the port's own progress dict,
which this kubelet copies into ``pod.status.training``; it raises the
port's one ``PodDrained``, which this kubelet maps to the Drained phase;
and its spans land in the port's process tracer, continuing the
``kubelet.launch`` span. So this module does not offer the three names
``node_agent.find`` looks for (it imports progress as ``pod_progress``
and calls ``trace.get_tracer``), and ``find`` returns None for its stop
object.

In the reference's world the kubelet pulls the image and starts the
container, which is the control->data plane handoff (SURVEY.md §3.3,
'PROCESS+MACHINE BOUNDARY'). Here each pod's entrypoint runs on a thread:
the kubelet claims Pending pods from the watch, flips them to Running,
invokes the entrypoint with the pod's env (the ``TFK8S_*`` coordination
contract of ``trainer/replicas.py``),
and records Succeeded/Failed with the exit message — which flows back
through the watch into the controller's reconcile, closing the loop of
SURVEY.md §3.5.

One difference in behaviour: a pod recreated under the name of a pod
whose thread is still running (a gang restart, a preemption, a suspension:
the old incarnation drains and commits its last checkpoint) is claimed at
once but starts its entry point only when that thread has ended, so two
incarnations of one pod never share its card and its checkpoint directory,
and the successor restores the predecessor's final save. The reference's
kubelet starts it at once.

Failure injection for tests: an env of ``TFK8S_TEST_FAIL_TIMES=n`` makes a
pod raise on its first n attempts per pod name (counted in-process), which
exercises restart policies end-to-end.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
import traceback
from typing import Deque, Dict, List, Optional, Tuple

from tfk8s_tpu_torch.api.types import Pod, PodPhase
from tfk8s_tpu_torch.runtime.registry import PodDrained
from tfk8s_tpu_torch.client.clientset import Clientset
from tfk8s_tpu_torch.client.informer import ResourceEventHandler, SharedIndexInformer
from tfk8s_tpu_torch.client.store import Conflict, NotFound, Unavailable
from tfk8s_tpu_torch.obs import trace
from tfk8s_tpu_torch.obs.trace import TRACEPARENT_ENV
from tfk8s_tpu_torch.runtime import progress as pod_progress
from tfk8s_tpu_torch.runtime import registry
from tfk8s_tpu_torch.utils.logging import get_logger

log = get_logger("kubelet")

# `kubectl logs` parity: how many tail lines a pod's status carries, and
# how often the kubelet flushes a running pod's buffer into status.
LOG_TAIL_LIMIT = 200
LOG_FLUSH_SECONDS = 1.0

# Node heartbeat (the k8s node-lease mechanism): the kubelet renews a
# Lease named node-<name>; the controller marks a node's RUNNING pods
# Failed(NodeLost) once the lease goes stale — without this, a dead node
# agent strands its pods Running forever and the gang never recovers
# (SURVEY.md §3.5 failure path; slice loss must become job restart).
NODE_LEASE_PREFIX = "node-"
# Deployment-tunable (TFK8S_NODE_LEASE_*): the heartbeat thread shares
# the pod entrypoints' process (and GIL), so long compiles can stall
# renewal — the default staleness window (2x duration = 40s, the k8s
# node-lease timeout) must comfortably exceed any single trace. The
# node-failure test shrinks both to keep the suite fast. Env vars are
# read at LocalKubelet CONSTRUCTION, not import (r3 advisor finding:
# settings applied after first import were silently ignored).
NODE_LEASE_DURATION_DEFAULT_S = 20.0
NODE_LEASE_RENEW_DEFAULT_S = 4.0
# Reclaim notice (spot/preemptible capacity): the deadline-stamped pod
# annotation that warns a pod its host is about to be pulled — the
# hermetic analogue of the 30-second TPU reclaim notice. Writers (chaos
# harness, the job controller's resize drain, reclaim_node) PATCH the
# annotation through the apiserver; the kubelet's pod watch turns it into
# a soft drain signal on the entrypoint's PodStopSignal, ahead of any
# hard kill. Value: absolute epoch-seconds deadline.
RECLAIM_AT_ANNOTATION = "tfk8s.dev/reclaim-at"


def reclaim_patch(deadline: float) -> dict:
    """The merge-patch body that stamps a reclaim deadline on an object —
    the ONE place the annotation's wire format is written (kubelet,
    controller resize drain, chaos harness all patch through this)."""
    return {"metadata": {"annotations": {
        RECLAIM_AT_ANNOTATION: f"{deadline:.3f}"
    }}}


def parse_reclaim_at(obj) -> Optional[float]:
    """Deadline from an object's reclaim annotation, or None when absent
    or malformed — the ONE place the wire format is read."""
    raw = obj.metadata.annotations.get(RECLAIM_AT_ANNOTATION)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        log.warning(
            "malformed reclaim deadline %r on %s", raw, obj.metadata.key
        )
        return None

# How long a pod phase write keeps retrying through an apiserver outage.
# Sized to cover a full control-plane restart (journal replay + interpreter
# start, tens of seconds under load) with margin; teardown paths exit
# early via the kubelet stop event.
STATUS_WRITE_RETRY_S = 300.0


class PodStopSignal(threading.Event):
    """The per-pod stop handle the kubelet hands each entrypoint. The
    Event itself is the HARD stop (deletion / node death — SIGKILL
    equivalent); ``request_drain`` layers the SOFT reclaim phase on top
    (SIGTERM equivalent): entrypoints that check ``drain_requested`` get
    ``drain_deadline`` seconds to finish the in-flight step, commit a
    checkpoint, and raise :class:`~tfk8s_tpu_torch.runtime.node_agent.PodDrained`;
    entrypoints that only watch the Event keep the legacy semantics."""

    def __init__(self):
        super().__init__()
        self._drain = threading.Event()
        self.drain_deadline: Optional[float] = None

    def request_drain(self, deadline: float) -> None:
        # first notice wins: a re-delivered (or later) notice must not
        # push the deadline out from under a drain already in progress
        if not self._drain.is_set():
            self.drain_deadline = deadline
        self._drain.set()

    @property
    def drain_requested(self) -> bool:
        return self._drain.is_set()


class _PodLogRouter(logging.Handler):
    """Captures the ``tfk8s.*`` log records emitted by pod entrypoint
    threads into per-pod bounded buffers — the hermetic analogue of the
    container stdout a real node agent captures. Routing is by thread
    ident: each pod runs on its own kubelet thread, so a record's
    ``record.thread`` names its pod (child threads an entrypoint spawns
    are not captured — same as a container process writing to a file
    instead of stdout)."""

    def __init__(self):
        super().__init__()
        self.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s] %(message)s")
        )
        self._by_thread: Dict[int, Deque[str]] = {}
        self._route_lock = threading.Lock()

    def register(self, ident: int) -> Deque[str]:
        buf: Deque[str] = collections.deque(maxlen=LOG_TAIL_LIMIT)
        with self._route_lock:
            self._by_thread[ident] = buf
        return buf

    def unregister(self, ident: int) -> None:
        with self._route_lock:
            self._by_thread.pop(ident, None)

    def emit(self, record: logging.LogRecord) -> None:
        # append under the route lock: the flusher snapshots buffers with
        # list(buf), which raises 'deque mutated during iteration' if an
        # append lands mid-copy
        with self._route_lock:
            buf = self._by_thread.get(record.thread)
            if buf is not None:
                try:
                    buf.append(self.format(record))
                except Exception:  # noqa: BLE001 — logging must never raise
                    pass

    def snapshot(self, buf: Deque[str]) -> List[str]:
        with self._route_lock:
            return list(buf)


class LocalKubelet:
    """Watches pods and runs their entrypoints on daemon threads."""

    def __init__(
        self,
        clientset: Clientset,
        name: str = "local-kubelet",
        lease_duration_s: Optional[float] = None,
        lease_renew_s: Optional[float] = None,
    ):
        self.cs = clientset
        self.name = name
        self.lease_duration_s = (
            float(os.environ.get(
                "TFK8S_NODE_LEASE_DURATION_S", NODE_LEASE_DURATION_DEFAULT_S
            ))
            if lease_duration_s is None
            else lease_duration_s
        )
        self.lease_renew_s = (
            float(os.environ.get(
                "TFK8S_NODE_LEASE_RENEW_S", NODE_LEASE_RENEW_DEFAULT_S
            ))
            if lease_renew_s is None
            else lease_renew_s
        )
        self.informer = SharedIndexInformer(clientset.pods(namespace=None), name="kubelet-pod")
        self.informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._maybe_run,
                on_update=self._on_update,
                on_delete=self._on_delete,
            )
        )
        self._claimed: Dict[Tuple[str, str], PodStopSignal] = {}
        # (pod key, uid) -> the pod's thread, which a successor of the same
        # key waits for (_maybe_run)
        self._threads: Dict[Tuple[str, str], threading.Thread] = {}
        self._lock = threading.Lock()
        # chaos-harness hook (tests/chaos.py): (key, uid) -> failure
        # message. A poisoned pod's thread raises when its entrypoint
        # returns — the hermetic simulation of the host dying out from
        # under the process (dropped/late reclaim notice).
        self._chaos_fail: Dict[Tuple[str, str], str] = {}
        # Always a real Event (run() swaps in the caller's): every retry
        # wait in this file can be a stop-aware _stop.wait, so shutdown
        # never stalls behind a fixed sleep. _started gates the loops
        # that must not spin before run().
        self._stop: threading.Event = threading.Event()
        self._started = False
        self._fail_counts: Dict[str, int] = {}
        # (pod key, uid) -> live log buffer, drained by the flusher
        self._log_bufs: Dict[Tuple[str, str], Deque[str]] = {}
        # last tail actually published per pod — skips the per-cycle GET
        # for pods whose buffer hasn't changed
        self._log_published: Dict[Tuple[str, str], List[str]] = {}
        # (pod key, uid) -> entrypoint thread ident, for reading the
        # thread's training-progress report (runtime/progress.py)
        self._progress_idents: Dict[Tuple[str, str], int] = {}
        self._progress_published: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._log_router = _PodLogRouter()

    def run(self, stop: threading.Event) -> None:
        self._stop = stop
        self._started = True
        tfk8s_logger = logging.getLogger("tfk8s")
        tfk8s_logger.addHandler(self._log_router)
        # The node agent must see container INFO logs even when the
        # process never called init_logging (hermetic tests): an unset
        # level would inherit the root default (WARNING) and drop the
        # records before they reach any handler.
        if tfk8s_logger.getEffectiveLevel() > logging.INFO:
            tfk8s_logger.setLevel(logging.INFO)
        self.informer.run(stop)
        threading.Thread(
            target=self._flush_logs_loop, name=f"{self.name}-logflush", daemon=True
        ).start()
        threading.Thread(
            target=self._heartbeat_loop, name=f"{self.name}-heartbeat", daemon=True
        ).start()

    # -- node heartbeat -----------------------------------------------------

    def _heartbeat_loop(self) -> None:
        """Renew this node's Lease until stopped. Best-effort: apiserver
        flaps are logged and retried — the controller only acts once the
        lease is STALE, so transient failures inside the lease duration
        are invisible."""
        import time

        from tfk8s_tpu_torch.api.types import Lease, LeaseSpec, ObjectMeta
        from tfk8s_tpu_torch.client.store import StoreError

        leases = self.cs.generic("Lease", "default")
        name = NODE_LEASE_PREFIX + self.name
        while not self._stop.is_set():
            now = time.time()
            try:
                try:
                    lease = leases.get(name)
                    lease.spec.holder = self.name
                    lease.spec.lease_duration_s = self.lease_duration_s
                    lease.spec.renew_time = now
                    leases.update(lease)
                except NotFound:
                    leases.create(
                        Lease(
                            metadata=ObjectMeta(name=name, namespace="default"),
                            spec=LeaseSpec(
                                holder=self.name,
                                lease_duration_s=self.lease_duration_s,
                                acquire_time=now,
                                renew_time=now,
                            ),
                        )
                    )
            except (StoreError, OSError) as e:
                log.debug("%s: heartbeat failed: %s", self.name, e)
            self._stop.wait(self.lease_renew_s)

    # -- pod log plumbing ---------------------------------------------------

    def _flush_logs_loop(self) -> None:
        """Periodically publish running pods' captured log tails into pod
        status, so `logs` works mid-run (final flush rides the terminal
        _set_phase). Runs OUTSIDE the logging handler — a flush that
        itself logs (update conflicts) must not recurse into capture."""
        while not self._stop.is_set():
            try:
                with self._lock:
                    snapshot = {
                        k: self._log_router.snapshot(buf)
                        for k, buf in self._log_bufs.items()
                    }
                    idents = dict(self._progress_idents)
                for (key, uid), lines in snapshot.items():
                    training = (
                        pod_progress.snapshot(idents[(key, uid)])
                        if (key, uid) in idents
                        else {}
                    )
                    stale_logs = (
                        lines and self._log_published.get((key, uid)) != lines
                    )
                    stale_training = (
                        training
                        and self._progress_published.get((key, uid)) != training
                    )
                    if stale_logs or stale_training:
                        self._publish_status(key, uid, lines, training)
            except Exception:  # noqa: BLE001 — the flusher must survive
                log.debug("log flush cycle failed:\n%s", traceback.format_exc())
            self._stop.wait(LOG_FLUSH_SECONDS)
        logging.getLogger("tfk8s").removeHandler(self._log_router)

    def _publish_status(
        self, pod_key: str, uid: str, lines: List[str],
        training: Optional[Dict[str, float]] = None,
    ) -> bool:
        # the terminal _set_phase owns the FINAL tail: once the pod's
        # buffer is retired, a stale snapshot must not overwrite it
        with self._lock:
            if (pod_key, uid) not in self._log_bufs:
                return False
        ns, name = pod_key.split("/", 1)
        for _ in range(3):
            try:
                current = self.cs.pods(ns).get(name)
            except NotFound:
                return False
            if current.metadata.uid != uid:
                return False
            if current.status.phase in (
                PodPhase.SUCCEEDED, PodPhase.FAILED, PodPhase.DRAINED
            ):
                return False  # terminal writer already published
            if (
                current.status.log_tail == lines
                and (not training or current.status.training == training)
            ):
                self._log_published[(pod_key, uid)] = lines
                if training:
                    self._progress_published[(pod_key, uid)] = training
                return True  # nothing new since the last flush
            current.status.log_tail = lines
            if training:
                current.status.training = dict(training)
            try:
                self.cs.pods(ns).update_status(current)
                self._log_published[(pod_key, uid)] = lines
                if training:
                    self._progress_published[(pod_key, uid)] = training
                return True
            except Conflict:
                continue
            except NotFound:
                return False
        return False

    # -- pod lifecycle ------------------------------------------------------

    def _on_update(self, old: Pod, new: Pod) -> None:
        if new.metadata.deletion_timestamp is not None:
            self._signal_stop(new.metadata.key)
            return
        reclaim_at = parse_reclaim_at(new)
        if reclaim_at is not None:
            self._signal_drain(new.metadata.key, reclaim_at)
        self._maybe_run(new)

    def _on_delete(self, obj) -> None:
        # Deletion is how the controller stops a pod (gang restart,
        # teardown): signal the entrypoint's stop event so the old trainer
        # exits instead of running concurrently with its replacement.
        meta = getattr(obj, "obj", obj).metadata  # unwrap DeletedFinalStateUnknown
        self._signal_stop(meta.key)

    def _signal_stop(self, key: str) -> None:
        with self._lock:
            evs = [ev for (k, _uid), ev in self._claimed.items() if k == key]
        for ev in evs:
            ev.set()

    def _signal_drain(self, key: str, deadline: float) -> None:
        with self._lock:
            evs = [ev for (k, _uid), ev in self._claimed.items() if k == key]
        for ev in evs:
            ev.request_drain(deadline)

    # -- reclaim / chaos hooks ---------------------------------------------

    def deliver_reclaim(self, pod_key: str, grace_s: float) -> float:
        """Deliver a reclaim notice to one pod: stamp the deadline
        annotation through the apiserver (so every watcher — controller
        included — sees the notice) AND signal the local drain event
        directly, so the grace clock starts now rather than a watch
        round-trip later. Returns the deadline."""
        deadline = time.time() + grace_s
        ns, name = pod_key.split("/", 1)
        try:
            self.cs.pods(ns).patch(name, reclaim_patch(deadline))
        except (NotFound, Conflict, Unavailable, OSError) as e:
            log.warning("%s: reclaim annotation for %s failed: %s",
                        self.name, pod_key, e)
        self._signal_drain(pod_key, deadline)
        return deadline

    def reclaim_node(self, grace_s: float) -> List[str]:
        """Node-level reclaim notice (the v5p 30-second pull): mark THIS
        node's Lease with the reclaim deadline — the ReclaimNotice node
        condition any controller can observe — and drain every pod the
        node is running. Returns the notified pod keys."""
        deadline = time.time() + grace_s
        try:
            leases = self.cs.generic("Lease", "default")
            lease = leases.get(NODE_LEASE_PREFIX + self.name)
            lease.metadata.annotations.update(
                reclaim_patch(deadline)["metadata"]["annotations"]
            )
            leases.update(lease)
        except Exception as e:  # noqa: BLE001 — notice delivery is best-effort
            log.warning("%s: node reclaim condition failed: %s", self.name, e)
        with self._lock:
            keys = sorted({k for (k, _uid) in self._claimed})
        for key in keys:
            self.deliver_reclaim(key, grace_s)
        return keys

    def chaos_fail(self, pod_key: str, message: str = "chaos: node died") -> None:
        """Chaos-harness hook: kill a pod's host WITHOUT (or after) a
        notice — the entrypoint is hard-stopped and its exit is recorded
        as FAILED with ``message``, even if it was mid-drain. This is how
        tests/chaos.py simulates a dropped or late reclaim notice."""
        with self._lock:
            targets = [
                (claim, ev) for claim, ev in self._claimed.items()
                if claim[0] == pod_key
            ]
            for claim, _ev in targets:
                self._chaos_fail[claim] = message
        for _claim, ev in targets:
            ev.set()

    def _maybe_run(self, pod: Pod) -> None:
        if pod.status.phase != PodPhase.PENDING:
            return
        # Claims are keyed by (key, uid): a recreated pod reuses its name but
        # gets a fresh uid, so it is a new claim even if the old thread is
        # still draining. Its thread waits for the old ones to end before it
        # starts the entry point: both would hold the pod's card and write
        # its checkpoint directory, and the successor's restore would race
        # the predecessor's final save.
        claim = (pod.metadata.key, pod.metadata.uid)
        reclaim_at = parse_reclaim_at(pod)
        with self._lock:
            if claim in self._claimed:
                return
            before = [t for (k, _uid), t in self._threads.items() if k == claim[0]]
            pod_stop = PodStopSignal()
            if reclaim_at is not None:
                pod_stop.request_drain(reclaim_at)
            self._claimed[claim] = pod_stop
            # started under the lock: a successor never finds it unstarted
            t = threading.Thread(
                target=self._run_pod, args=(pod, pod_stop, before),
                name=f"pod-{pod.metadata.name}", daemon=True,
            )
            self._threads[claim] = t
            t.start()

    def _set_phase(
        self, pod_key: str, uid: str, phase: PodPhase, message: str = "",
        exit_code=None, log_tail: Optional[List[str]] = None,
        training: Optional[Dict[str, float]] = None,
    ) -> bool:
        """Phase writes must survive a transient apiserver outage: a
        SUCCEEDED/FAILED result dropped on the floor leaves the pod Running
        forever in a journal-restored store (no later event corrects it).
        Unavailable (connection refused/reset, 5xx) retries with backoff
        until the kubelet stops or the outage outlasts
        ``STATUS_WRITE_RETRY_S``; permanent errors (401/403/422) fail fast
        — they will never succeed by waiting. Conflict retries are folded
        into the same loop (each iteration re-reads)."""
        ns, name = pod_key.split("/", 1)
        deadline = time.monotonic() + STATUS_WRITE_RETRY_S
        conflicts = 0
        while True:
            try:
                current = self.cs.pods(ns).get(name)
                if current.metadata.uid != uid:
                    return False  # a successor pod took this name; not ours
                current.status.phase = phase
                current.status.message = message
                current.status.exit_code = exit_code
                current.status.host = self.name
                if log_tail is not None:
                    current.status.log_tail = log_tail
                if training:
                    current.status.training = dict(training)
                self.cs.pods(ns).update_status(current)
                return True
            except NotFound:
                return False
            except Conflict:
                # Bounded by the SAME deadline as outages, not a fixed
                # count: each iteration re-reads and can succeed, so 409s
                # accumulated across a long outage must never abort a
                # terminal SUCCEEDED/FAILED write (ADVICE r5 — the exact
                # dropped-outcome this loop exists to prevent). The brief
                # pause keeps a racing writer from turning this into a
                # hot re-read loop.
                conflicts += 1
                if time.monotonic() > deadline:
                    log.warning(
                        "%s: giving up updating %s to %s (%d conflicts, "
                        "deadline exceeded)",
                        self.name, pod_key, phase, conflicts,
                    )
                    return False
                # real sleep, NOT _stop.wait: conflicts are retried even
                # during shutdown (the final phases are the point of
                # stopping gracefully), and wait() on a set event returns
                # immediately — which would turn this into the hot
                # re-read loop the pause exists to prevent
                time.sleep(0.05)
                continue
            except (Unavailable, OSError) as e:
                stopping = self._stop.is_set()
                if stopping or time.monotonic() > deadline:
                    log.warning(
                        "%s: dropping %s -> %s (%s; %s)", self.name, pod_key,
                        phase, e, "stopping" if stopping else "outage too long",
                    )
                    return False
                log.info(
                    "%s: apiserver unreachable writing %s -> %s; retrying: %s",
                    self.name, pod_key, phase, e,
                )
                # stop-aware retry wait: a kubelet shutting down mid-
                # outage must not stall a second per pending retry (the
                # next loop iteration sees the stop and drops cleanly)
                self._stop.wait(1.0)

    def _run_pod(
        self, pod: Pod, pod_stop: threading.Event, before: List[threading.Thread],
    ) -> None:
        key, uid = pod.metadata.key, pod.metadata.uid
        for predecessor in before:
            predecessor.join()
        ident = threading.get_ident()
        buf = self._log_router.register(ident)
        # Thread idents are REUSED by the OS: a progress slot leaked by a
        # previous occupant of this ident (e.g. a direct run_task outside
        # any kubelet) must not surface as THIS pod's training progress
        # until its first real report.
        pod_progress.clear(ident)
        with self._lock:
            self._log_bufs[(key, uid)] = buf
            self._progress_idents[(key, uid)] = ident
        # Continue the trace the creating controller sync stamped into the
        # pod env (obs/trace.py): the launch span is the bridge between
        # the reconcile spans and the trainer's spans. The env copy is
        # shared with the entrypoint call; a malformed spec (no
        # containers) leaves it empty here and fails inside the span,
        # where the ordinary FAILED path records it.
        try:
            env = dict(pod.spec.containers[0].env)
        except Exception:  # noqa: BLE001
            env = {}
        span = trace.get_tracer().start_span(
            "kubelet.launch",
            traceparent=env.get(TRACEPARENT_ENV),
            attributes={"pod": key, "node": self.name},
        )
        try:
            with span:
                container = pod.spec.containers[0]
                # test-only failure injection
                fail_times = int(env.get("TFK8S_TEST_FAIL_TIMES", "0"))
                if not self._set_phase(key, uid, PodPhase.RUNNING):
                    return
                if fail_times:
                    with self._lock:
                        n = self._fail_counts.get(pod.metadata.name, 0)
                        self._fail_counts[pod.metadata.name] = n + 1
                    if n < fail_times:
                        raise RuntimeError(
                            f"injected failure {n + 1}/{fail_times}"
                        )
                fn = registry.resolve(container.entrypoint)
                try:
                    registry.call(fn, env, pod_stop)
                    phase, message, code = PodPhase.SUCCEEDED, "", 0
                except PodDrained as e:
                    # the entrypoint honored the reclaim notice: in-flight
                    # step finished, drain checkpoint committed — a
                    # GRACEFUL terminal phase, not a failure
                    phase, message, code = PodPhase.DRAINED, str(e), 0
                # chaos poison outranks the entrypoint's own exit: the
                # "host" died, so even a drained result never made it out
                poison = self._chaos_fail.pop((key, uid), None)
                if poison is not None:
                    raise RuntimeError(poison)
                # the terminal write carries the FINAL progress report too
                # — the 1s flusher usually misses the report fired right
                # before the entrypoint returns (the step==steps boundary)
                self._set_phase(
                    key, uid, phase, message=message, exit_code=code,
                    log_tail=list(buf), training=pod_progress.snapshot(ident),
                )
        except Exception as e:  # noqa: BLE001 — container or kubelet failure
            log.info("%s: pod %s failed: %s", self.name, key, e)
            try:
                self._set_phase(
                    key, uid, PodPhase.FAILED,
                    message=f"{type(e).__name__}: {e}", exit_code=1,
                    log_tail=list(buf), training=pod_progress.snapshot(ident),
                )
            except Exception:  # noqa: BLE001 — apiserver gone (teardown)
                log.debug("%s: terminal status write for %s failed:\n%s",
                          self.name, key, traceback.format_exc())
            log.debug("%s", traceback.format_exc())
        finally:
            self._log_router.unregister(ident)
            pod_progress.clear(ident)
            with self._lock:
                self._claimed.pop((key, uid), None)
                self._threads.pop((key, uid), None)
                self._chaos_fail.pop((key, uid), None)
                self._log_bufs.pop((key, uid), None)
                self._log_published.pop((key, uid), None)
                self._progress_idents.pop((key, uid), None)
                self._progress_published.pop((key, uid), None)
