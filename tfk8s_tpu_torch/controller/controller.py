"""Generic level-triggered controller core — SURVEY.md C15.

The exact machinery of the reference's sample controller
(k8s-operator.md:80-203), componentized:

- events enqueue **keys** (namespace/name) through
  ``DeletionHandlingMetaNamespaceKeyFunc`` (k8s-operator.md:132-139);
- an update filter skips no-op enqueues (the PodIP-diff pattern,
  k8s-operator.md:142-150);
- ``run(workers, stop)``: start informers, ``wait_for_cache_sync`` barrier,
  spawn N worker threads, block on stop, shut the queue down
  (k8s-operator.md:184-203);
- each worker: ``get -> lookup in cache -> sync -> done`` with rate-limited
  requeue on error and ``forget`` on success — the hot loop the system's
  latency hangs off (SURVEY.md §3.2).

Controllers supply ``sync(key)``; everything else is shared.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

from tfk8s_tpu_torch.client.informer import (
    ResourceEventHandler,
    SharedIndexInformer,
    deletion_handling_key,
    wait_for_cache_sync,
)
from tfk8s_tpu_torch.client.workqueue import RateLimitingQueue
from tfk8s_tpu_torch.obs.trace import Tracer, get_tracer
from tfk8s_tpu_torch.utils.logging import EventRecorder, Metrics, get_logger

log = get_logger("controller")

# Default reconcile workers. The workqueue's dirty/processing accounting
# already guarantees per-key in-flight exclusion (one worker per key at a
# time — the single-writer contract), so extra workers only add
# parallelism across DIFFERENT keys; 4 keeps a burst of job submissions
# from serializing behind one slow sync even on a 1-core box, where the
# win is overlapping the waits (status round trips, rate-limiter sleeps).
DEFAULT_SYNC_WORKERS = 4


class Controller:
    """Informer-fed, workqueue-decoupled reconcile loop."""

    def __init__(
        self,
        name: str,
        sync: Callable[[str], None],
        informers: Sequence[SharedIndexInformer] = (),
        max_retries: int = 15,
        recorder: Optional[EventRecorder] = None,
        metrics: Optional[Metrics] = None,
        kind: str = "",
        tracer: Optional[Tracer] = None,
    ):
        self.name = name
        self.kind = kind or name
        self.sync = sync
        self.informers = list(informers)
        self.max_retries = max_retries
        self.recorder = recorder or EventRecorder()
        self.metrics = metrics or Metrics()
        self.tracer = tracer or get_tracer()
        self.queue = RateLimitingQueue(name, metrics=self.metrics)
        self.metrics.describe(
            f"{name}.syncs_total", "Successful reconcile passes."
        )
        self.metrics.describe(
            f"{name}.sync_errors_total", "Reconcile passes that raised."
        )
        self.metrics.describe(
            f"{name}.sync_seconds", "Wall time of one reconcile pass."
        )
        self._workers: List[threading.Thread] = []
        self._stop_event: Optional[threading.Event] = None

    # -- enqueue paths (k8s-operator.md:132-150) ----------------------------

    def enqueue(self, obj) -> None:
        self.queue.add(deletion_handling_key(obj))

    def enqueue_key(self, key: str) -> None:
        self.queue.add(key)

    def enqueue_after(self, key: str, delay: float) -> None:
        self.queue.add_after(key, delay)

    def default_handler(
        self, update_filter: Optional[Callable[[object, object], bool]] = None
    ) -> ResourceEventHandler:
        """Standard add/update/delete -> enqueue wiring. ``update_filter``
        returns True when an update is worth reconciling (the old/new diff
        check of k8s-operator.md:142-150); default: resource_version
        changed."""

        def on_update(old, new):
            if update_filter is not None:
                if not update_filter(old, new):
                    return
            elif (
                old is not None
                and old.metadata.resource_version == new.metadata.resource_version
            ):
                return
            self.enqueue(new)

        return ResourceEventHandler(
            on_add=self.enqueue, on_update=on_update, on_delete=self.enqueue
        )

    # -- run loop (k8s-operator.md:184-203) ---------------------------------

    def run(
        self,
        workers: int = DEFAULT_SYNC_WORKERS,
        stop: Optional[threading.Event] = None,
        block: bool = True,
    ) -> bool:
        """Start informers, wait for cache sync, run N workers. With
        ``block=True`` this only returns after ``stop`` is set (the
        reference's ``Run`` never returns until stopCh closes). Workers
        never process the same key concurrently (queue dedup), so the
        count is safe to raise — see DEFAULT_SYNC_WORKERS. With ``stop``
        omitted an internal event is created; :meth:`shutdown` sets it,
        so the informer/worker threads remain stoppable."""
        if stop is None:
            stop = threading.Event()
        self._stop_event = stop
        log.info("%s: starting", self.name)
        for inf in self.informers:
            inf.run(stop)
        if not wait_for_cache_sync(stop, *self.informers):
            log.error("%s: cache sync failed", self.name)
            return False
        log.info("%s: caches synced; starting %d workers", self.name, workers)
        for i in range(workers):
            t = threading.Thread(
                target=self._worker, name=f"{self.name}-worker-{i}", daemon=True
            )
            t.start()
            self._workers.append(t)
        if block:
            stop.wait()
            self.shutdown()
        return True

    def shutdown(self) -> None:
        log.info("%s: shutting down queue", self.name)
        # release the informer reflector threads too — essential when
        # run() fabricated the stop event (no other handle exists)
        if self._stop_event is not None:
            self._stop_event.set()
        self.queue.shut_down()
        for t in self._workers:
            t.join(timeout=5)

    # -- the hot loop (k8s-operator.md:153-181) ------------------------------

    def _worker(self) -> None:
        while True:
            key, shutting_down = self.queue.get()
            if shutting_down:
                return
            if key is None:
                continue
            # time-in-queue, measured by the queue at dequeue — recorded
            # retroactively as the reconcile trace's first child so the
            # trace shows waiting separately from working
            qlat = self.queue.pop_queue_latency(key)
            t0 = time.perf_counter()
            with self.tracer.start_span(
                "reconcile",
                attributes={"controller": self.name, "key": str(key)},
            ) as span:
                if qlat is not None:
                    self.tracer.record_span(
                        "dequeue",
                        start=span.start_time - qlat,
                        end=span.start_time,
                        parent=span,
                        attributes={"queue": self.name},
                    )
                try:
                    self.sync(key)
                except Exception as e:  # noqa: BLE001 — one bad key must not kill the worker
                    span.set_status("error", f"{type(e).__name__}: {e}")
                    self.metrics.inc(f"{self.name}.sync_errors_total")
                    retries = self.queue.num_requeues(key)
                    if retries < self.max_retries:
                        log.warning(
                            "%s: sync %s failed (retry %d/%d): %s",
                            self.name, key, retries + 1, self.max_retries, e,
                        )
                        self.queue.add_rate_limited(key)
                    else:
                        log.error(
                            "%s: sync %s dropped after %d retries:\n%s",
                            self.name, key, retries, traceback.format_exc(),
                        )
                        self.recorder.event(
                            self.kind, key, "SyncDropped",
                            f"gave up after {retries} retries: {e}",
                        )
                        self.queue.forget(key)
                else:
                    self.metrics.inc(f"{self.name}.syncs_total")
                    self.queue.forget(key)
                finally:
                    self.metrics.observe(
                        f"{self.name}.sync_seconds", time.perf_counter() - t0
                    )
                    self.queue.done(key)
