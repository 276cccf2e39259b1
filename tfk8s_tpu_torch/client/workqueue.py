"""Deduplicating, rate-limited work queue — SURVEY.md C16.

Implements the k8s workqueue contract the sample controller relies on
(``workqueue.NewNamedRateLimitingQueue(DefaultControllerRateLimiter(),...)``,
k8s-operator.md:87,108):

- **Dedup**: an item added while queued coalesces; an item added while
  *being processed* is marked dirty and requeued when ``done()`` is called —
  so one worker never processes the same key concurrently with another,
  which is the single-writer guarantee the whole reconcile design leans on
  (SURVEY.md §5 'Race detection').
- **Get/Done accounting** (k8s-operator.md:155,172): every ``get()`` must be
  paired with ``done()``.
- **Rate limiting**: ``add_rate_limited`` applies max(per-item exponential
  backoff, overall token bucket); ``forget`` resets an item's failure count.
- **Shutdown**: ``shut_down()`` drains waiters; ``get()`` returns
  ``(None, True)`` — the ``queue.ShutDown()`` path (k8s-operator.md:200-202).
- **Instrumentation** (the k8s workqueue MetricsProvider, optional): with
  a ``metrics`` registry the queue exports depth (gauge), time-in-queue
  (histogram, add→get per item), and requeues (counter), all labeled
  ``{queue="<name>"}`` — the three numbers that tell a saturated control
  plane apart from a slow one.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Hashable, List, Optional, Set, Tuple

from tfk8s_tpu_torch.client.ratelimit import MaxOfRateLimiter, default_controller_rate_limiter


class WorkQueue:
    """FIFO with dedup + processing accounting."""

    def __init__(self, name: str = "", metrics=None):
        self.name = name
        self._cond = threading.Condition()
        self._queue: List[Hashable] = []
        self._dirty: Set[Hashable] = set()
        self._processing: Set[Hashable] = set()
        self._shutting_down = False
        self._metrics = metrics
        self._labels = {"queue": name or "default"}
        # item -> monotonic add time (first add wins: a coalesced re-add
        # must not reset the clock — the waiting work is the old one's)
        self._added_at: dict = {}
        # item -> the queue latency its most recent get() observed, for
        # the controller's retroactive `dequeue` span
        self._last_latency: dict = {}
        if metrics is not None:
            metrics.describe(
                "workqueue.depth", "Items waiting in the work queue."
            )
            metrics.describe(
                "workqueue.queue_seconds",
                "Time an item waited in the queue before a worker took it.",
            )
            metrics.describe(
                "workqueue.requeues_total",
                "Items re-added while processing or via rate-limited retry.",
            )

    def _export_depth_locked(self) -> None:
        # call sites skip the call entirely when no registry is attached
        # (the hot add/get path must not pay even the no-op frame)
        self._metrics.set_gauge(
            "workqueue.depth", float(len(self._queue)), self._labels
        )

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            self._added_at.setdefault(item, time.monotonic())
            if item in self._processing:
                if self._metrics is not None:
                    self._metrics.inc("workqueue.requeues_total", 1.0, self._labels)
                return  # will requeue on done()
            self._queue.append(item)
            if self._metrics is not None:
                self._export_depth_locked()
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Tuple[Optional[Hashable], bool]:
        """Blocks for the next item. Returns ``(item, False)`` or
        ``(None, True)`` when shutting down (or ``(None, False)`` on
        timeout)."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutting_down:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None, False
                self._cond.wait(remaining)
            if not self._queue:
                return None, True  # shutting down and drained
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            added = self._added_at.pop(item, None)
            if added is not None:
                latency = time.monotonic() - added
                self._last_latency[item] = latency
                if self._metrics is not None:
                    self._metrics.observe(
                        "workqueue.queue_seconds", latency, self._labels
                    )
            if self._metrics is not None:
                self._export_depth_locked()
            return item, False

    def pop_queue_latency(self, item: Hashable) -> Optional[float]:
        """Seconds the item just dequeued spent waiting (consumed on
        read) — lets the caller attach the wait to its trace."""
        with self._cond:
            return self._last_latency.pop(item, None)

    def done(self, item: Hashable) -> None:
        with self._cond:
            # unconsumed latency is stale once processing ends — drop it
            # so the dict stays bounded by in-flight items
            self._last_latency.pop(item, None)
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._added_at.setdefault(item, time.monotonic())
                if self._metrics is not None:
                    self._export_depth_locked()
                self._cond.notify()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    def shut_down(self) -> None:
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._cond:
            return self._shutting_down


class DelayingQueue(WorkQueue):
    """WorkQueue + ``add_after``: a background timer thread moves items into
    the queue when their delay expires."""

    def __init__(self, name: str = "", metrics=None):
        super().__init__(name, metrics=metrics)
        self._heap: List[Tuple[float, int, Hashable]] = []
        self._seq = itertools.count()
        self._timer_cond = threading.Condition()
        self._timer = threading.Thread(target=self._timer_loop, daemon=True)
        self._timer.start()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._timer_cond:
            heapq.heappush(self._heap, (time.monotonic() + delay, next(self._seq), item))
            self._timer_cond.notify()

    def _timer_loop(self) -> None:
        while True:
            with self._timer_cond:
                while not self._heap:
                    self._timer_cond.wait(0.5)
                    if self.shutting_down and not self._heap:
                        return
                when, _, item = self._heap[0]
                now = time.monotonic()
                if when > now:
                    self._timer_cond.wait(when - now)
                    continue
                heapq.heappop(self._heap)
            self.add(item)


class RateLimitingQueue(DelayingQueue):
    """The ``NewNamedRateLimitingQueue`` analogue."""

    def __init__(
        self,
        name: str = "",
        rate_limiter: Optional[MaxOfRateLimiter] = None,
        metrics=None,
    ):
        super().__init__(name, metrics=metrics)
        self.rate_limiter = rate_limiter or default_controller_rate_limiter()

    def add_rate_limited(self, item: Hashable) -> None:
        if self._metrics is not None:
            self._metrics.inc("workqueue.requeues_total", 1.0, self._labels)
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self.rate_limiter.retries(item)
